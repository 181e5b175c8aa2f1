// Flash-attention forward (prefill / full-sequence scoring) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py:74 (flash_attention, its
// pallas_call at :95) together with its GQA op wrapper
// (src/repro/kernels/flash_attention/ops.py):
//
//   out[b, i, h, :] = sum_j softmax_j(q[b, i, h] . k[b, j, h / rep] * scale) v[b, j, h / rep]
//
// over the keys j visible from query i (all j < Skv, or j <= i when causal:
// the mask is top-left aligned, query i sits at position i), with an f32
// online softmax and the output in q's dtype.  q is (B, Sq, H, D), k and v
// are (B, Skv, KVH, D) and read in place: query head h reads kv head
// h / rep, so the reference wrapper's repeat of K/V over the group and its
// transposes to (BH, S, D) never happen.
//
// What bounds it: at prefill (Sq = Skv = S in the hundreds to thousands) it
// does 4 S^2 D / 2 flops per (b, h) (causal) on 4 S D elements, far above
// the card's ~295 flop/byte ridge, so it is bound by the tensor cores' rate.
// The first version (mma.sync m16n8k16, 64-row CTAs of 4 warps that
// each both copied with cp.async and computed, a block barrier per key tile,
// K fragments from scalar shared loads, the mask on every tile, expf) read
// 0.5045 ms at B 8, H 32, KVH 8, D 128, S 1024, causal: 136 TFLOP/s, 7.3x
// its bound and 3.3x slower than SDPA (NVIDIA H100 80GB HBM3, 700 W).
// mma.sync cannot reach the card's rate; only wgmma can.
//
// The bf16 kernel for D 64 and 128 (flash_fwd_wgmma) is built the way the
// card wants:
//   * persistent: one CTA an SM walks work items longest first (the last
//     query block of every (kv head, batch row) first).  An item is 128 Q
//     rows, GQA-packed: the rep query heads of kv head g at 128 / rep
//     positions, so kv head g = h / rep is read in place and each K/V tile
//     loaded serves every head of its group;
//   * three warpgroups: two consumers of 64 Q rows each, and a producer
//     whose one thread issues every copy.  setmaxnreg moves registers from
//     the producer (24) to the consumers (240), which hold the score tile,
//     the output accumulator, P and the softmax state;
//   * the producer loads Q with TMA once an item (as soon as the last
//     item's final Q K^T is done) and K/V tiles of kBN keys (96 at D 128,
//     128 at D 64) into a ring of 4 stages of 128-byte-swizzled shared
//     memory, with an mbarrier pair per stage (K and V full, one empty).
//     The tensor maps are 4-D views of the (B, S, heads, D) tensors,
//     encoded per call (launch_wgmma); positions past Sq or Skv come in as
//     zeros without touching the next batch row.  So the next item's loads overlap this
//     item's last tiles and its output stores;
//   * S = Q K^T is wgmma.m64nBNk16 with both operands in shared memory
//     (K-major), bf16 -> f32.  P is rounded to bf16 in registers (the
//     accumulator layout is already the register A layout) and O += P V is
//     wgmma with A from registers and V as an MN-major B from shared memory.
//     The row sums l use the f32 P;
//   * the two consumer warpgroups take turns on the tensor cores (named
//     barriers): a turn issues Q K^T of tile j and P V of tile j-1, and one
//     warpgroup's softmax runs while the other's products do;
//   * the online softmax is in f32 with ex2.approx, scale * log2(e) folded
//     into one FMA; the causal / ragged mask is computed only on tiles that
//     straddle the diagonal or the Skv edge, and key tiles wholly above the
//     diagonal are never loaded.
// A consumer waits on its tiles' barriers, so there is no block barrier in
// the loop.  A wait that does not finish within ~2 s traps (a launch error)
// instead of hanging the card.
//
// What still holds it back (builds of this source with parts taken out,
// timed on an H100 at B 8, S 1024, not causal): the products alone run at
// about the card's peak, but the softmax alone (the exp, the max and sum
// reductions and the rescale of O, on 8 warps an SM) and the copies alone
// (every item loads its kv head's whole K/V range from L2) each take
// longer, and they overlap only in part: ptxas places the P.V wait ahead
// of the softmax (WARPGROUP.DEPBAR 0x0 right after 0x1 in the SASS), so a
// warpgroup's softmax never overlaps its own P.V, only the other
// warpgroup's products.
//
// D 32 in bf16 (and more than 128 query heads per kv head, more than an
// item holds) keeps the first version's mma.sync kernel (flash_fwd_bf16),
// and f32 inputs (the parity checks run the model in f32) keep its full-f32
// CUDA-core kernel (flash_fwd_f32), so the card-vs-CPU stream checks are
// undisturbed.  The host picks the variant by dtype, head dim and GQA ratio
// before the launch (kernel.py: variant()).  Ragged Sq and Skv are masked: query rows
// past Sq are not written; keys past Skv score NEG_INF.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bf16, D 64 / 128: warp-specialised wgmma + TMA
// ---------------------------------------------------------------------------

namespace wg {

constexpr int kBM = 128;           // query rows per CTA (two consumer warpgroups)
constexpr int kThreads = 384;      // consumers: warpgroups 0 and 1; producer: 2
constexpr int kStages = 4;         // K/V ring depth
// 384 x 168 registers at launch; the producer gives back all but 24, the
// consumers take 240: S, O and the previous tile's P at once
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

template <int D>
struct Cfg {
  static constexpr int kBN = D == 64 ? 128 : 96;    // keys per K/V tile
  static constexpr int kHalves = D / 64;             // 128-byte column blocks
  static constexpr int kQBytes = kBM * D * 2;
  static constexpr int kKVBytes = kBN * D * 2;       // one K or V tile
  static constexpr int kKOff = kQBytes;              // every tile 1024-aligned
  static constexpr int kVOff = kKOff + kStages * kKVBytes;
  static constexpr int kBarOff = kVOff + kStages * kKVBytes;
  static constexpr int kBars = 2 + 3 * kStages;      // q full, q empty; k full, v full, empty
  static constexpr int kSmem = kBarOff + 8 * kBars + 1024;   // + alignment slack
  static_assert(kSmem <= 232448, "shared memory of one CTA");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
// wait until the barrier's phase with this parity has completed; trap (a
// launch error the wrapper raises) rather than hang if it never does
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > (1ll << 32)) __trap();
  }
}

// one box of a 4-D tensor map into shared memory, completing on ``bar``
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 = B128
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// named barriers over the two consumer warpgroups (id 0 is __syncthreads)
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from touching accumulator registers across the
// asynchronous wgmma (CUTLASS's warpgroup_fence_operand)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x in one MUFU op (relative error ~2^-22; 0 for x below -126)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// D (64 x 96, f32) = A (64 x 16, smem, K-major) . B (16 x 96, smem, K-major)
// (+ D when accumulate != 0)
__device__ __forceinline__ void wgmma_ss_n96(float (&d)[48], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 128, f32) = A (64 x 16, smem, K-major) . B (16 x 128, smem, K-major)
// (+ D when accumulate != 0)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
      "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, f32) = A (64 x 16, registers) . B (16 x 64, smem, MN-major)
// (+ D when accumulate != 0)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D (64 x 128, f32) = A (64 x 16, registers) . B (16 x 128, smem, MN-major)
// (+ D when accumulate != 0)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
      "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_s(float (&d)[N / 2], uint64_t da, uint64_t db,
                                        int accumulate) {
  if constexpr (N == 128) wgmma_ss_n128(d, da, db, accumulate);
  else wgmma_ss_n96(d, da, db, accumulate);
}
template <int N>
__device__ __forceinline__ void wgmma_o(float (&d)[N / 2], const uint32_t (&a)[4],
                                        uint64_t db) {
  if constexpr (N == 128) wgmma_rs_n128(d, a, db, 1);
  else wgmma_rs_n64(d, a, db, 1);
}

// the keys a CTA's query positions [p0, p0 + n_pos) can see: [0, kv_end)
__device__ __forceinline__ int kv_end_of(int p0, int n_pos, int Sq, int Skv, int causal) {
  if (!causal) return Skv;
  return min(Skv, min(Sq, p0 + n_pos));
}

// S = Q K^T over one K tile: D/16 k-steps, 32 bytes apart inside a
// 128-byte column block (both operands K-major), committed as one group.
// dq, dk: descriptors of the warpgroup's Q rows and of the K tile (the
// start address field counts 16-byte units)
template <int D, int kBN>
__device__ __forceinline__ void qk_tile(float (&sc)[kBN / 2], uint64_t dq, uint64_t dk) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t koff = (kk & 3) * 2;
    wgmma_s<kBN>(sc, dq + (kk >> 2) * (kBM * 8) + koff, dk + (kk >> 2) * (kBN * 8) + koff,
                 kk > 0);
  }
  wgmma_commit();
}

// O += P V over one V tile, P from registers: V is MN-major (head dims
// contiguous), dv its descriptor; a k-step is 16 key rows = 2048 bytes
template <int D, int kBN>
__device__ __forceinline__ void pv_tile(float (&o)[D / 2], const uint32_t (&pa)[kBN / 16][4],
                                        uint64_t dv) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) wgmma_o<D>(o, pa[kk], dv + kk * 128);
  wgmma_commit();
}

// O *= corr per row
template <int D>
__device__ __forceinline__ void rescale_o(float (&o)[D / 2], const float (&corr)[2]) {
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) {
    o[nb * 4 + 0] *= corr[0];
    o[nb * 4 + 1] *= corr[0];
    o[nb * 4 + 2] *= corr[1];
    o[nb * 4 + 3] *= corr[1];
  }
}

// P (f32, in sc) to bf16: key blocks 2kk, 2kk+1 of the accumulator are the
// register A fragment of k-step kk
template <int kBN>
__device__ __forceinline__ void pack_p(const float (&sc)[kBN / 2], uint32_t (&pa)[kBN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    pa[kk][0] = pack_bf16x2(sc[8 * kk + 0], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16x2(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16x2(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16x2(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// Tile j's scores (this thread's part of its two rows, at query positions
// pos[0] and pos[1], keys n0 + 8 nb + 2 quad + {0, 1}) into P, in place,
// with the online-softmax state: p = 2^(s * scale * log2 e - m) over the
// log2-domain running max m, l the running row sums in f32, corr the factor
// the output must be scaled by.  The mask is applied only where the tile
// straddles the diagonal (for this warpgroup's first position wg_pos0) or
// the Skv edge.
template <int kBN>
__device__ __forceinline__ void softmax_tile(float (&sc)[kBN / 2], float (&m_r)[2],
                                             float (&l_r)[2], float (&corr)[2], int n0,
                                             const int (&pos)[2], int wg_pos0, int quad,
                                             int Skv, int causal, float scale_log2) {
  if (n0 + kBN > Skv || (causal && n0 + kBN - 1 > wg_pos0)) {
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      const int row = pos[(i >> 1) & 1];
      const int col = n0 + (i >> 2) * 8 + 2 * quad + (i & 1);
      const bool ok = col < Skv && (!causal || col <= row);
      sc[i] = ok ? sc[i] : kNegInf;
    }
  }
  // four independent partial maxima and sums per row: the chains of
  // dependent adds are a quarter as long (two warps a scheduler cannot
  // hide them)
  float mx[2][4], sum[2][4];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      mx[hh][u] = kNegInf;
      sum[hh][u] = 0.f;
    }
#pragma unroll
  for (int nb = 0; nb < kBN / 8; ++nb)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      mx[hh][nb & 3] =
          fmaxf(mx[hh][nb & 3], fmaxf(sc[nb * 4 + 2 * hh], sc[nb * 4 + 2 * hh + 1]));
  float neg_m[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float m = fmaxf(fmaxf(mx[hh][0], mx[hh][1]), fmaxf(mx[hh][2], mx[hh][3]));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    const float m_new = fmaxf(m_r[hh], m * scale_log2);
    corr[hh] = fast_exp2(m_r[hh] - m_new);
    m_r[hh] = m_new;
    neg_m[hh] = -m_new;
  }
#pragma unroll
  for (int nb = 0; nb < kBN / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float& x = sc[nb * 4 + e];
      x = fast_exp2(fmaf(x, scale_log2, neg_m[e >> 1]));
      sum[e >> 1][nb & 3] += x;
    }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float t = (sum[hh][0] + sum[hh][1]) + (sum[hh][2] + sum[hh][3]);
    t += __shfl_xor_sync(0xffffffffu, t, 1);
    t += __shfl_xor_sync(0xffffffffu, t, 2);
    l_r[hh] = l_r[hh] * corr[hh] + t;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap map_q,   // (B, Sq, H, D)
                const __grid_constant__ CUtensorMap map_k,   // (B, Skv, KVH, D)
                const __grid_constant__ CUtensorMap map_v,   // (B, Skv, KVH, D)
                __nv_bfloat16* __restrict__ out,              // (B, Sq, H, D)
                int B, int Sq, int Skv, int H, int KVH, int causal, float scale_log2) {
  // Persistent: CTA c walks work items c, c + gridDim.x, ... of the list
  // ordered longest first (the last query block first).  An item is
  // GQA-packed: all rep query heads of kv head g at n_pos positions; Q row
  // r is position p0 + r / rep, head g * rep + r % rep.
  using C = Cfg<D>;
  constexpr int kBN = C::kBN;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = base + C::kKOff;
  const uint32_t v_s = base + C::kVOff;
  const uint32_t bars = base + C::kBarOff;
  const uint32_t q_full = bars;
  const uint32_t q_empty = bars + 8u;
  auto k_full = [&](int s) { return bars + 8u * (2 + s); };
  auto v_full = [&](int s) { return bars + 8u * (2 + kStages + s); };
  auto empty = [&](int s) { return bars + 8u * (2 + 2 * kStages + s); };

  const int rep = H / KVH;
  const int n_pos = kBM / rep;                          // positions per item
  const int n_rows = n_pos * rep;                       // <= kBM Q rows
  const int n_blocks = (Sq + n_pos - 1) / n_pos;
  const int n_items = n_blocks * KVH * B;
  // item w: query block n_blocks - 1 - w / (KVH B), kv head, batch row
  struct Item { int p0, g, b, n_tiles; };
  auto item_of = [&](int w) {
    Item it;
    const int rem = w % (KVH * B);
    it.p0 = (n_blocks - 1 - w / (KVH * B)) * n_pos;
    it.g = rem % KVH;
    it.b = rem / KVH;
    it.n_tiles = (kv_end_of(it.p0, n_pos, Sq, Skv, causal) + kBN - 1) / kBN;
    return it;
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 2 * 128);         // every consumer thread releases Q
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 2 * 128);      // and every K/V stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warp-uniform in ptxas' eyes (as CUTLASS does it), so that branches on
  // it and on values derived from it are uniform and do not stall wgmma
  const int wgi = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wgi == 2) {
    // ---------------- producer: one thread issues every TMA copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 256) {
      int t = 0;                         // K/V tiles issued so far: the ring position
      int n = 0;                         // items so far
      for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++n) {
        const Item it = item_of(w);
        if (n > 0) mbar_wait(q_empty, (n - 1) & 1);   // the last item's QK^T is done
        mbar_expect_tx(q_full, n_rows * D * 2);
#pragma unroll
        for (int c = 0; c < C::kHalves; ++c)
          tma_load_4d(q_s + c * (kBM * 128), &map_q, q_full, c * 64, it.g * rep, it.p0,
                      it.b);
        for (int j = 0; j < it.n_tiles; ++j, ++t) {
          const int s = t % kStages;
          mbar_wait(empty(s), ((t / kStages) & 1) ^ 1);   // round 0 passes
          mbar_expect_tx(k_full(s), C::kKVBytes);
#pragma unroll
          for (int c = 0; c < C::kHalves; ++c)
            tma_load_4d(k_s + s * C::kKVBytes + c * (kBN * 128), &map_k, k_full(s),
                        c * 64, it.g, j * kBN, it.b);
          mbar_expect_tx(v_full(s), C::kKVBytes);
#pragma unroll
          for (int c = 0; c < C::kHalves; ++c)
            tma_load_4d(v_s + s * C::kKVBytes + c * (kBN * 128), &map_v, v_full(s),
                        c * 64, it.g, j * kBN, it.b);
        }
      }
    }
  } else {
    // ---------------- consumers: 64 Q rows per warpgroup
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int tid = threadIdx.x % 128;
    const int lane = tid & 31;
    const int quad = lane & 3;
    const int row_lo = wgi * 64 + (tid >> 5) * 16 + (lane >> 2);   // and row_lo + 8
    // this warpgroup's 64 rows of Q: 64 x 128 bytes into each column block
    const uint64_t dq = desc_sw128(q_s + wgi * 64 * 128, 16, 1024);
    // V is MN-major: the next 64 head dims are kBN * 128 bytes on (LBO)
    auto desc_v = [&](int st) { return desc_sw128(v_s + st * C::kKVBytes, kBN * 128, 1024); };
    // The two warpgroups take turns on the tensor cores (named barriers 1
    // and 2): a turn issues QK^T of tile j and P.V of tile j-1; while one
    // warpgroup's products run the other does its softmax.  Warpgroup 0
    // goes first in every item; every turn of one is matched by an arrive
    // of the other.  The first and last turns are peeled so that no wgmma
    // sits under a branch (ptxas would serialise).
    const int my_bar = 1 + wgi;
    const int other_bar = 2 - wgi;
    float o[D / 2];
    float sc[kBN / 2];
    uint32_t pa[kBN / 16][4];          // P of the previous tile, bf16
    float m_r[2], l_r[2], corr[2];

    int t = 0;                           // K/V tiles consumed so far
    int n = 0;
    for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++n) {
      const Item it = item_of(w);
      const int pos[2] = {it.p0 + row_lo / rep, it.p0 + (row_lo + 8) / rep};
      const int wg_pos0 = it.p0 + wgi * 64 / rep;
      const int last = it.n_tiles - 1;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      m_r[0] = m_r[1] = kNegInf;
      l_r[0] = l_r[1] = 0.f;

      if (wgi == 1) named_arrive(1);
      mbar_wait(q_full, n & 1);
      mbar_wait(k_full(t % kStages), (t / kStages) & 1);
      named_sync(my_bar);                // turn 0: QK^T of tile 0
      wgmma_fence();
      qk_tile<D, kBN>(sc, dq, desc_sw128(k_s + (t % kStages) * C::kKVBytes, 16, 1024));
      named_arrive(other_bar);
      wgmma_wait<0>();
      fence_regs(sc);
      if (last == 0) mbar_arrive(q_empty);
      softmax_tile<kBN>(sc, m_r, l_r, corr, 0, pos, wg_pos0, quad, Skv, causal, scale_log2);
      pack_p<kBN>(sc, pa);               // O is still zero: nothing to rescale
      for (int j = 1; j <= last; ++j) {  // turn j: QK^T of j, P.V of j - 1
        const int s = (t + j) % kStages;
        const int sp = (t + j - 1) % kStages;
        mbar_wait(k_full(s), ((t + j) / kStages) & 1);
        mbar_wait(v_full(sp), ((t + j - 1) / kStages) & 1);
        named_sync(my_bar);
        fence_regs(o);
        wgmma_fence();
        qk_tile<D, kBN>(sc, dq, desc_sw128(k_s + s * C::kKVBytes, 16, 1024));
        pv_tile<D, kBN>(o, pa, desc_v(sp));
        named_arrive(other_bar);
        wgmma_wait<1>();                 // S of tile j
        fence_regs(sc);
        if (j == last) mbar_arrive(q_empty);
        softmax_tile<kBN>(sc, m_r, l_r, corr, j * kBN, pos, wg_pos0, quad, Skv, causal,
                          scale_log2);
        wgmma_wait<0>();                 // P.V of tile j - 1
        fence_regs(o);
        mbar_arrive(empty(sp));
        rescale_o<D>(o, corr);
        pack_p<kBN>(sc, pa);
      }
      const int sl = (t + last) % kStages;
      mbar_wait(v_full(sl), ((t + last) / kStages) & 1);
      named_sync(my_bar);                // last turn: P.V of the last tile
      fence_regs(o);
      wgmma_fence();
      pv_tile<D, kBN>(o, pa, desc_v(sl));
      if (wgi == 0) named_arrive(other_bar);
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(empty(sl));
      t += it.n_tiles;

#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = row_lo + hh * 8;
        if (r >= n_rows || pos[hh] >= Sq) continue;
        const float inv = 1.f / fmaxf(l_r[hh], 1e-30f);
        __nv_bfloat16* dst =
            out + ((size_t)(it.b * Sq + pos[hh]) * H + it.g * rep + r % rep) * D + 2 * quad;
#pragma unroll
        for (int nb = 0; nb < D / 8; ++nb)
          *reinterpret_cast<uint32_t*>(dst + nb * 8) =
              pack_bf16x2(o[nb * 4 + 2 * hh] * inv, o[nb * 4 + 2 * hh + 1] * inv);
      }
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so the library needs
// no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor map over a contiguous (B, S, N, D) tensor, dims innermost
// first, whose box is 64 head dims (one 128-byte swizzle row) x `heads`
// heads x `rows` positions x 1 batch row: it lands in shared memory as
// rows x heads lines of 128 bytes, position-major.  Positions past S come
// in as zeros.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int B, int S, int N, int D,
                     int heads, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t row = (cuuint64_t)D * 2;          // bytes of one head
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)N, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {row, row * N, row * N * S};
  const cuuint32_t box[4] = {64, (cuuint32_t)heads, (cuuint32_t)rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                        dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace wg

// ---------------------------------------------------------------------------
// bf16, D 32 (or more than kBM query heads per kv head): the first
// version's mma.sync kernel
// ---------------------------------------------------------------------------

constexpr int kBM = 64;            // query rows per CTA
constexpr int kBN = 64;            // keys per K/V tile

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 b16 matrices, transposed: lanes 8i..8i+7 give the row addresses
// of matrix i; register i receives matrix i's elements [2(lane%4)][lane/4]
// and [2(lane%4)+1][lane/4]
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

struct Args {
  const void *q, *k, *v;
  void* out;
  int B, Sq, Skv, H, KVH, causal;
  float scale;
  cudaStream_t stream;
};

// the keys a CTA's query rows [m0, m0 + kBM) can see: [0, kv_end)
__device__ __forceinline__ int visible_keys(int m0, int Sq, int Skv, int causal) {
  if (!causal) return Skv;
  return min(Skv, min(Sq, m0 + kBM));
}

constexpr int kMmaThreads = 128;   // 4 warps x 16 query rows

template <int D>
constexpr size_t mma_smem_bytes() {   // q tile + 2 K tiles + 2 V tiles
  return (size_t)(kBM + 4 * kBN) * (D + 8) * sizeof(__nv_bfloat16);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,   // (B, Sq, H, D)
               const __nv_bfloat16* __restrict__ k,   // (B, Skv, KVH, D)
               const __nv_bfloat16* __restrict__ v,   // (B, Skv, KVH, D)
               __nv_bfloat16* __restrict__ out,       // (B, Sq, H, D)
               int Sq, int Skv, int H, int KVH, int causal, float scale) {
  constexpr int kRow = D + 8;          // padded shared row (bf16 elements)
  constexpr int kChunks = D / 8;       // 16-byte chunks per row
  constexpr int kKSteps = D / 16;      // k16 steps of QK^T over the head dim
  constexpr int kDTiles = D / 8;       // n8 tiles of PV over the head dim
  constexpr int kNTiles = kBN / 8;     // n8 tiles of QK^T over a key tile

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + kBM * kRow;       // [2][kBN][kRow]
  __nv_bfloat16* v_s = k_s + 2 * kBN * kRow;   // [2][kBN][kRow]

  const int m0 = (gridDim.x - 1 - blockIdx.x) * kBM;   // largest blocks first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / KVH);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;            // fragment row within 8
  const int tq = lane & 3;             // fragment column pair

  const size_t q_tok = (size_t)H * D;      // elements between tokens
  const size_t kv_tok = (size_t)KVH * D;
  const __nv_bfloat16* qg = q + ((size_t)b * Sq * H + h) * D;
  const __nv_bfloat16* kg = k + ((size_t)b * Skv * KVH + g) * D;
  const __nv_bfloat16* vg = v + ((size_t)b * Skv * KVH + g) * D;

  const int kv_end = visible_keys(m0, Sq, Skv, causal);
  const int n_tiles = (kv_end + kBN - 1) / kBN;

  // rows [row0, row0 + 64) of a (tokens, D) view with ``stride`` between
  // tokens; rows at or past ``limit`` are zero-filled, never read
  auto load_tile = [&](__nv_bfloat16* dst, const __nv_bfloat16* src, size_t stride,
                       int row0, int limit) {
    for (int c = tid; c < 64 * kChunks; c += kMmaThreads) {
      const int r = c / kChunks;
      const int e = (c % kChunks) * 8;
      __nv_bfloat16* d = dst + r * kRow + e;
      if (row0 + r < limit) {
        cp_async16(d, src + (size_t)(row0 + r) * stride + e);
      } else {
        *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
      }
    }
  };

  load_tile(q_s, qg, q_tok, m0, Sq);
  if (n_tiles > 0) {
    load_tile(k_s, kg, kv_tok, 0, Skv);
    load_tile(v_s, vg, kv_tok, 0, Skv);
  }
  cp_async_commit();

  float o[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.f, 0.f};
  uint32_t qa[kKSteps][4];
  const int r0 = warp * 16 + gq;       // this thread's rows: r0 and r0 + 8

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {             // prefetch the next tile, then wait
      load_tile(k_s + (buf ^ 1) * kBN * kRow, kg, kv_tok, (j + 1) * kBN, Skv);
      load_tile(v_s + (buf ^ 1) * kBN * kRow, vg, kv_tok, (j + 1) * kBN, Skv);
      cp_async_commit();
      cp_async_wait<1>();              // for this one only
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        const __nv_bfloat16* qr = q_s + r0 * kRow + kk * 16 + 2 * tq;
        qa[kk][0] = *reinterpret_cast<const uint32_t*>(qr);
        qa[kk][1] = *reinterpret_cast<const uint32_t*>(qr + 8 * kRow);
        qa[kk][2] = *reinterpret_cast<const uint32_t*>(qr + 8);
        qa[kk][3] = *reinterpret_cast<const uint32_t*>(qr + 8 * kRow + 8);
      }
    }
    const __nv_bfloat16* ks = k_s + buf * kBN * kRow;
    const __nv_bfloat16* vs = v_s + buf * kBN * kRow;

    // S = Q K^T over this tile (16 rows x 64 keys per warp)
    float s[kNTiles][4];
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
        const __nv_bfloat16* kr = ks + (nt * 8 + gq) * kRow + kk * 16 + 2 * tq;
        mma_bf16(s[nt], qa[kk], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // scale and mask; fold the tile into the online softmax of both rows
    const int n0 = j * kBN;
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + r0 + (e >> 1) * 8;
        const int col = n0 + nt * 8 + 2 * tq + (e & 1);
        const bool ok = col < Skv && (!causal || col <= row);
        s[nt][e] = ok ? s[nt][e] * scale : kNegInf;
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = kNegInf;
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * hh], s[nt][2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[hh], mx);
      const float corr = expf(m_r[hh] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
        s[nt][2 * hh] = expf(s[nt][2 * hh] - m_new);
        s[nt][2 * hh + 1] = expf(s[nt][2 * hh + 1] - m_new);
        sum += s[nt][2 * hh] + s[nt][2 * hh + 1];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_r[hh] = l_r[hh] * corr + sum;
      m_r[hh] = m_new;
#pragma unroll
      for (int dt = 0; dt < kDTiles; ++dt) {
        o[dt][2 * hh] *= corr;
        o[dt][2 * hh + 1] *= corr;
      }
    }

    // O += P V: the score accumulators of key tiles 2kk, 2kk+1 are the A
    // fragment of the k16 step kk
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int mat = lane >> 3;
      const int key = kk * 16 + (mat & 1) * 8 + (lane & 7);
#pragma unroll
      for (int dt = 0; dt < kDTiles; dt += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vs + key * kRow + (dt + (mat >> 1)) * 8);
        mma_bf16(o[dt], pa, bv[0], bv[1]);
        mma_bf16(o[dt + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();                   // buf is refilled two tiles on
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = m0 + r0 + hh * 8;
    if (row >= Sq) continue;
    const float l = fmaxf(l_r[hh], 1e-30f);
    __nv_bfloat16* dst = out + ((size_t)(b * Sq + row) * H + h) * D + 2 * tq;
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt)
      *reinterpret_cast<uint32_t*>(dst + dt * 8) =
          pack_bf16x2(o[dt][2 * hh] / l, o[dt][2 * hh + 1] / l);
  }
}

template <int D>
cudaError_t launch_bf16(const Args& a) {
  auto kernel = flash_fwd_bf16<D>;
  constexpr size_t smem = mma_smem_bytes<D>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((a.Sq + kBM - 1) / kBM, a.H, a.B);
  kernel<<<grid, kMmaThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<__nv_bfloat16*>(a.out),
      a.Sq, a.Skv, a.H, a.KVH, a.causal, a.scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kFmaThreads = 256;   // 16 x 16

template <int D>
constexpr size_t fma_smem_bytes() {   // q, k (padded rows), v, p tiles
  return ((size_t)kBM * (D + 1) + (size_t)kBN * (D + 1) + (size_t)kBN * D +
          (size_t)kBM * (kBN + 1)) * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kFmaThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out,
              int Sq, int Skv, int H, int KVH, int causal, float scale) {
  constexpr int kQK = D + 1;           // padded rows: column reads hit distinct banks
  constexpr int kP = kBN + 1;
  constexpr int kDJ = D / 16;          // accumulator columns per thread

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);   // [kBM][kQK]
  float* k_s = q_s + kBM * kQK;                      // [kBN][kQK]
  float* v_s = k_s + kBN * kQK;                      // [kBN][D]
  float* p_s = v_s + kBN * D;                        // [kBM][kP]

  const int m0 = (gridDim.x - 1 - blockIdx.x) * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / KVH);
  const int tid = threadIdx.x;
  const int ty = tid >> 4;             // rows ty + 16 i
  const int tx = tid & 15;             // keys tx + 16 j; head dims tx + 16 j

  const size_t q_tok = (size_t)H * D;
  const size_t kv_tok = (size_t)KVH * D;
  const float* qg = q + ((size_t)b * Sq * H + h) * D;
  const float* kg = k + ((size_t)b * Skv * KVH + g) * D;
  const float* vg = v + ((size_t)b * Skv * KVH + g) * D;

  for (int c = tid; c < kBM * D; c += kFmaThreads) {
    const int r = c / D, e = c % D;
    q_s[r * kQK + e] = m0 + r < Sq ? qg[(size_t)(m0 + r) * q_tok + e] : 0.f;
  }

  float acc[4][kDJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jd = 0; jd < kDJ; ++jd) acc[i][jd] = 0.f;
  float m_r[4], l_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_r[i] = kNegInf;
    l_r[i] = 0.f;
  }

  const int kv_end = visible_keys(m0, Sq, Skv, causal);
  for (int n0 = 0; n0 < kv_end; n0 += kBN) {
    __syncthreads();                   // the previous tile is consumed
    for (int c = tid; c < kBN * D; c += kFmaThreads) {
      const int r = c / D, e = c % D;
      const bool live = n0 + r < Skv;
      k_s[r * kQK + e] = live ? kg[(size_t)(n0 + r) * kv_tok + e] : 0.f;
      v_s[r * D + e] = live ? vg[(size_t)(n0 + r) * kv_tok + e] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty + 16 * i) * kQK + d];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kv[jj] = k_s[(tx + 16 * jj) * kQK + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(qv[i], kv[jj], s[i][jj]);
    }

    // the 64 scores of a row live in the 16 threads of its half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = n0 + tx + 16 * jj;
        const bool ok = col < Skv && (!causal || col <= row);
        s[i][jj] = ok ? s[i][jj] * scale : kNegInf;
        mx = fmaxf(mx, s[i][jj]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_r[i], mx);
      const float corr = expf(m_r[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(s[i][jj] - m_new);
        p_s[(ty + 16 * i) * kP + tx + 16 * jj] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l_r[i] = l_r[i] * corr + sum;
      m_r[i] = m_new;
#pragma unroll
      for (int jd = 0; jd < kDJ; ++jd) acc[i][jd] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBN; ++c) {
      float vv[kDJ];
#pragma unroll
      for (int jd = 0; jd < kDJ; ++jd) vv[jd] = v_s[c * D + tx + 16 * jd];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = p_s[(ty + 16 * i) * kP + c];
#pragma unroll
        for (int jd = 0; jd < kDJ; ++jd) acc[i][jd] = fmaf(p, vv[jd], acc[i][jd]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float l = fmaxf(l_r[i], 1e-30f);
    float* dst = out + ((size_t)(b * Sq + row) * H + h) * D;
#pragma unroll
    for (int jd = 0; jd < kDJ; ++jd) dst[tx + 16 * jd] = acc[i][jd] / l;
  }
}

template <int D>
cudaError_t launch_f32(const Args& a) {
  auto kernel = flash_fwd_f32<D>;
  constexpr size_t smem = fma_smem_bytes<D>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((a.Sq + kBM - 1) / kBM, a.H, a.B);
  kernel<<<grid, kFmaThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.out),
      a.Sq, a.Skv, a.H, a.KVH, a.causal, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_wgmma(const Args& a) {
  using C = wg::Cfg<D>;
  // a Q box is an item: the rep heads of one kv head at kBM / rep
  // positions; a K or V box is kBN keys of one kv head
  const int rep = a.H / a.KVH;
  if (rep > wg::kBM) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  cudaError_t e = wg::make_map(&mq, a.q, a.B, a.Sq, a.H, D, rep, wg::kBM / rep);
  if (e == cudaSuccess) e = wg::make_map(&mk, a.k, a.B, a.Skv, a.KVH, D, 1, C::kBN);
  if (e == cudaSuccess) e = wg::make_map(&mv, a.v, a.B, a.Skv, a.KVH, D, 1, C::kBN);
  if (e != cudaSuccess) return e;
  auto kernel = wg::flash_fwd_wgmma<D>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (e != cudaSuccess) return e;
  const int n_pos = wg::kBM / rep;
  const long long n_items = (long long)((a.Sq + n_pos - 1) / n_pos) * a.KVH * a.B;
  if (n_items > (1ll << 30)) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int grid = (int)(n_items < sms ? n_items : sms);   // one CTA an SM
  kernel<<<grid, wg::kThreads, C::kSmem, a.stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(a.out), a.B, a.Sq, a.Skv, a.H, a.KVH,
      a.causal, a.scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, Sq, H, D), k / v (B, Skv, KVH, D), out (B, Sq, H, D), all contiguous
// and 16-byte aligned, of one dtype; H a multiple of KVH; causal: 0 or 1
// (top-left aligned).  variant (chosen by the host from dtype and D):
//   0  float32, D 32/64/128: CUDA-core FMAs (flash_fwd_f32)
//   1  bfloat16, D 32 (any D when H / KVH > 128): mma.sync (flash_fwd_bf16)
//   2  bfloat16, D 64/128 and H / KVH <= 128: wgmma + TMA (flash_fwd_wgmma)
// Returns a cudaError_t (0 = ok).
int flash_attention(const void* q, const void* k, const void* v, void* out, int B,
                    int Sq, int Skv, int H, int KVH, int D, int causal, float scale,
                    int variant, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || KVH < 1 || H < KVH || H % KVH != 0 || B > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, out, B, Sq, Skv, H, KVH, causal != 0, scale,
               static_cast<cudaStream_t>(stream)};
  switch (variant) {
    case 0:
      if (D == 32) return (int)launch_f32<32>(a);
      if (D == 64) return (int)launch_f32<64>(a);
      if (D == 128) return (int)launch_f32<128>(a);
      break;
    case 1:
      if (D == 32) return (int)launch_bf16<32>(a);
      if (D == 64) return (int)launch_bf16<64>(a);
      if (D == 128) return (int)launch_bf16<128>(a);
      break;
    case 2:
      if (D == 64) return (int)launch_wgmma<64>(a);
      if (D == 128) return (int)launch_wgmma<128>(a);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
