// MXFP4 weight-streaming VMM for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/mxfp4_vmm/kernel.py::mxfp4_vmm (:80, its pallas_call at
// :100; the RPU's Stream Decoder + TMAC stripe dataflow):
//
//   out[M, N] (f32, or rounded once to bf16) = x[M, K] (bf16) @ W[K, N],
//   W[k, n] = bf16( E2M1(code(k, n)) * 2^(scale(k / 32, n) - 127) )
//
// codes (K/2, N) uint8 hold two E2M1 codes per byte along K (low nibble =
// even k); scales (K/32, N) uint8 are E8M0 biased exponents.  The decoded
// weight is exact in bf16 and every product is exact in f32, so the kernel
// computes the plain version's function (dequantize to bf16, f32-accumulating
// matmul) up to the order of the f32 sums.  One launch serves a group of up
// to three weights that read the same x (q/k/v, gate/up): their column
// stripes are walked as one list, each output written to its own tensor.
//
// Two schedules in this source, picked by the host from M (kernel.py:
// schedule()), share one work split and one fold:
//
//   * work split (stream-K): the work is a list of units, (output tile, K
//     stage), tile-major.  The grid's CTAs take equal contiguous ranges of
//     it, so every SM streams the same number of stages whatever the
//     shape.  A CTA whose range covers a whole tile writes it; a piece of a
//     tile goes to an f32 workspace slot, and the last CTA of the tile to
//     arrive (an integer counter per tile, reset by that CTA) adds the
//     pieces in CTA order and writes the tile.  The partition depends only
//     on the shape and the grid, so the sums' order -- and the bits -- do
//     not depend on the order in which CTAs run.  One launch, no reduce
//     kernel, no float atomics.
//
//   * decode (M <= 16, kernel mxfp4_vmm_decode): bound by device-memory bytes.
//     It streams 0.53 bytes per weight and does 2 M flops on it, far below
//     the card's ridge (a llama3-8b layer's four launches read 116 MB: 35
//     us at 3.35 TB/s).  What it does about it: one producer warp keeps a
//     6-stage ring full -- one thread issues a TMA copy of each 128-row x
//     128-column code tile (8 KB, 128-byte swizzle) and its scales; the
//     warp's lanes copy the x rows of the stage with cp.async -- so every
//     SM has tens of KB in flight and the consumers spend no instruction on
//     addresses.  Four consumer warps each take one 32-row MX block of a
//     stage.  The weights go on the A side of mma.sync m16n8k16 (16 output
//     columns x 16 k) and x on the n8 side, so M <= 8 wastes nothing: each A
//     register is one code byte (two consecutive k of one column), decoded
//     in registers -- prmt places the two nibbles, one integer multiply-add
//     and a mask put each nibble's magnitude in the bf16 exponent/mantissa
//     bits and its sign in bit 15, which is the E2M1 value times 2^-126
//     (e = 0 lands on bf16's subnormals the way E2M1's 0.5 needs), and one
//     bf16x2 multiply by 2^(s-1) gives the weight exactly (s >= 128 takes a
//     second multiply, where 2^(s-1) would overflow bf16).  A thread's code
//     bytes of a k step are two 16-byte shared loads: mma k pair t <-> code
//     row 2t, k pair t+4 <-> row 2t+1 (x is read in the same order), and
//     with the swizzle a quarter-warp's loads hit distinct banks.  The four
//     warps' sums are added in a fixed order at the end of each tile piece;
//     a split tile's last CTA folds the pieces with all four warps, several
//     CTAs' loads in flight at once.
//
//   * prefill (M > 16, kernel mxfp4_vmm_wgmma): bound by the tensor cores.
//     256 x 128 output tiles, 64-row K stages, 256 threads: two warpgroups
//     of 128 rows (two m64 halves each), no producer warp -- at 288 or more
//     threads ptxas caps a thread at 168 registers and the 128 f32
//     accumulators spill (setmaxnreg does not lift that cap).  Per stage i,
//     every thread waits for x tile i (TMA, 256 x 64 bf16, 128-byte
//     swizzle: wgmma's K-major A), issues its wgmma m64n128k16 products on
//     B tile i, and while they run decodes stage i + 1's code tile into the
//     other B tile (bf16, rows of N: an MN-major B, 128-byte swizzle; the
//     same register decode), so a weight is decoded once per 256 rows.
//     Thread 0 (x) and thread 128 (codes, a deeper ring) issue the next
//     copies into slots the last barrier freed, so there are no empty
//     barriers.  Each stage's wgmma group is waited for in the iteration
//     that issued it: a group left in flight across the loop's back edge
//     made ptxas serialise every wgmma (a WARPGROUP.DEPBAR before each).
//     The loop walks units with adds only (a 64-bit division per unit sat
//     on the critical path).  One CTA an SM.
//     What still holds it back (clock64 traces of one CTA on an H100): a
//     stage takes about twice its products' time at the card's peak;
//     issuing the eight wgmma waits for the tensor pipe, and the decode
//     and the TMA issues then run after it rather than beside it.
//
// Shapes: any M >= 1, K a multiple of 32, any N.  Rows past M and K load
// as zeros (TMA's out-of-bounds fill; cp.async zero fill), columns past N
// as zero codes, and neither is written.  TMA needs 16-byte row strides
// and bases: a weight with N % 16 != 0 or an unaligned base takes a plain
// byte copy by the producer warp into the same layout (slow; no served
// model has such a width).  A wait that does not finish within ~2 s traps
// (a launch error) instead of hanging the card.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSeg = 3;
constexpr int kBN = 128;            // output columns per tile, both schedules

// ---------------------------------------------------------------------------
// shared helpers
// ---------------------------------------------------------------------------

struct Seg {
  void* out;                 // (M, n) f32 or bf16
  const uint8_t* codes;      // (K/2, n)
  const uint8_t* scales;     // (K/32, n)
  int n;
  int stripe0;               // first column stripe of this segment
};

struct Params {
  Seg seg[kMaxSeg];
  int nseg;
  const __nv_bfloat16* x;    // (M, K)
  int M, K;
  int m_tiles;               // row tiles (1 for the decode schedule)
  int stages;                // K stages per tile
  long long units;           // tiles * stages
  float* ws;                 // gridDim.x * 2 pieces of BM * kBN f32
  int* counters;             // one per tile, zero before and after
  int tma;                   // codes/scales through TMA (else byte copies)
};

struct Maps {
  CUtensorMap x;             // prefill only
  CUtensorMap codes[kMaxSeg];
  CUtensorMap scales[kMaxSeg];
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

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
// the barrier counts one arrival of this thread once its cp.asyncs landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 p = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// u = [c_lo, 0, c_hi, 0] (two E2M1 codes in bytes 0 and 2) -> bf16x2 of
// (E2M1(c_lo), E2M1(c_hi)) * 2^-126: magnitude (e1 e0 m) to bits 8..6 (the
// exponent's low bits and the mantissa's top bit; e = 0 is a subnormal,
// as E2M1's own 0.5 is), sign to bit 15.  u * 0x1040 = u << 6 | u << 12.
__device__ __forceinline__ uint32_t e2m1x2_tiny(uint32_t u) {
  return (u * 0x1040u) & 0x81C081C0u;
}

// [s_lo, 0, s_hi, 0] (E8M0 bytes, each < 128) -> bf16x2 (2^(s_lo-1), 2^(s_hi-1))
__device__ __forceinline__ uint32_t pow2_scale_x2(uint32_t v) {
  return v * 128u + 0x3F003F00u;
}
// the same for any s, as two factors: 2^(min(s,128)-1) and 2^(max(s,128)-128)
__device__ __forceinline__ void pow2_scale_x2_wide(uint32_t s_lo, uint32_t s_hi,
                                                   uint32_t& fa, uint32_t& fb) {
  fa = ((min(s_lo, 128u) + 126u) << 7) | ((min(s_hi, 128u) + 126u) << 23);
  fb = ((max(s_lo, 128u) - 1u) << 7) | ((max(s_hi, 128u) - 1u) << 23);
}

// the tile of unit range starting at column stripe `stripe`
__device__ __forceinline__ int seg_of(const Params& p, int stripe) {
  return (p.nseg > 1 && stripe >= p.seg[1].stripe0) + (p.nseg > 2 && stripe >= p.seg[2].stripe0);
}
__device__ __forceinline__ const Seg& seg_ref(const Params& p, int s) {
  return s == 0 ? p.seg[0] : s == 1 ? p.seg[1] : p.seg[2];
}
__device__ __forceinline__ const CUtensorMap* codes_map(const Maps& m, int s) {
  return s == 0 ? &m.codes[0] : s == 1 ? &m.codes[1] : &m.codes[2];
}
__device__ __forceinline__ const CUtensorMap* scales_map(const Maps& m, int s) {
  return s == 0 ? &m.scales[0] : s == 1 ? &m.scales[1] : &m.scales[2];
}

// first unit of CTA c, and the CTA that owns unit u (stream-K partition)
__device__ __forceinline__ long long unit_lo(long long c, long long units, long long g) {
  return c * units / g;
}
__device__ __forceinline__ int cta_of(long long u, long long units, long long g) {
  return static_cast<int>(((u + 1) * g - 1) / units);
}

// A CTA's walk over its units in order: (tile, K stage) alone (Cursor), or
// with the unit's row tile, weight and columns (Walk), advanced with adds
// and compares only (a 64-bit division costs hundreds of cycles on the
// loop's critical path)
struct Cursor {
  int tile, stage;
  __device__ __forceinline__ Cursor(long long u, int stages)
      : tile(static_cast<int>(u / stages)), stage(static_cast<int>(u % stages)) {}
  __device__ __forceinline__ void next(int stages) {
    if (++stage == stages) {
      stage = 0;
      ++tile;
    }
  }
};
struct Walk {
  int tile, stage, mt, sg, n0, m0, bm;
  __device__ __forceinline__ Walk(const Params& p, long long u, int bm_) : bm(bm_) {
    tile = static_cast<int>(u / p.stages);
    stage = static_cast<int>(u % p.stages);
    const int stripe = tile / p.m_tiles;
    mt = tile - stripe * p.m_tiles;
    m0 = mt * bm;
    sg = seg_of(p, stripe);
    n0 = (stripe - seg_ref(p, sg).stripe0) * kBN;
  }
  __device__ __forceinline__ void next(const Params& p) {
    if (++stage < p.stages) return;
    stage = 0;
    ++tile;
    m0 += bm;
    if (++mt < p.m_tiles) return;
    mt = 0;
    m0 = 0;
    n0 += kBN;
    const int stripe_next = sg + 1 < p.nseg ? seg_ref(p, sg + 1).stripe0 : -1;
    if (tile == stripe_next * p.m_tiles) {
      ++sg;
      n0 = 0;
    }
  }
};

// rows x 128 bytes of a (rows_total, n) byte matrix from (r0, c0) into
// shared memory (128-byte rows, optionally 128-byte swizzled), zeros
// outside; by the 32 lanes of a warp (the path for weights TMA cannot map)
__device__ void copy_bytes(uint8_t* dst, const uint8_t* src, int r0, int rows,
                           int rows_total, int c0, int n, bool swz, int lane) {
  for (int i = lane; i < rows * 128; i += 32) {
    const int r = i >> 7, c = i & 127;
    const int gr = r0 + r, gc = c0 + c;
    const uint8_t v = (gr < rows_total && gc < n) ? src[(size_t)gr * n + gc] : 0;
    const int off = swz ? r * 128 + ((((c >> 4) ^ (r & 7))) << 4) + (c & 15) : r * 128 + c;
    dst[off] = v;
  }
}

template <typename OutT> struct Out;
template <> struct Out<float> {
  static __device__ __forceinline__ void one(float* p, float v) { *p = v; }
};
template <> struct Out<__nv_bfloat16> {
  static __device__ __forceinline__ void one(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

// 16 consecutive outputs of one row from v; vec: the 16 are in range and
// aligned for 16-byte stores
__device__ __forceinline__ void store16(float* p, const float (&v)[16], int n_ok, bool vec) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      reinterpret_cast<float4*>(p)[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  } else {
    for (int i = 0; i < 16 && i < n_ok; ++i) p[i] = v[i];
  }
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&v)[16], int n_ok,
                                        bool vec) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint4 u;
      u.x = pack_bf16x2(v[8 * i + 0], v[8 * i + 1]);
      u.y = pack_bf16x2(v[8 * i + 2], v[8 * i + 3]);
      u.z = pack_bf16x2(v[8 * i + 4], v[8 * i + 5]);
      u.w = pack_bf16x2(v[8 * i + 6], v[8 * i + 7]);
      reinterpret_cast<uint4*>(p)[i] = u;
    }
  } else {
    for (int i = 0; i < 16 && i < n_ok; ++i) p[i] = __float2bfloat16_rn(v[i]);
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// decode schedule: mma.sync, weights on the A side
// ---------------------------------------------------------------------------

namespace dec {

constexpr int kStageK = 128;               // K rows per stage: 64 code rows
constexpr int kThreads = 160;              // 4 consumer warps + 1 producer warp
constexpr int kCodeBytes = kStageK / 2 * kBN;    // 8 KB, 128-byte swizzle
constexpr int kScaleBytes = kStageK / 32 * kBN;  // 512 B
constexpr int kXRow = kStageK + 16;        // padded x row (bf16): distinct banks

template <int NT>
struct Cfg {
  static constexpr int kBM = 8 * NT;
  static constexpr int kStages = 6;
  static constexpr int kXBytes = kBM * kXRow * 2;
  static constexpr int kCodeOff = 0;
  static constexpr int kScaleOff = kStages * kCodeBytes;
  static constexpr int kXOff = kScaleOff + kStages * kScaleBytes;
  static constexpr int kRedOff = kXOff + kStages * kXBytes;
  static constexpr int kRedBytes = 32 * 32 * NT * 4;   // one warp's sums
  static constexpr int kBarOff = kRedOff + kRedBytes;
  static constexpr int kFlagOff = kBarOff + 16 * kStages;
  static constexpr int kSmem = kFlagOff + 16 + 1024;   // + alignment slack
  static_assert(kSmem <= 232448, "shared memory of one CTA");
};

// bf16x2 weights of one code word (4 columns' bytes) into a[0..3]
template <bool kWide>
__device__ __forceinline__ void decode_word(uint32_t w, const uint32_t* fa,
                                            const uint32_t* fb, uint32_t* a) {
  const uint32_t lo = w & 0x0F0F0F0Fu;
  const uint32_t hi = (w >> 4) & 0x0F0F0F0Fu;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    // [lo nibble of byte b, 0, hi nibble of byte b, 0]: selector 8 copies
    // the (clear) top bit of a byte, which gives a zero byte
    const uint32_t u = prmt(lo, hi, b | 0x80 | ((4 + b) << 8) | 0x8000);
    uint32_t v = mul_bf16x2(e2m1x2_tiny(u), fa[b]);
    if (kWide) v = mul_bf16x2(v, fb[b]);
    a[b] = v;
  }
}

// One warp's MX block (32 k = code rows 16w..16w+15) of a stage: two k16
// steps over the 128 columns (8 m16 tiles; tile j row r is column
// 16 (r % 8) + 8 (r / 8) + j) and NT n8 tiles of x rows.
template <int NT, bool kWide>
__device__ __forceinline__ void block_mma(float (&acc)[NT][8][4], const uint8_t* cs,
                                          const uint8_t* scl, const uint8_t* xs, int w,
                                          int g, int t) {
  const uint4 sv = *reinterpret_cast<const uint4*>(scl + w * kBN + 16 * g);
  const uint32_t sw[4] = {sv.x, sv.y, sv.z, sv.w};
  uint32_t fa[16], fb[16];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (kWide) {
        const uint32_t s = (sw[q] >> (8 * b)) & 0xFFu;
        pow2_scale_x2_wide(s, s, fa[4 * q + b], fb[4 * q + b]);
      } else {
        fa[4 * q + b] = pow2_scale_x2(prmt(sw[q], 0u, b | 0x40 | (b << 8) | 0x4000));
      }
    }
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const int r0 = 16 * w + 8 * ks + 2 * t;     // k pair t; r0 + 1: k pair t + 4
    const uint4 l0 = *reinterpret_cast<const uint4*>(cs + r0 * 128 + ((g ^ (2 * t)) << 4));
    const uint4 l1 =
        *reinterpret_cast<const uint4*>(cs + (r0 + 1) * 128 + ((g ^ (2 * t + 1)) << 4));
    uint32_t bx[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint2 v = *reinterpret_cast<const uint2*>(
          xs + ((8 * nt + g) * kXRow + 32 * w + 16 * ks + 4 * t) * 2);
      bx[nt][0] = v.x;      // x[k = 4t, 4t+1]: code row 2t
      bx[nt][1] = v.y;      // x[k = 4t+2, 4t+3]: code row 2t+1
    }
    const uint32_t w0[4] = {l0.x, l0.y, l0.z, l0.w}, w1[4] = {l1.x, l1.y, l1.z, l1.w};
#pragma unroll
    for (int jq = 0; jq < 2; ++jq) {      // tiles 4 jq .. 4 jq + 3
      uint32_t a[4][4];                   // a[fragment register][tile]
      decode_word<kWide>(w0[jq], fa + 4 * jq, fb + 4 * jq, a[0]);           // row g, pair t
      decode_word<kWide>(w0[2 + jq], fa + 8 + 4 * jq, fb + 8 + 4 * jq, a[1]);   // g + 8
      decode_word<kWide>(w1[jq], fa + 4 * jq, fb + 4 * jq, a[2]);           // row g, pair t+4
      decode_word<kWide>(w1[2 + jq], fa + 8 + 4 * jq, fb + 8 + 4 * jq, a[3]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_bf16(acc[nt][4 * jq + j], a[0][j], a[1][j], a[2][j], a[3][j], bx[nt][0],
                   bx[nt][1]);
    }
  }
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// a whole tile from warp 0's sums: lane (g, t) holds rows 8 nt + 2t (+1),
// columns 16g + 0..15 of the tile (j and 8 + j of its m16 tiles)
template <int NT, typename OutT>
__device__ __forceinline__ void write_tile(OutT* out, const float (&v)[NT][8][4], int M,
                                           int n, int n0, int g, int t) {
  const int n_ok = n - (n0 + 16 * g);
  const bool vec = n_ok >= 16 && n % (sizeof(OutT) == 4 ? 4 : 8) == 0;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 8 * nt + 2 * t + h;
      if (m >= M || n_ok <= 0) continue;
      float row[16];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        row[j] = v[nt][j][h];
        row[8 + j] = v[nt][j][2 + h];
      }
      store16(out + (size_t)m * n + n0 + 16 * g, row, n_ok, vec);
    }
}

// The tile's pieces (slots of CTAs c_first..c_last, each warp 0's lane
// layout: float4 (nt * 8 + j) * 32 + lane) added in CTA order and written,
// by all 128 consumer threads, several CTAs' loads in flight at once
template <int NT, typename OutT>
__device__ __forceinline__ void fold_tile(const Params& p, OutT* out, int n, int n0,
                                          long long t_lo, int c_first, int c_last,
                                          long long G, int tid) {
  constexpr int kPer = 2 * NT;               // float4s per thread
  constexpr int kBatch = 4;                  // CTAs loaded together
  constexpr int kBM = 8 * NT;
  float4 s[kPer];
  for (int c0 = c_first; c0 <= c_last; c0 += kBatch) {
    float4 v[kBatch][kPer];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int c = c0 + b;
      if (c > c_last) break;
      const int slot = unit_lo(c, p.units, G) < t_lo ? 1 : 0;
      const float4* part =
          reinterpret_cast<const float4*>(p.ws + ((size_t)c * 2 + slot) * kBM * kBN);
#pragma unroll
      for (int i = 0; i < kPer; ++i) v[b][i] = __ldcg(part + tid + 128 * i);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (c0 + b > c_last) break;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        if (c0 + b == c_first) {
          s[i] = v[b][i];
        } else {
          s[i].x += v[b][i].x; s[i].y += v[b][i].y; s[i].z += v[b][i].z; s[i].w += v[b][i].w;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int f = tid + 128 * i;
    const int lane = f & 31, j = (f >> 5) & 7, nt = f >> 8;
    const int m = 8 * nt + 2 * (lane & 3), c = n0 + 16 * (lane >> 2) + j;
    const float e[4] = {s[i].x, s[i].y, s[i].z, s[i].w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int mq = m + (q & 1), cq = c + 8 * (q >> 1);
      if (mq < p.M && cq < n) Out<OutT>::one(out + (size_t)mq * n + cq, e[q]);
    }
  }
}

template <int NT, typename OutT>
__global__ void __launch_bounds__(kThreads, 2)
mxfp4_vmm_decode(const __grid_constant__ Maps maps, const Params p) {
  using C = Cfg<NT>;
  constexpr int kBM = C::kBM;
  constexpr int kStages = C::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* codes_s = base + C::kCodeOff;
  uint8_t* scales_s = base + C::kScaleOff;
  uint8_t* x_s = base + C::kXOff;
  float* red = reinterpret_cast<float*>(base + C::kRedOff);
  int* flag = reinterpret_cast<int*>(base + C::kFlagOff);
  const uint32_t bars = smem_u32(base + C::kBarOff);
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (kStages + s); };

  const long long G = gridDim.x;
  const long long lo = unit_lo(blockIdx.x, p.units, G);
  const long long hi = unit_lo(blockIdx.x + 1, p.units, G);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1 + 32);      // TMA (or copy) arrival + 32 lanes' cp.async
      mbar_init(empty(s), 128);        // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // ---------------- producer warp
    Walk at(p, lo, kBM);
    for (int idx = 0; idx < hi - lo; ++idx, at.next(p)) {
      const int s = idx % kStages;
      mbar_wait(empty(s), ((idx / kStages) & 1) ^ 1);   // round 0 passes
      const int k0 = at.stage * kStageK;
      const int sg = at.sg, n0 = at.n0;
      const Seg& sp = seg_ref(p, sg);
      uint8_t* cdst = codes_s + s * kCodeBytes;
      uint8_t* sdst = scales_s + s * kScaleBytes;
      if (p.tma) {
        if (lane == 0) {
          mbar_expect_tx(full(s), kCodeBytes + kScaleBytes);
          tma_load_2d(smem_u32(cdst), codes_map(maps, sg), full(s), n0, k0 / 2);
          tma_load_2d(smem_u32(sdst), scales_map(maps, sg), full(s), n0, k0 / 32);
        }
      } else {
        copy_bytes(cdst, sp.codes, k0 / 2, kStageK / 2, p.K / 2, n0, sp.n, true, lane);
        copy_bytes(sdst, sp.scales, k0 / 32, kStageK / 32, p.K / 32, n0, sp.n, false, lane);
        __syncwarp();
        if (lane == 0) mbar_arrive(full(s));
      }
      // x rows of the stage: kBM rows x 16 chunks of 8 k
      const uint32_t xdst = smem_u32(x_s + s * C::kXBytes);
      for (int i = lane; i < kBM * 16; i += 32) {
        const int r = i >> 4, c = i & 15;
        const int k = k0 + 8 * c;
        const bool ok = r < p.M && k < p.K;
        cp_async16(xdst + (r * kXRow + 8 * c) * 2, ok ? p.x + (size_t)r * p.K + k : p.x,
                   ok ? 16 : 0);
      }
      cp_async_arrive(full(s));
    }
    return;
  }

  // ---------------- consumer warps: warp w takes MX block w of each stage
  const int g = lane >> 2, t = lane & 3;
  float acc[NT][8][4];
  Walk at(p, lo, kBM);
  for (int idx = 0; idx < hi - lo; ++idx, at.next(p)) {
    const int s = idx % kStages;
    if (idx == 0 || at.stage == 0) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][j][e] = 0.f;
    }
    mbar_wait(full(s), (idx / kStages) & 1);
    const uint8_t* cs = codes_s + s * kCodeBytes;
    const uint8_t* scl = scales_s + s * kScaleBytes;
    const uint8_t* xs = x_s + s * C::kXBytes;
    const uint4 sv = *reinterpret_cast<const uint4*>(scl + warp * kBN + 16 * g);
    const bool wide = ((sv.x | sv.y | sv.z | sv.w) & 0x80808080u) != 0;
    if (__any_sync(0xffffffffu, wide))
      block_mma<NT, true>(acc, cs, scl, xs, warp, g, t);
    else
      block_mma<NT, false>(acc, cs, scl, xs, warp, g, t);
    mbar_arrive(empty(s));
    if (idx + 1 != hi - lo && at.stage + 1 != p.stages) continue;

    // ---- end of a tile piece: add the warps' sums, ((w3 + w2) + w1) + w0
    const int tile = at.tile;
    float4* red4 = reinterpret_cast<float4*>(red);
#pragma unroll
    for (int step = 3; step >= 0; --step) {
      if (warp == step) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            float4& r4 = red4[(nt * 8 + j) * 32 + lane];
            if (step < 3) {
              const float4 o = r4;
              acc[nt][j][0] += o.x;
              acc[nt][j][1] += o.y;
              acc[nt][j][2] += o.z;
              acc[nt][j][3] += o.w;
            }
            if (step > 0) r4 = make_float4(acc[nt][j][0], acc[nt][j][1], acc[nt][j][2], acc[nt][j][3]);
          }
      }
      consumer_sync();
    }
    const long long t_lo = (long long)tile * p.stages, t_hi = t_lo + p.stages;
    const Seg& sp = seg_ref(p, at.sg);
    const int n0 = at.n0;
    OutT* out = static_cast<OutT*>(sp.out);
    if (lo <= t_lo && hi >= t_hi) {               // the whole tile: write it
      if (warp == 0) write_tile<NT>(out, acc, p.M, sp.n, n0, g, t);
      continue;
    }
    // a piece: warp 0 puts it in this CTA's slot; the tile's last CTA folds
    if (warp == 0) {
      float4* mine = reinterpret_cast<float4*>(
          p.ws + ((size_t)blockIdx.x * 2 + (lo < t_lo ? 1 : 0)) * kBM * kBN);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mine[(nt * 8 + j) * 32 + lane] =
              make_float4(acc[nt][j][0], acc[nt][j][1], acc[nt][j][2], acc[nt][j][3]);
      __threadfence();
    }
    const int c_first = cta_of(t_lo, p.units, G), c_last = cta_of(t_hi - 1, p.units, G);
    consumer_sync();
    if (threadIdx.x == 0) *flag = atomicAdd(p.counters + tile, 1) == c_last - c_first;
    consumer_sync();
    if (!*flag) continue;
    __threadfence();
    fold_tile<NT>(p, out, sp.n, n0, t_lo, c_first, c_last, G, threadIdx.x);
    if (threadIdx.x == 0) p.counters[tile] = 0;   // ready for the next launch
  }
}

}  // namespace dec

// ---------------------------------------------------------------------------
// prefill schedule: warp-specialised wgmma + TMA
// ---------------------------------------------------------------------------

namespace wg {

constexpr int kBM = 256;                   // rows per tile: two warpgroups of 128
constexpr int kStageK = 64;                // K rows per stage: one 128-byte x row
constexpr int kXStages = 4;                // x ring: stage i + 3 loads during stage i
constexpr int kCStages = 8;                // code ring: stage i + 8 loads during stage i
constexpr int kThreads = 256;              // two warpgroups, no producer warp
constexpr int kXBytes = kBM * kStageK * 2;         // 32 KB, 128-byte swizzle
constexpr int kBBytes = kStageK * kBN * 2;         // 16 KB: 2 blocks of 64 n
constexpr int kCodeBytes = kStageK / 2 * kBN;      // 4 KB
constexpr int kScaleBytes = kStageK / 32 * kBN;    // 256 B
constexpr int kXOff = 0;
constexpr int kBStages = 2;                // decoded B tiles: i % 2
constexpr int kBOff = kXOff + kXStages * kXBytes;
constexpr int kCodeOff = kBOff + kBStages * kBBytes;
constexpr int kScaleOff = kCodeOff + kCStages * kCodeBytes;
constexpr int kBarOff = kScaleOff + kCStages * kScaleBytes;
constexpr int kWalkOff = kBarOff + 8 * (kXStages + kCStages);   // the loaders' walks
constexpr int kFlagOff = kWalkOff + 2 * sizeof(Walk);
constexpr int kSmem = kFlagOff + 16 + 1024;        // + alignment slack
static_assert(kSmem <= 232448, "shared memory of one CTA");

__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
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
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// D (64 x 128, f32) (+)= A (64 x 16, smem, K-major) . B (16 x 128, smem,
// MN-major); accumulate == 0 overwrites D
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
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

// Consumer thread t's share of a stage's B tile: code row r = t / 8 (B rows
// k = 2r from the low nibbles, 2r + 1 from the high ones), columns
// 16 (t % 8) .. + 15
template <bool kWide>
__device__ __forceinline__ void decode_stage(uint8_t* bt, const uint8_t* cs, const uint8_t* scl,
                                             int t) {
  const int r = t >> 3, c16 = t & 7;
  const uint4 sv = *reinterpret_cast<const uint4*>(scl + (r >> 4) * kBN + 16 * c16);
  const uint4 cv = *reinterpret_cast<const uint4*>(cs + r * kBN + 16 * c16);
  const uint32_t sw[4] = {sv.x, sv.y, sv.z, sv.w};
  const uint32_t cw[4] = {cv.x, cv.y, cv.z, cv.w};
  uint32_t fa[8], fb[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {             // columns 2q, 2q + 1
    const uint32_t w = sw[q >> 1];
    const int b0 = 2 * (q & 1);
    if (kWide)
      pow2_scale_x2_wide((w >> (8 * b0)) & 0xFFu, (w >> (8 * b0 + 8)) & 0xFFu, fa[q], fb[q]);
    else
      fa[q] = pow2_scale_x2(prmt(w, 0u, b0 | 0x40 | ((b0 + 1) << 8) | 0x4000));
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const uint32_t src = (h ? cw[q >> 1] >> 4 : cw[q >> 1]) & 0x0F0F0F0Fu;
      const uint32_t u = prmt(src, src, (q & 1) ? 0x8382u : 0x8180u);
      uint32_t e = mul_bf16x2(e2m1x2_tiny(u), fa[q]);
      if (kWide) e = mul_bf16x2(e, fb[q]);
      v[q] = e;
    }
    const int k = 2 * r + h;
    uint8_t* row = bt + (c16 >> 2) * (kStageK * 128) + k * 128;
    const int ch = (2 * c16) & 7;
    *reinterpret_cast<uint4*>(row + ((ch ^ (k & 7)) << 4)) = make_uint4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<uint4*>(row + (((ch + 1) ^ (k & 7)) << 4)) =
        make_uint4(v[4], v[5], v[6], v[7]);
  }
}

// acc[h][i] of a consumer thread: row m_lo + 64 h + 8 ((i / 2) % 2), column
// n_lo + 8 (i / 4) + i % 2 of the output
template <typename OutT>
__device__ __forceinline__ void store_tile(OutT* out, const float (&v)[2][64], int M, int n,
                                           int m_lo, int n_lo) {
  const bool pair = (n & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int m = m_lo + 64 * h + 8 * ((i >> 1) & 1);
      const int c = n_lo + 8 * (i >> 2);
      if (m >= M || c >= n) continue;
      OutT* dst = out + (size_t)m * n + c;
      if (pair) {
        if constexpr (sizeof(OutT) == 4)
          *reinterpret_cast<float2*>(dst) = make_float2(v[h][i], v[h][i + 1]);
        else
          *reinterpret_cast<uint32_t*>(dst) = pack_bf16x2(v[h][i], v[h][i + 1]);
      } else {
        Out<OutT>::one(dst, v[h][i]);
        if (c + 1 < n) Out<OutT>::one(dst + 1, v[h][i + 1]);
      }
    }
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
mxfp4_vmm_wgmma(const __grid_constant__ Maps maps, const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t bars = smem_u32(base + kBarOff);
  auto x_full = [&](int s) { return bars + 8u * s; };
  auto c_full = [&](int s) { return bars + 8u * (kXStages + s); };
  int* flag = reinterpret_cast<int*>(base + kFlagOff);

  const long long G = gridDim.x;
  const long long lo = unit_lo(blockIdx.x, p.units, G);
  const long long hi = unit_lo(blockIdx.x + 1, p.units, G);
  const int n_units = static_cast<int>(hi - lo);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kXStages; ++s) mbar_init(x_full(s), 1);
    for (int s = 0; s < kCStages; ++s) mbar_init(c_full(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // TMA copies into slots every thread is done with (the barrier at the end
  // of each stage says so), so no empty barriers: thread 0 issues the x
  // tiles, thread 128 (the other warpgroup) the code tiles, each walking
  // the units in order with its own cursor
  // walks kept in shared memory, so that they hold no registers of the
  // other 254 threads
  Walk* x_walk = reinterpret_cast<Walk*>(base + kWalkOff);
  Walk* c_walk = x_walk + 1;
  auto load_x = [&](int i) {
    if (i >= n_units) return;
    const int s = i % kXStages;
    Walk w = *x_walk;
    mbar_expect_tx(x_full(s), kXBytes);
    tma_load_2d(smem_u32(base + kXOff + s * kXBytes), &maps.x, x_full(s), w.stage * kStageK,
                w.m0);
    w.next(p);
    *x_walk = w;
  };
  auto load_codes = [&](int i) {
    if (i >= n_units || !p.tma) return;
    const int s = i % kCStages;
    Walk w = *c_walk;
    mbar_expect_tx(c_full(s), kCodeBytes + kScaleBytes);
    tma_load_2d(smem_u32(base + kCodeOff + s * kCodeBytes), codes_map(maps, w.sg), c_full(s),
                w.n0, w.stage * (kStageK / 2));
    tma_load_2d(smem_u32(base + kScaleOff + s * kScaleBytes), scales_map(maps, w.sg),
                c_full(s), w.n0, w.stage * (kStageK / 32));
    w.next(p);
    *c_walk = w;
  };

  // warp-uniform (as CUTLASS does it), so that branches on it do not stall
  // wgmma
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int wgi = warp / 4;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row_lo = wgi * 128 + (warp & 3) * 16 + (lane >> 2);   // and + 8, + 64, + 72

  // stage i's code tile -> B tile i % 2, by all 256 threads
  auto decode = [&](int i) {
    const int s = i % kCStages;
    uint8_t* cs = base + kCodeOff + s * kCodeBytes;
    uint8_t* scl = base + kScaleOff + s * kScaleBytes;
    if (p.tma) {
      mbar_wait(c_full(s), (i / kCStages) & 1);
    } else {                                      // byte copies (TMA cannot map it)
      const Walk w(p, lo + i, kBM);
      const Seg& sp = seg_ref(p, w.sg);
      const int k0 = w.stage * kStageK;
      for (int j = tid; j < kCodeBytes + kScaleBytes; j += kThreads) {
        const bool code = j < kCodeBytes;
        const int jj = code ? j : j - kCodeBytes;
        const int gr = (code ? k0 / 2 : k0 / 32) + (jj >> 7), gc = w.n0 + (jj & 127);
        const bool ok = gr < (code ? p.K / 2 : p.K / 32) && gc < sp.n;
        (code ? cs : scl)[jj] = ok ? (code ? sp.codes : sp.scales)[(size_t)gr * sp.n + gc] : 0;
      }
      consumer_sync();
    }
    uint8_t* bt = base + kBOff + (i & 1) * kBBytes;
    const uint4 sv = *reinterpret_cast<const uint4*>(scl + (tid >> 7) * kBN + 16 * (tid & 7));
    if (__any_sync(0xffffffffu, ((sv.x | sv.y | sv.z | sv.w) & 0x80808080u) != 0))
      decode_stage<true>(bt, cs, scl, tid);
    else
      decode_stage<false>(bt, cs, scl, tid);
  };
  // the decoded tiles are generic-proxy writes, read next by wgmma (the
  // async proxy); the fence goes after the wait for this stage's products,
  // where it costs nothing (before it, it waits for them)
  auto proxy_fence = [] { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); };

  if (tid == 0) {
    *x_walk = Walk(p, lo, kBM);
    *c_walk = Walk(p, lo, kBM);
  }
  __syncthreads();
  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&maps.x))
                 : "memory");
    for (int i = 0; i < kXStages - 1; ++i) load_x(i);
  }
  if (tid == 128) {
    for (int g = 0; g < p.nseg && p.tma; ++g) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(
                       codes_map(maps, g))) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(
                       scales_map(maps, g))) : "memory");
    }
    for (int i = 0; i < kCStages; ++i) load_codes(i);
  }
  float acc[2][64];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
  if (n_units > 0) decode(0);
  proxy_fence();
  consumer_sync();
  Cursor at(lo, p.stages);
  for (int i = 0; i < n_units; ++i, at.next(p.stages)) {
    const int s = i % kXStages;
    const int first = (i == 0 || at.stage == 0);
    mbar_wait(x_full(s), (i / kXStages) & 1);
    const uint32_t xa = smem_u32(base + kXOff + s * kXBytes) + wgi * 128 * 128;
    const uint64_t da0 = desc_sw128(xa, 16, 1024);
    const uint64_t da1 = desc_sw128(xa + 64 * 128, 16, 1024);
    const uint64_t db = desc_sw128(smem_u32(base + kBOff + (i & 1) * kBBytes), kStageK * 128,
                                   1024);
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kStageK / 16; ++kk) {
      wgmma_n128(acc[0], da0 + kk * 2, db + kk * 128, !(first && kk == 0));
      wgmma_n128(acc[1], da1 + kk * 2, db + kk * 128, !(first && kk == 0));
    }
    wgmma_commit();
    // while stage i's products run: the next copies, into the x slot of
    // stage i - 1 and the code slot of stage i (free in both warpgroups
    // since the last barrier), then stage i + 1's decode
    if (tid == 0) load_x(i + kXStages - 1);
    if (tid == 128) load_codes(i + kCStages);
    if (i + 1 < n_units) decode(i + 1);
    // every group is waited for in the iteration that issued it: a group
    // in flight across the loop's back edge makes ptxas serialise wgmma
    wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    proxy_fence();
    consumer_sync();                              // B tile i + 1 complete
    if (i + 1 != n_units && at.stage + 1 != p.stages) continue;

    // ---- end of a tile piece
    const int tile = at.tile;
    const long long t_lo = (long long)tile * p.stages, t_hi = t_lo + p.stages;
    const Walk w(p, t_lo, kBM);                   // (divisions: once a piece)
    const Seg& sp = seg_ref(p, w.sg);
    if (lo > t_lo || hi < t_hi) {
      // a piece: to this CTA's slot; the tile's last CTA folds the pieces
      // into acc in CTA order (its own re-read from its slot)
      float4* mine = reinterpret_cast<float4*>(
          p.ws + ((size_t)blockIdx.x * 2 + (lo < t_lo ? 1 : 0)) * kBM * kBN);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 16; ++j)
          mine[(h * 16 + j) * 256 + tid] = make_float4(acc[h][4 * j], acc[h][4 * j + 1],
                                                       acc[h][4 * j + 2], acc[h][4 * j + 3]);
      const int c_first = cta_of(t_lo, p.units, G), c_last = cta_of(t_hi - 1, p.units, G);
      __threadfence();
      consumer_sync();
      if (tid == 0) *flag = atomicAdd(p.counters + tile, 1) == c_last - c_first;
      consumer_sync();
      if (!*flag) continue;
      __threadfence();
      // in chunks of 8 float4s per contributor: 32 loads in flight beside
      // the 128 accumulators would spill
#pragma unroll
      for (int q = 0; q < 4; ++q)
        for (int c = c_first; c <= c_last; ++c) {
          const float4* part = reinterpret_cast<const float4*>(
              p.ws + ((size_t)c * 2 + (unit_lo(c, p.units, G) < t_lo ? 1 : 0)) * kBM * kBN);
          float4 o[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) o[j] = __ldcg(part + (8 * q + j) * 256 + tid);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int h = q >> 1, e = 4 * (8 * (q & 1) + j);
            if (c == c_first) {
              acc[h][e] = o[j].x; acc[h][e + 1] = o[j].y;
              acc[h][e + 2] = o[j].z; acc[h][e + 3] = o[j].w;
            } else {
              acc[h][e] += o[j].x; acc[h][e + 1] += o[j].y;
              acc[h][e + 2] += o[j].z; acc[h][e + 3] += o[j].w;
            }
          }
        }
      if (tid == 0) p.counters[tile] = 0;         // ready for the next launch
    }
    store_tile(static_cast<OutT*>(sp.out), acc, p.M, sp.n, w.m0 + row_lo,
               w.n0 + 2 * (lane & 3));
  }
}

}  // namespace wg

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

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

// a 2-D map over a row-major (rows, cols) matrix whose box is (box_c
// columns, box_r rows); out-of-bounds elements come in as zeros
cudaError_t make_map(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* ptr,
                     long long rows, long long cols, int box_c, int box_r, bool swz) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)box_c, (cuuint32_t)box_r};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        swz ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename K>
cudaError_t launch(K kernel, int smem, int grid, int threads, const Maps& maps,
                   const Params& p, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, s>>>(maps, p);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t dispatch(int variant, int nt, int grid, const Maps& maps, const Params& p,
                     cudaStream_t s) {
  if (variant == 1)
    return launch(wg::mxfp4_vmm_wgmma<OutT>, wg::kSmem, grid, wg::kThreads, maps, p, s);
  switch (nt) {
    case 1: return launch(dec::mxfp4_vmm_decode<1, OutT>, dec::Cfg<1>::kSmem, grid, dec::kThreads, maps, p, s);
    case 2: return launch(dec::mxfp4_vmm_decode<2, OutT>, dec::Cfg<2>::kSmem, grid, dec::kThreads, maps, p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x (M, K) bf16, 16-byte aligned; nseg (1..3) weights that share K, weight
// i as codes[i] (K/2, ns[i]) u8, scales[i] (K/32, ns[i]) u8, out[i] (M,
// ns[i]) f32 (out_bf16 == 0) or bf16.  variant 0: decode schedule (M <=
// 16, rows in n8 tiles: nt = 1 or 2 of them); 1: wgmma schedule.  grid:
// the CTA count (1 <= grid <= tiles x stages); ws: grid x 2 x (8 nt or 256)
// x 128 f32 scratch; counters: one int32 per tile, zero before the call and
// zero again after it.  Returns a cudaError_t (0 = ok).
int mxfp4_vmm(const void* x, int M, int K, int nseg, const void* const* codes,
              const void* const* scales, void* const* outs, const int* ns, int out_bf16,
              int variant, int nt, int grid, void* ws, void* counters, void* stream) {
  if (M < 1 || K < 32 || K % 32 != 0 || nseg < 1 || nseg > kMaxSeg || grid < 1 ||
      (variant != 0 && variant != 1) || (variant == 0 && M > 8 * nt) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Params p{};
  Maps maps{};
  const int stage_k = variant == 0 ? dec::kStageK : wg::kStageK;
  p.nseg = nseg;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.M = M;
  p.K = K;
  p.m_tiles = variant == 0 ? 1 : (M + wg::kBM - 1) / wg::kBM;
  p.stages = (K + stage_k - 1) / stage_k;
  p.ws = static_cast<float*>(ws);
  p.counters = static_cast<int*>(counters);
  p.tma = 1;
  int stripes = 0;
  for (int i = 0; i < nseg; ++i) {
    if (ns[i] < 1) return (int)cudaErrorInvalidValue;
    p.seg[i] = Seg{outs[i], static_cast<const uint8_t*>(codes[i]),
                   static_cast<const uint8_t*>(scales[i]), ns[i], stripes};
    stripes += (ns[i] + kBN - 1) / kBN;
    if (ns[i] % 16 != 0 || reinterpret_cast<uintptr_t>(codes[i]) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(scales[i]) % 16 != 0)
      p.tma = 0;
  }
  p.units = (long long)stripes * p.m_tiles * p.stages;
  if (grid > p.units) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSuccess;
  if (p.tma) {
    for (int i = 0; i < nseg && e == cudaSuccess; ++i) {
      e = make_map(&maps.codes[i], CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, codes[i], K / 2, ns[i],
                   kBN, stage_k / 2, variant == 0);
      if (e == cudaSuccess)
        e = make_map(&maps.scales[i], CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, scales[i], K / 32,
                     ns[i], kBN, stage_k / 32, false);
    }
  }
  if (e == cudaSuccess && variant == 1)
    e = make_map(&maps.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, wg::kStageK, wg::kBM,
                 true);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(out_bf16 ? dispatch<__nv_bfloat16>(variant, nt, grid, maps, p, s)
                        : dispatch<float>(variant, nt, grid, maps, p, s));
}

const char* mxfp4_vmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
