// Paged multi-query GQA decode attention with an exact accumulator, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention/paged_kernel.py::_exact_kernel (line
// 116), reached through paged_decode_attention(..., accum="exact") (line
// 150): scores and V staged in position order, one softmax over the whole
// row at the end, no online rescaling.  It also takes C > 1 queries per
// slot, which makes it the counterpart of the reference's multi-query
// oracle paged_decode_multi_attention_ref (ref.py:34), on which the
// speculative verify step is built (C = gamma + 1).
//
// For query c of slot b, at position p = start[b] + c, and query head
// hh = g * rep + i (kv head g):
//   out[b, c, hh, :] = softmax_t(q[b, c, hh] . K[t] * scale) @ V
// over the visible positions t in [lo, p] (lo = max(0, p - window + 1)
// with a window, else 0), token t of slot b living at
// pool[page_table[b, t / page], t % page, g, :]; fp8 e4m3 / int8 code pools
// carry per-token scales.
//
// The contract that makes it "exact": the order of every sum taken for one
// (slot row, query position, head) is fixed by that position alone -- not
// by B, C, n_blocks, the grid or the number of SMs.  So a verify launch of
// C = gamma + 1 queries gives, bit for bit, what C launches of one query
// would, and a row gives the same bits in any batch.  No atomics touch a
// float; positions outside a row's range never enter its sums (the masked
// tail of a rejected speculative window, dead table entries).
//
// What bounds it: it reads every live K/V byte of a slot once for all C
// queries and does ~4 * C * rep flops per K/V element pair it reads, far
// below the card's ~295 flop/byte ridge for C * rep <= 64, so device memory
// bytes bound it.
//
// bf16 q over bf16, fp8 or int8 pools at D 64 / 128 with a page of 16 or a
// multiple of 16 (exact_tc, the verify step) -- one launch, the online paged
// kernel's design (paged_decode.cu) with every choice tied to absolute
// position:
//   * one CTA of 4 warps per (absolute 256-position split, kv head, slot)
//     that the slot's range meets; warp w owns positions 16w..16w+15 of
//     each 64-token tile of the split (one page's worth), reads the page's
//     table entry itself and streams the tokens through its own 3-stage
//     cp.async ring (4 for code pools), so the loop has no block barrier;
//   * scores on the tensor cores: the C * rep query rows, padded to 16, 32
//     or 64, are the M dimension of mma.m16n8k16 (code pools: codes
//     converted to bf16 as the fragments form, exact; the K scale times
//     the score after the product); P.V likewise with P = hi + lo (the V
//     scale folded into P first);
//   * each warp keeps an f32 online softmax per query row over its slices
//     in position order; the warps are folded in warp order, the split
//     writes its (m, l, acc) per row, and the last CTA of each (slot, kv
//     head) -- an integer counter per (slot, kv head) that it resets --
//     folds each row's splits in split order (the max first, then l and acc
//     rescaled and summed left to right), divides and writes;
//   * a slice where a row sees no position gives that row NEG_INF scores,
//     so its running max, l and acc stay bit for bit as they were (the
//     rescale is exp2(0) = 1 and P is 0): a row's sums are the same whatever
//     other queries (C) or slots (B) share the launch.  The row's place in
//     the padded M tile is assumed not to change an mma's bits for that row
//     (the card check holds it: query j of C = 5 equals C = 1, bit for bit);
//   * at C * rep > 32 two CTAs share a split, each with half of the output
//     columns (each reads all of K and its half of V), so that a warp's
//     accumulators fit in registers.
// There is no score workspace and no softmax kernel: a split writes and
// reads ~10 KB of partials (C * rep 20, D 128) against 128 KB of K/V.  The
// first version (four kernels: scores into an f32 (B, KVH, C * rep, S)
// workspace, a softmax over it in place, P.V from it, a combine; every dot
// product a lane-wise sum and a fixed butterfly) read 0.1167 / 0.3895 ms at
// B 8, C 5, ctx 1024 / 4096: 4.3x / 6.1x a plain read of the same bytes
// and 1.8x / 2.1x SDPA with the per-row mask (NVIDIA H100 80GB HBM3, 700 W).
// A design with one CTA per 128-position chunk (a per-chunk softmax across
// the 4 warps, block barriers between scores, softmax and P.V) came to
// 0.057 / 0.22 ms: its warps stalled issuing the next chunk's copies, and
// a producer warp issuing them alone was no faster.
//
// Every other pairing (f32 q or pools -- the parity checks, the card's f32
// speculative streams; D 256; a page that is not a multiple of 16) keeps
// that first version, chosen before the launch (paged_kernel.py:
// variant()):
//   1. exact_scores: one CTA per (64-position chunk, kv head, slot) walks
//      the chunk's live pages, double-buffered in shared memory with
//      cp.async, and writes the scaled scores of all C * rep query rows.
//      Warps take tokens; each lane holds D/32 elements of the K row and of
//      8 query rows at a time, whose 8 butterflies interleave; code pools
//      dequantize per token as float(code) * scale[t], the plain version's
//      op sequence;
//   2. exact_softmax: one CTA per (query row, kv head, slot) takes the
//      row's max and sum of exp(s - max) -- thread i of 128 over the
//      positions t == i (mod 128) in order, then a fixed tree -- and
//      overwrites the scores with the probabilities exp(s - max) / sum;
//   3. exact_pv: one CTA per (128-position chunk, kv head, slot) stages
//      the chunk's probabilities position-major and walks its V pages;
//      thread d accumulates column d of every row in position order and
//      writes the chunk's partial sums;
//   4. exact_combine: folds each row's chunk partials in chunk order and
//      writes the output in q's dtype.
// The scores' chunk only sets the grid; the P.V chunk is part of the sum
// order, fixed at 128 absolute positions.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRows = 64;        // C * rep query rows per (slot, kv head)
constexpr int kChunkPos = 128;      // positions per P.V partial sum
constexpr int kScoreChunkPos = 64;  // positions per scores CTA (divides kChunkPos)
constexpr int kRowGroup = 8;        // score rows whose reductions interleave
constexpr int kSoftmaxThreads = 128;
constexpr float kNegInf = -1e30f;   // the reference's NEG_INF

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_float<__nv_fp8_e4m3>(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}
template <> __device__ __forceinline__ float to_float<int8_t>(int8_t x) {
  return static_cast<float>(x);
}

// 1-byte pools hold codes with per-token scales
template <typename KT> constexpr bool kQuantized = sizeof(KT) == 1;

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int N>
struct alignas(sizeof(T) * N > 16 ? 16 : sizeof(T) * N) Vec {
  T v[N];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the first visible position of a query at position p (it sees [lo, p])
__device__ __forceinline__ int row_lo(int p, int window) {
  if (window <= 0) return 0;
  const int lo = p - window + 1;
  return lo > 0 ? lo : 0;
}

// The live pages [j0, j1] of chunk `chunk` (of chunk_pos positions) for a
// slot whose C queries sit at st .. st + C - 1; j0 > j1 when the chunk
// holds no visible position.
__device__ __forceinline__ void chunk_pages(int chunk, int chunk_pos, int st, int C,
                                            int window, int page, int n_blocks, int& j0,
                                            int& j1) {
  const int ppc = chunk_pos / page;
  j0 = chunk * ppc;
  j1 = j0 + ppc - 1;
  const int first = row_lo(st, window) / page;
  if (j0 < first) j0 = first;
  int hi = (st + C - 1) / page;
  if (hi > n_blocks - 1) hi = n_blocks - 1;
  if (j1 > hi) j1 = hi;
}

// Stage one page of kv head g (K or V rows, and for code pools their
// scales) into shared memory with cp.async; one commit group.
template <typename KT, int D>
__device__ __forceinline__ void issue_page(const KT* pages, const float* scales, int phys,
                                           int g, int kvh, int page, KT* dst,
                                           float* sc_dst) {
  constexpr int kChunk = 16 / sizeof(KT);
  constexpr int kChunksPerRow = D / kChunk;
  const int tid = threadIdx.x;
  const size_t tok_stride = (size_t)kvh * D;
  const KT* src = pages + ((size_t)phys * page * kvh + g) * D;
  for (int c = tid; c < page * kChunksPerRow; c += D) {
    const int t = c / kChunksPerRow;
    const int e = (c % kChunksPerRow) * kChunk;
    cp_async16(dst + t * D + e, src + t * tok_stride + e);
  }
  if constexpr (kQuantized<KT>) {
    const size_t s0 = (size_t)phys * page * kvh + g;
    for (int t = tid; t < page; t += D) cp_async4(sc_dst + t, scales + s0 + (size_t)t * kvh);
  }
  cp_async_commit();
}

__host__ __device__ inline size_t align4(size_t words) { return (words + 3) & ~(size_t)3; }

template <typename KT>
__host__ __device__ inline size_t page_stage_bytes(int D, int page) {
  return 2 * (size_t)page * D * sizeof(KT) + (kQuantized<KT> ? 2 * (size_t)page * 4 : 0);
}

// ---------------------------------------------------------------------------
// 1. scores
// ---------------------------------------------------------------------------
// shared: q_s[R][D] f32 | kv_s[2][page][D] KT | sc_s[2][page] f32
template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(D)
exact_scores(const QT* __restrict__ q,              // (B, C, H, D)
             const KT* __restrict__ k_pages,        // (P, page, KVH, D)
             const float* __restrict__ k_scales,    // (P, page, KVH) or null
             const int* __restrict__ page_table,    // (B, n_blocks)
             const int* __restrict__ start_arr,     // (B,)
             float* __restrict__ ws_s,              // (B, KVH, R, S)
             int C, int kvh, int rep, int page, int n_blocks, int window, float scale) {
  constexpr int kWarps = D / 32;
  constexpr int kLane = D / 32;
  const int chunk = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int st = start_arr[b];
  int j0, j1;
  chunk_pages(chunk, kScoreChunkPos, st, C, window, page, n_blocks, j0, j1);
  if (j0 > j1) return;                          // the whole CTA: no barrier yet

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = C * rep;
  const int h = kvh * rep;
  const size_t S = (size_t)n_blocks * page;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  KT* kv_s = reinterpret_cast<KT*>(q_s + align4((size_t)R * D));
  const int page_elems = page * D;
  float* sc_s = reinterpret_cast<float*>(kv_s + 2 * (size_t)page_elems);

  const int* row_table = page_table + (size_t)b * n_blocks;
  issue_page<KT, D>(k_pages, k_scales, row_table[j0], g, kvh, page, kv_s, sc_s);
  for (int i = tid; i < R * D; i += D) {        // row r = c * rep + ri
    const int r = i / D, d = i % D;
    const int c = r / rep, ri = r % rep;
    q_s[i] = to_float(q[(((size_t)b * C + c) * h + (size_t)g * rep + ri) * D + d]);
  }
  float* out_rows = ws_s + ((size_t)b * kvh + g) * R * S;

  for (int j = j0; j <= j1; ++j) {
    const int buf = (j - j0) & 1;
    if (j < j1) {
      issue_page<KT, D>(k_pages, k_scales, row_table[j + 1], g, kvh, page,
                        kv_s + (size_t)(buf ^ 1) * page_elems, sc_s + (buf ^ 1) * page);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const KT* k_s = kv_s + (size_t)buf * page_elems;
    const float* ksc = sc_s + buf * page;
    for (int t = warp; t < page; t += kWarps) {
      const Vec<KT, kLane> kv =
          *reinterpret_cast<const Vec<KT, kLane>*>(k_s + t * D + lane * kLane);
      float kf[kLane];
#pragma unroll
      for (int e = 0; e < kLane; ++e) kf[e] = to_float(kv.v[e]);
      if constexpr (kQuantized<KT>) {
        const float sk = ksc[t];
#pragma unroll
        for (int e = 0; e < kLane; ++e) kf[e] *= sk;
      }
      const int idx = j * page + t;
      for (int r0 = 0; r0 < R; r0 += kRowGroup) {
        float part[kRowGroup];
#pragma unroll
        for (int i = 0; i < kRowGroup; ++i) {
          part[i] = 0.f;
          if (r0 + i < R) {
            const Vec<float, kLane> qr = *reinterpret_cast<const Vec<float, kLane>*>(
                q_s + (r0 + i) * D + lane * kLane);
#pragma unroll
            for (int e = 0; e < kLane; ++e) part[i] += qr.v[e] * kf[e];
          }
        }
        // an xor butterfly over the warp, 8 rows at a time; every lane ends
        // with every row's sum, the same bits in each (each step adds a
        // pair, and a + b == b + a)
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
          for (int i = 0; i < kRowGroup; ++i)
            part[i] += __shfl_xor_sync(0xffffffffu, part[i], o);
        }
        float val = part[0];                    // lane i writes row r0 + i
#pragma unroll
        for (int i = 1; i < kRowGroup; ++i)
          if (lane == i) val = part[i];
        const int r = r0 + lane;
        if (lane < kRowGroup && r < R) {
          const int p = st + r / rep;
          if (idx <= p && idx >= row_lo(p, window)) out_rows[(size_t)r * S + idx] = val * scale;
        }
      }
    }
    __syncthreads();                            // buf is refilled next round
  }
}

// ---------------------------------------------------------------------------
// 2. softmax over each row's visible positions, in place
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kSoftmaxThreads)
exact_softmax(float* __restrict__ ws_s, const int* __restrict__ start_arr, int C, int kvh,
              int rep, int n_blocks, int page, int window) {
  constexpr int T = kSoftmaxThreads;
  __shared__ float red[T];
  const int r = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int R = C * rep;
  const size_t S = (size_t)n_blocks * page;
  const int p = start_arr[b] + r / rep;
  const int lo = row_lo(p, window);
  float* row = ws_s + (((size_t)b * kvh + g) * R + r) * S;
  // thread tid owns the positions t == tid (mod T) of [lo, p], in order
  const int first = lo + ((tid - lo % T) + T) % T;

  float mx = kNegInf;
  for (int t = first; t <= p; t += T) mx = fmaxf(mx, row[t]);
  red[tid] = mx;
  __syncthreads();
  for (int s = T / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] = fmaxf(red[tid], red[tid + s]);
    __syncthreads();
  }
  mx = red[0];
  __syncthreads();
  float sum = 0.f;
  for (int t = first; t <= p; t += T) sum += expf(row[t] - mx);
  red[tid] = sum;
  __syncthreads();
  for (int s = T / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  const float l = red[0];
  for (int t = first; t <= p; t += T) row[t] = expf(row[t] - mx) / l;
}

// ---------------------------------------------------------------------------
// 3. P.V partial sums per chunk
// ---------------------------------------------------------------------------
// shared: p_s[kChunkPos][kRows + 4] f32 (position-major; the pad spreads
// the staging writes over the banks and keeps rows 16-byte aligned) |
// kv_s[2][page][D] KT | sc_s[2][page] f32
template <int kRows> constexpr int kPStride = kRows + 4;

template <typename KT, int D, int kRows>
__global__ void __launch_bounds__(D)
exact_pv(const KT* __restrict__ v_pages, const float* __restrict__ v_scales,
         const int* __restrict__ page_table, const int* __restrict__ start_arr,
         const float* __restrict__ ws_s,         // (B, KVH, R, S) probabilities
         float* __restrict__ ws_pv,              // (B, KVH, n_chunks, R, D)
         int C, int kvh, int rep, int page, int n_blocks, int n_chunks, int window) {
  constexpr int kStride = kPStride<kRows>;
  const int chunk = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int st = start_arr[b];
  int j0, j1;
  chunk_pages(chunk, kChunkPos, st, C, window, page, n_blocks, j0, j1);
  if (j0 > j1) return;

  const int tid = threadIdx.x;
  const int R = C * rep;
  const size_t S = (size_t)n_blocks * page;
  extern __shared__ __align__(16) unsigned char smem[];
  float* p_s = reinterpret_cast<float*>(smem);
  KT* kv_s = reinterpret_cast<KT*>(p_s + (size_t)kChunkPos * kStride);
  const int page_elems = page * D;
  float* sc_s = reinterpret_cast<float*>(kv_s + 2 * (size_t)page_elems);

  const int* row_table = page_table + (size_t)b * n_blocks;
  issue_page<KT, D>(v_pages, v_scales, row_table[j0], g, kvh, page, kv_s, sc_s);
  // stage the chunk's probabilities, 0 outside each row's visible range
  // (and for the pad rows up to kRows); rows read coalesced
  const int base = j0 * page;
  const int npos = (j1 - j0 + 1) * page;
  const float* rows = ws_s + ((size_t)b * kvh + g) * R * S;
  for (int i = tid; i < kRows * npos; i += D) {
    const int r = i / npos, tl = i % npos;
    const int idx = base + tl;
    const int p = st + r / rep;
    const bool ok = r < R && idx <= p && idx >= row_lo(p, window);
    p_s[tl * kStride + r] = ok ? rows[(size_t)r * S + idx] : 0.f;
  }
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;

  for (int j = j0; j <= j1; ++j) {
    const int buf = (j - j0) & 1;
    if (j < j1) {
      issue_page<KT, D>(v_pages, v_scales, row_table[j + 1], g, kvh, page,
                        kv_s + (size_t)(buf ^ 1) * page_elems, sc_s + (buf ^ 1) * page);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const KT* v_s = kv_s + (size_t)buf * page_elems;
    const float* vsc = sc_s + buf * page;
    const float* pj = p_s + (size_t)(j - j0) * page * kStride;
    for (int t = 0; t < page; ++t) {
      float vv = to_float(v_s[t * D + tid]);
      if constexpr (kQuantized<KT>) vv *= vsc[t];
      // a position outside a row's range has p = 0 and adds +-0, which
      // leaves the sum's bits as they were (V entries are finite)
#pragma unroll
      for (int r = 0; r < kRows; r += 4) {
        const Vec<float, 4> p4 = *reinterpret_cast<const Vec<float, 4>*>(pj + t * kStride + r);
        acc[r] += p4.v[0] * vv;
        acc[r + 1] += p4.v[1] * vv;
        acc[r + 2] += p4.v[2] * vv;
        acc[r + 3] += p4.v[3] * vv;
      }
    }
    __syncthreads();
  }
  float* dst = ws_pv + (((size_t)b * kvh + g) * n_chunks + chunk) * R * D;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    if (r < R) dst[(size_t)r * D + tid] = acc[r];
}

// ---------------------------------------------------------------------------
// 4. fold the chunks in order
// ---------------------------------------------------------------------------
template <typename QT, int D>
__global__ void __launch_bounds__(D)
exact_combine(const float* __restrict__ ws_pv, const int* __restrict__ start_arr,
              QT* __restrict__ out, int C, int kvh, int rep, int n_chunks, int window) {
  const int h = kvh * rep;
  const size_t row = blockIdx.x;               // ((b * C + c) * H + hh)
  const int hh = row % h;
  const int c = (row / h) % C;
  const int b = row / ((size_t)h * C);
  const int g = hh / rep, r = c * rep + hh % rep;
  const int R = C * rep;
  const int d = threadIdx.x;
  const int p = start_arr[b] + c;
  int c1 = p / kChunkPos;
  if (c1 > n_chunks - 1) c1 = n_chunks - 1;
  const float* src = ws_pv + ((size_t)b * kvh + g) * n_chunks * R * D;
  float a = 0.f;
  for (int ch = row_lo(p, window) / kChunkPos; ch <= c1; ++ch)
    a += src[((size_t)ch * R + r) * D + d];
  out[row * D + d] = from_float<QT>(a);
}

struct Args {
  const void *q, *k, *v;
  const float *ks, *vs;
  const int *table, *start;
  void* out;
  float *ws_s, *ws_pv;
  int B, C, kvh, rep, page, n_blocks, n_chunks, n_score_chunks, window;
  float scale;
  cudaStream_t stream;
};

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename KT, int D, int kRows>
cudaError_t launch_pv(const Args& a) {
  auto pv = exact_pv<KT, D, kRows>;
  const size_t smem = (size_t)kChunkPos * kPStride<kRows> * 4 + page_stage_bytes<KT>(D, a.page);
  cudaError_t e = set_smem(pv, smem);
  if (e != cudaSuccess) return e;
  pv<<<dim3(a.n_chunks, a.kvh, a.B), D, smem, a.stream>>>(
      static_cast<const KT*>(a.v), a.vs, a.table, a.start, a.ws_s, a.ws_pv, a.C, a.kvh,
      a.rep, a.page, a.n_blocks, a.n_chunks, a.window);
  return cudaGetLastError();
}

template <typename QT, typename KT, int D>
cudaError_t launch(const Args& a) {
  const int R = a.C * a.rep;
  const dim3 grid(a.n_score_chunks, a.kvh, a.B);
  auto scores = exact_scores<QT, KT, D>;
  const size_t smem_s = align4((size_t)R * D) * 4 + page_stage_bytes<KT>(D, a.page);
  cudaError_t e = set_smem(scores, smem_s);
  if (e != cudaSuccess) return e;
  scores<<<grid, D, smem_s, a.stream>>>(
      static_cast<const QT*>(a.q), static_cast<const KT*>(a.k), a.ks, a.table, a.start,
      a.ws_s, a.C, a.kvh, a.rep, a.page, a.n_blocks, a.window, a.scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  exact_softmax<<<dim3(R, a.kvh, a.B), kSoftmaxThreads, 0, a.stream>>>(
      a.ws_s, a.start, a.C, a.kvh, a.rep, a.n_blocks, a.page, a.window);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  e = R <= 8 ? launch_pv<KT, D, 8>(a)
      : R <= 16 ? launch_pv<KT, D, 16>(a)
      : R <= 32 ? launch_pv<KT, D, 32>(a)
                : launch_pv<KT, D, 64>(a);
  if (e != cudaSuccess) return e;

  exact_combine<QT, D><<<a.B * a.C * a.kvh * a.rep, D, 0, a.stream>>>(
      a.ws_pv, a.start, static_cast<QT*>(a.out), a.C, a.kvh, a.rep, a.n_chunks, a.window);
  return cudaGetLastError();
}

template <typename QT, typename KT>
cudaError_t dispatch_dim(int D, const Args& a) {
  switch (D) {
    case 64: return launch<QT, KT, 64>(a);
    case 128: return launch<QT, KT, 128>(a);
    case 256: return launch<QT, KT, 256>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename QT>
cudaError_t dispatch_kv(int kv_dtype, int D, const Args& a) {
  switch (kv_dtype) {
    case 0: return dispatch_dim<QT, float>(D, a);
    case 1: return dispatch_dim<QT, __nv_bfloat16>(D, a);
    case 2: return dispatch_dim<QT, __nv_fp8_e4m3>(D, a);
    case 3: return dispatch_dim<QT, int8_t>(D, a);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16 q over bf16, fp8 or int8 pools: tensor cores, one launch
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kTile = 64;          // positions per tile: 16 per warp
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kSplitPos = 256;     // positions per split (a partial of the sum order)
constexpr unsigned kFull = 0xffffffffu;

// kMT: 16-row M tiles of the C * rep query rows (1, 2 or 4); kDS: CTAs that
// share a split's output columns (2 at kMT 4, so a warp's accumulators fit
// in registers; each of them reads all of K and its half of V)
template <typename KT, int D, int kMT, int kDS>
struct Cfg {
  static constexpr bool kCodes = sizeof(KT) == 1;
  static constexpr int kRows = 16 * kMT;
  static constexpr int kDV = D / kDS;                     // output columns of a CTA
  static constexpr int kStages = kCodes ? 4 : 3;          // cp.async ring depth
  static constexpr int kQRow = 2 * D + 16;                // padded bf16 q row, bytes
  // a warp's K and V rows, bytes: bf16 rows padded for ldmatrix; code rows
  // padded so that the direct 16-byte (K) and kDV/8-byte (V) loads of a
  // warp fall on distinct banks
  static constexpr int kKRow = kCodes ? (D == 128 ? 192 : 64) : 2 * D + 16;
  static constexpr int kVRow = kCodes ? (kDV <= 64 ? 80 : 144) : 2 * kDV + 16;
  static constexpr int kKSlice = 16 * kKRow;
  static constexpr int kVSlice = 16 * kVRow;
  static constexpr int kScBytes = kCodes ? 2 * 16 * 4 : 0;  // K, V scales of 16 tokens
  static constexpr int kWarpStage = kKSlice + kVSlice + kScBytes;
  static constexpr int kStageBytes = kWarps * kWarpStage;
  static constexpr int kQBytes = kRows * kQRow;
  static constexpr int kSmem = kQBytes + kStages * kStageBytes;
  static constexpr int kAccRow = kDV + 8;                 // fold rows, floats
  // the warps' (m, l, acc) for the in-CTA fold, over q and the idle ring
  static_assert(kWarps * kRows * (2 + kAccRow) * 4 <= kSmem, "fold area");
  static_assert(kWarpStage % 16 == 0 && kQBytes % 16 == 0, "16-byte aligned stages");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// cp-size bytes, or zeros when src_bytes is 0 (nothing is read)
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src,
                                                 int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4_zfill(uint32_t dst, const void* src,
                                                int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// x = hi + lo with hi = bf16(x), lo = bf16(x - hi): 16 bits of x's mantissa
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}
// two floats that are bf16 values -> bf16x2 (their high halves: exact)
__device__ __forceinline__ uint32_t pack_exact(float x0, float x1) {
  return __byte_perm(__float_as_uint(x0), __float_as_uint(x1), 0x7632);
}
// the two codes in the low 16 bits of `pair` (first in the low byte) as
// bf16x2: exact, every e4m3 and int8 value is a bf16 value
template <typename KT> __device__ __forceinline__ uint32_t codes_bf16x2(uint32_t pair);
template <> __device__ __forceinline__ uint32_t codes_bf16x2<int8_t>(uint32_t pair) {
  // 2^23 + (code + 128) as f32 bits, minus 2^23 + 128
  const uint32_t u = pair ^ 0x8080u;
  const float x0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  const float x1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  return pack_exact(x0, x1);
}
template <> __device__ __forceinline__ uint32_t codes_bf16x2<__nv_fp8_e4m3>(uint32_t pair) {
  const __half2_raw h2 =
      __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(pair & 0xFFFFu), __NV_E4M3);
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h2));
  return pack_exact(f.x, f.y);
}
// N 32-bit words from shared memory in one 4-, 8- or 16-byte load
template <int N>
struct Words {
  uint32_t w[N];
  __device__ __forceinline__ void load(const unsigned char* p) {
    static_assert(N == 1 || N == 2 || N == 4, "4, 8 or 16 bytes");
    if constexpr (N == 4) {
      const uint4 x = *reinterpret_cast<const uint4*>(p);
      w[0] = x.x, w[1] = x.y, w[2] = x.z, w[3] = x.w;
    } else if constexpr (N == 2) {
      const uint2 x = *reinterpret_cast<const uint2*>(p);
      w[0] = x.x, w[1] = x.y;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    }
  }
};
// byte k of a and byte k of b, as the low 16 bits
__device__ __forceinline__ uint32_t byte_pair(uint32_t a, uint32_t b, int k) {
  return __byte_perm(a, b, k | ((4 + k) << 4));
}
// Code pools: the physical head-dim index of logical column L of the score
// product (a thread's 16-byte K load at byte 64h + 16quad serves k-steps
// 4h .. 4h+3); q is stored in shared memory in this order.
__device__ __forceinline__ int code_dim(int L) {
  const int kk = L >> 4, half = (L >> 3) & 1, qd = (L >> 1) & 3;
  return 64 * (kk >> 2) + 16 * qd + 4 * (kk & 3) + 2 * half + (L & 1);
}

// One CTA per (256-position split, column share, kv head g, slot b): 4
// warps walk the split's live 64-token tiles, warp w owning positions
// 16w..16w+15 of each tile (one page's worth: it reads the table entry,
// loads, scores and folds them itself, no block barrier in the loop), each
// warp an f32 online softmax per query row.  Every choice is fixed by
// absolute position: the split, the warp, the slice order; a slice where a
// row sees nothing leaves that row's state bit for bit as it was (its
// scores are NEG_INF, so the rescale is exp2(0) = 1 and P is 0), so a row
// gets the same bits whatever other rows (C) or slots (B) share the launch.
template <typename KT, int D, int kMT, int kDS>
__global__ void __launch_bounds__(kThreads, 2)
exact_tc(const __nv_bfloat16* __restrict__ q,      // (B, C, H, D)
         const KT* __restrict__ k_pages,           // (P, page, KVH, D)
         const KT* __restrict__ v_pages,
         const float* __restrict__ k_scales,       // (P, page, KVH) or null
         const float* __restrict__ v_scales,
         const int* __restrict__ page_table,       // (B, n_blocks)
         const int* __restrict__ start_arr,        // (B,)
         __nv_bfloat16* __restrict__ out,          // (B, C, H, D)
         float* __restrict__ ws_pv,                // (B, KVH, n_splits, R, D)
         float* __restrict__ ws_ml,                // (B, KVH, n_splits, R, 2)
         int* __restrict__ counters,               // (>= B * KVH,), zero between calls
         int C, int kvh, int rep, int page, int n_blocks, int window, float scale_log2) {
  using G = Cfg<KT, D, kMT, kDS>;
  constexpr bool kCodes = G::kCodes;
  constexpr int kRows = G::kRows;
  constexpr int kDV = G::kDV;
  constexpr int kTilesPerSplit = kSplitPos / kTile;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t q_s = smem_u32(smem);
  const uint32_t ring = q_s + G::kQBytes;

  const int split = blockIdx.x / kDS, dh = blockIdx.x % kDS;
  const int n_splits = gridDim.x / kDS;
  const int g = blockIdx.y, b = blockIdx.z;
  const int bg = b * kvh + g;
  const int R = C * rep;
  const int d0 = dh * kDV;                         // this CTA's output columns
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, quad = lane & 3;

  // the slot's range [lo_min, hi_max] (the first query's window start, the
  // last query, clipped to the table) and this split's live tiles [j0, j1)
  const int st = start_arr[b];
  const int cap = n_blocks * page - 1;
  const int hi_max = min(st + C - 1, cap);
  const int lo_min = row_lo(st, window);
  const int j0 = max(split * kTilesPerSplit, lo_min / kTile);
  const int j1 = min((split + 1) * kTilesPerSplit, hi_max / kTile + 1);
  if (j0 >= j1) return;                            // no tile: not counted in the fold
  // every row sees [lo_last, p_first] (the last query's window start, the
  // first query): a slice inside it needs no mask
  const int p_first = min(st, cap), lo_last = row_lo(st + C - 1, window);

  // my rows 16 mt + gq + 8 hh: the last and first positions they see
  int row_p[kMT][2], row_lo_[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 16 * mt + gq + 8 * hh;
      row_p[mt][hh] = r < R ? min(st + r / rep, cap) : -1;
      row_lo_[mt][hh] = r < R ? row_lo(st + r / rep, window) : 0;
    }

  const int* row_table = page_table + (size_t)b * n_blocks;
  const uint32_t my_k = ring + warp * G::kWarpStage;     // + stage * kStageBytes
  const uint32_t my_v = my_k + G::kKSlice;
  const uint32_t my_sc = my_v + G::kVSlice;               // code pools: K, V scales
  auto live_slice = [&](int t0) { return t0 <= hi_max && t0 + 15 >= lo_min; };
  // lane i holds the table entry of this warp's slice of tile j0 + i (a
  // split has at most kTilesPerSplit <= 32 tiles)
  int tbl = 0;
  {
    const int t0 = (j0 + lane) * kTile + warp * 16;
    if (j0 + lane < j1 && live_slice(t0)) tbl = __ldg(row_table + t0 / page);
  }
  auto issue = [&](int j, int stage) {   // always one commit group
    if (j < j1) {
      const int phys = __shfl_sync(kFull, tbl, j - j0);
      const int t0 = j * kTile + warp * 16;
      if (live_slice(t0)) {
        // token row (slot token t0 + r, kv head g) of the pools: base + r * kvh
        const size_t base = ((size_t)phys * page + t0 % page) * kvh + g;
        const uint32_t ks = my_k + stage * G::kStageBytes;
        const uint32_t vs = my_v + stage * G::kStageBytes;
        constexpr int kPer = 16 / sizeof(KT);           // elements per 16 bytes
        constexpr int kKChunks = D / kPer;              // 16-byte pieces of a K row
        constexpr int kVChunks = kDV / kPer;            // ... of my share of a V row
#pragma unroll
        for (int c = lane; c < 16 * kKChunks; c += 32) {
          const int r = c / kKChunks, e = (c % kKChunks) * kPer;
          const bool live = t0 + r >= lo_min && t0 + r <= hi_max;
          const size_t off = live ? (base + (size_t)r * kvh) * D + e : 0;
          cp_async16_zfill(ks + r * G::kKRow + e * sizeof(KT), k_pages + off, live ? 16 : 0);
        }
#pragma unroll
        for (int c = lane; c < 16 * kVChunks; c += 32) {
          const int r = c / kVChunks, e = (c % kVChunks) * kPer;
          const bool live = t0 + r >= lo_min && t0 + r <= hi_max;
          const size_t off = live ? (base + (size_t)r * kvh) * D + d0 + e : 0;
          cp_async16_zfill(vs + r * G::kVRow + e * sizeof(KT), v_pages + off, live ? 16 : 0);
        }
        if constexpr (kCodes) {          // lanes 0-15: K scales, 16-31: V scales
          const int r = lane & 15;
          const bool live = t0 + r >= lo_min && t0 + r <= hi_max;
          const float* src = (lane < 16 ? k_scales : v_scales) + (live ? base + (size_t)r * kvh : 0);
          cp_async4_zfill(my_sc + stage * G::kStageBytes + lane * 4, src, live ? 4 : 0);
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
#pragma unroll
  for (int s = 0; s < G::kStages - 1; ++s) issue(j0 + s, s);
  // while they land: q rows r = c * rep + i of kv head g, zero-padded to
  // kRows, 8 columns a load (code pools: in code_dim order, 4 pairs)
  for (int i = tid; i < kRows * (D / 8); i += kThreads) {
    const int r = i / (D / 8), col = (i % (D / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < R) {
      const __nv_bfloat16* qr =
          q + (((size_t)b * C + r / rep) * kvh * rep + (size_t)g * rep + r % rep) * D;
      if constexpr (!kCodes) {
        val = *reinterpret_cast<const uint4*>(qr + col);
      } else {
        const uint32_t* pr = reinterpret_cast<const uint32_t*>(qr + code_dim(col));
        val = make_uint4(pr[0], pr[8], pr[16], pr[24]);   // head dims +0, +16, +32, +48
      }
    }
    *reinterpret_cast<uint4*>(smem + r * G::kQRow + 2 * col) = val;
  }
  __syncthreads();                   // q is in shared memory

  float o[kMT][kDV / 8][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int dt = 0; dt < kDV / 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][dt][e] = 0.f;
  float m_r[kMT][2], l_r[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) m_r[mt][hh] = kNegInf, l_r[mt][hh] = 0.f;
  // ldmatrix row addresses: A (q) matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15);
  // bf16 K's B matrices (tokens 0-7 | 8-15) x (d 0-7 | 8-15); V's, transposed
  const int mi = lane >> 3;
  const uint32_t qa_addr = q_s + ((lane & 7) + (mi & 1) * 8) * G::kQRow + (mi >> 1) * 16;
  const uint32_t kb_off = ((lane & 7) + (mi >> 1) * 8) * G::kKRow + (mi & 1) * 16;
  const uint32_t vb_off = ((lane & 7) + (mi & 1) * 8) * G::kVRow + (mi >> 1) * 16;

  for (int j = j0; j < j1; ++j) {
    const int stage = (j - j0) % G::kStages;
    issue(j + G::kStages - 1, (j - j0 + G::kStages - 1) % G::kStages);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(G::kStages - 1));
    __syncwarp();
    const int t0 = j * kTile + warp * 16;
    if (live_slice(t0)) {              // warp-uniform
      const uint32_t ks = my_k + stage * G::kStageBytes;
      const uint32_t vs = my_v + stage * G::kStageBytes;
      const unsigned char* ks_p = smem + (ks - q_s);
      const unsigned char* vs_p = smem + (vs - q_s);
      const float* sc_p =
          reinterpret_cast<const float*>(smem + (my_sc + stage * G::kStageBytes - q_s));

      // scores of kRows query rows x this warp's 16 tokens (column n of
      // block nb is token 8nb + n), exact products of bf16 in f32
      float sc[kMT][2][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[mt][0][e] = sc[mt][1][e] = 0.f;
      if constexpr (!kCodes) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t kb[4];
          ldmatrix_x4(kb, ks + kb_off + kk * 32);
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            uint32_t a[4];
            ldmatrix_x4(a, qa_addr + mt * 16 * G::kQRow + kk * 32);
            mma_bf16(sc[mt][0], a, kb[0], kb[1]);
            mma_bf16(sc[mt][1], a, kb[2], kb[3]);
          }
        }
      } else {
#pragma unroll
        for (int h = 0; h < D / 64; ++h) {
          const uint4 w0 = *reinterpret_cast<const uint4*>(ks_p + gq * G::kKRow + 64 * h + 16 * quad);
          const uint4 w1 =
              *reinterpret_cast<const uint4*>(ks_p + (8 + gq) * G::kKRow + 64 * h + 16 * quad);
          const uint32_t x0[4] = {w0.x, w0.y, w0.z, w0.w};
          const uint32_t x1[4] = {w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const uint32_t b00 = codes_bf16x2<KT>(x0[s]), b01 = codes_bf16x2<KT>(x0[s] >> 16);
            const uint32_t b10 = codes_bf16x2<KT>(x1[s]), b11 = codes_bf16x2<KT>(x1[s] >> 16);
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt) {
              uint32_t a[4];
              ldmatrix_x4(a, qa_addr + mt * 16 * G::kQRow + (4 * h + s) * 32);
              mma_bf16(sc[mt][0], a, b00, b01);
              mma_bf16(sc[mt][1], a, b10, b11);
            }
          }
        }
      }
      // scaled to the log2 domain (code pools: times the token's K scale);
      // NEG_INF where the row does not see the token
      const bool edge = t0 < lo_last || t0 + 15 > p_first;
      float f[2][2], vsc[2][2];        // my tokens' factors and V scales
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        f[nb][0] = f[nb][1] = scale_log2;
        if constexpr (kCodes) {
          const float2 k2 = *reinterpret_cast<const float2*>(sc_p + nb * 8 + 2 * quad);
          const float2 v2 = *reinterpret_cast<const float2*>(sc_p + 16 + nb * 8 + 2 * quad);
          f[nb][0] *= k2.x;
          f[nb][1] *= k2.y;
          vsc[nb][0] = v2.x;
          vsc[nb][1] = v2.y;
        }
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& x = sc[mt][nb][e];
            x *= f[nb][e & 1];
            if (edge) {
              const int t = t0 + nb * 8 + 2 * quad + (e & 1);
              if (t < row_lo_[mt][e >> 1] || t > row_p[mt][e >> 1]) x = kNegInf;
            }
          }
      // online softmax per row
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float mx = fmaxf(fmaxf(sc[mt][0][2 * hh], sc[mt][0][2 * hh + 1]),
                           fmaxf(sc[mt][1][2 * hh], sc[mt][1][2 * hh + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
          const float m_new = fmaxf(m_r[mt][hh], mx);
          const float corr = exp2f(m_r[mt][hh] - m_new);
          float sum = 0.f;
#pragma unroll
          for (int nb = 0; nb < 2; ++nb)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& x = sc[mt][nb][2 * hh + e];
              x = x == kNegInf ? 0.f : exp2f(x - m_new);
              sum += x;
            }
          sum += __shfl_xor_sync(kFull, sum, 1);
          sum += __shfl_xor_sync(kFull, sum, 2);
          l_r[mt][hh] = l_r[mt][hh] * corr + sum;
          m_r[mt][hh] = m_new;
#pragma unroll
          for (int dt = 0; dt < kDV / 8; ++dt) {
            o[mt][dt][2 * hh] *= corr;
            o[mt][dt][2 * hh + 1] *= corr;
          }
        }
      // O += P V with P = hi + lo (two bf16 mma; code pools: P times the
      // token's V scale first): the score accumulators are the A fragment
      uint32_t ph[kMT][4], pl[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        if constexpr (kCodes) {
#pragma unroll
          for (int nb = 0; nb < 2; ++nb)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[mt][nb][e] *= vsc[nb][e & 1];
        }
        split_bf16x2(sc[mt][0][0], sc[mt][0][1], ph[mt][0], pl[mt][0]);
        split_bf16x2(sc[mt][0][2], sc[mt][0][3], ph[mt][1], pl[mt][1]);
        split_bf16x2(sc[mt][1][0], sc[mt][1][1], ph[mt][2], pl[mt][2]);
        split_bf16x2(sc[mt][1][2], sc[mt][1][3], ph[mt][3], pl[mt][3]);
      }
      if constexpr (!kCodes) {
#pragma unroll
        for (int dt = 0; dt < kDV / 8; dt += 2) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, vs + vb_off + dt * 16);
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            mma_bf16(o[mt][dt], ph[mt], vb[0], vb[1]);
            mma_bf16(o[mt][dt], pl[mt], vb[0], vb[1]);
            mma_bf16(o[mt][dt + 1], ph[mt], vb[2], vb[3]);
            mma_bf16(o[mt][dt + 1], pl[mt], vb[2], vb[3]);
          }
        }
      } else {
        // V's B fragments straight from the codes: tokens 2quad, 2quad + 1
        // (b0) and 2quad + 8, 2quad + 9 (b1); output column n of block dt is
        // head dim d0 + (kDV / 8) n + dt, so thread gq's codes are the
        // kDV/8 bytes of each of its 4 tokens at byte (kDV / 8) gq
        const unsigned char* vrow = vs_p + (kDV / 8) * gq;
        Words<kDV / 32> va, vb2, vc, vd;
        va.load(vrow + (2 * quad) * G::kVRow);
        vb2.load(vrow + (2 * quad + 1) * G::kVRow);
        vc.load(vrow + (2 * quad + 8) * G::kVRow);
        vd.load(vrow + (2 * quad + 9) * G::kVRow);
#pragma unroll
        for (int dt = 0; dt < kDV / 8; ++dt) {
          const int w = dt >> 2, k = dt & 3;
          const uint32_t b0 = codes_bf16x2<KT>(byte_pair(va.w[w], vb2.w[w], k));
          const uint32_t b1 = codes_bf16x2<KT>(byte_pair(vc.w[w], vd.w[w], k));
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            mma_bf16(o[mt][dt], ph[mt], b0, b1);
            mma_bf16(o[mt][dt], pl[mt], b0, b1);
          }
        }
      }
    }
    __syncwarp();                    // the stage is refilled next iteration
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();                   // q and the ring are idle: fold area

  // fold the 4 warps in warp order: (m, l) per row, then acc
  float* ml_s = reinterpret_cast<float*>(smem);                // [warp][kRows][2]
  float* acc_s = ml_s + kWarps * kRows * 2;                    // [warp][kRows][kAccRow]
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 16 * mt + gq + 8 * hh;
      if (quad == 0) {
        ml_s[(warp * kRows + r) * 2] = m_r[mt][hh];
        ml_s[(warp * kRows + r) * 2 + 1] = l_r[mt][hh];
      }
      float* row = acc_s + (warp * kRows + r) * G::kAccRow;
#pragma unroll
      for (int dt = 0; dt < kDV / 8; ++dt) {
        if constexpr (!kCodes) {
          *reinterpret_cast<float2*>(row + dt * 8 + 2 * quad) =
              make_float2(o[mt][dt][2 * hh], o[mt][dt][2 * hh + 1]);
        } else {
          row[(kDV / 8) * (2 * quad) + dt] = o[mt][dt][2 * hh];
          row[(kDV / 8) * (2 * quad + 1) + dt] = o[mt][dt][2 * hh + 1];
        }
      }
    }
  __syncthreads();
  const size_t part = (size_t)bg * n_splits + split;
  for (int i = tid; i < R * kDV; i += kThreads) {
    const int r = i / kDV, d = i % kDV;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, ml_s[(w * kRows + r) * 2]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp2f(ml_s[(w * kRows + r) * 2] - mx);
      l += ml_s[(w * kRows + r) * 2 + 1] * wt;
      a += acc_s[(w * kRows + r) * G::kAccRow + d] * wt;
    }
    ws_pv[(part * R + r) * D + d0 + d] = a;
    if (d == 0) {                      // the kDS CTAs of a split write the same
      ws_ml[(part * R + r) * 2] = mx;
      ws_ml[(part * R + r) * 2 + 1] = l;
    }
  }

  // the last CTA of (b, g) to finish folds each row's splits in split order
  __threadfence();
  __syncthreads();
  __shared__ int is_last;
  const int s_first = lo_min / kSplitPos, s_last = hi_max / kSplitPos;
  if (tid == 0)                        // one arrival per CTA with a tile
    is_last = atomicAdd(counters + bg, 1) == (s_last - s_first + 1) * kDS - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // per row: its max over its splits, then l and each split's weight
  // exp2(m_s - m) (kept in shared memory, idle now, when it fits), in order
  const size_t part0 = (size_t)bg * n_splits;
  const int ns = s_last - s_first + 1;
  float* m_s = reinterpret_cast<float*>(smem);
  float* l_s = m_s + kRows;
  float* w_s = l_s + kRows;                        // [R][ns]
  const bool w_fits = (2 * kRows + R * ns) * 4 <= G::kSmem;
  for (int r = tid; r < R; r += kThreads) {
    const int c = r / rep;
    const int s0 = row_lo(st + c, window) / kSplitPos, s1 = min(st + c, cap) / kSplitPos;
    const float* ml = ws_ml + (part0 * R + r) * 2;
    float mx = kNegInf;
#pragma unroll 8
    for (int sp = s0; sp <= s1; ++sp) mx = fmaxf(mx, __ldcg(ml + (size_t)sp * R * 2));
    float l = 0.f;
#pragma unroll 8
    for (int sp = s0; sp <= s1; ++sp) {
      const float2 x = __ldcg(reinterpret_cast<const float2*>(ml + (size_t)sp * R * 2));
      const float wt = exp2f(x.x - mx);
      l += x.y * wt;
      if (w_fits) w_s[r * ns + sp - s_first] = wt;
    }
    m_s[r] = mx;
    l_s[r] = l;
  }
  __syncthreads();
  // acc: 4 adjacent columns a thread, the row's splits left to right
  for (int i = tid; i < R * (D / 4); i += kThreads) {
    const int r = i / (D / 4), d = (i % (D / 4)) * 4;
    const int c = r / rep;
    const int s0 = row_lo(st + c, window) / kSplitPos, s1 = min(st + c, cap) / kSplitPos;
    const float* src = ws_pv + (part0 * R + r) * D + d;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 8
    for (int sp = s0; sp <= s1; ++sp) {
      const float wt = w_fits ? w_s[r * ns + sp - s_first]
                              : exp2f(__ldcg(ws_ml + ((part0 + sp) * R + r) * 2) - m_s[r]);
      const float4 x = __ldcg(reinterpret_cast<const float4*>(src + (size_t)sp * R * D));
      a0 += x.x * wt;
      a1 += x.y * wt;
      a2 += x.z * wt;
      a3 += x.w * wt;
    }
    const float l = fmaxf(l_s[r], 1e-30f);
    const __nv_bfloat162 lo = __floats2bfloat162_rn(a0 / l, a1 / l);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(a2 / l, a3 / l);
    uint2 v;
    v.x = *reinterpret_cast<const uint32_t*>(&lo);
    v.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(out + (((size_t)b * C + c) * kvh * rep + (size_t)g * rep +
                                     r % rep) * D + d) = v;
  }
  if (tid == 0) counters[bg] = 0;    // ready for the next call
}

}  // namespace tc

template <typename KT, int D, int kMT, int kDS>
cudaError_t launch_tc_rows(const Args& a, int* counters) {
  using G = tc::Cfg<KT, D, kMT, kDS>;
  auto kernel = tc::exact_tc<KT, D, kMT, kDS>;
  cudaError_t e = set_smem(kernel, G::kSmem);
  if (e != cudaSuccess) return e;
  const int n_splits = (a.n_blocks * a.page + tc::kSplitPos - 1) / tc::kSplitPos;
  kernel<<<dim3(n_splits * kDS, a.kvh, a.B), tc::kThreads, G::kSmem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const KT*>(a.k),
      static_cast<const KT*>(a.v), a.ks, a.vs, a.table, a.start,
      static_cast<__nv_bfloat16*>(a.out), a.ws_pv, a.ws_s, counters, a.C, a.kvh, a.rep,
      a.page, a.n_blocks, a.window, a.scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <typename KT, int D>
cudaError_t launch_tc(const Args& a, int* counters) {
  const int R = a.C * a.rep;
  return R <= 16 ? launch_tc_rows<KT, D, 1, 1>(a, counters)
         : R <= 32 ? launch_tc_rows<KT, D, 2, 1>(a, counters)
                   : launch_tc_rows<KT, D, 4, 2>(a, counters);
}

template <typename KT>
cudaError_t dispatch_tc(int D, const Args& a, int* counters) {
  switch (D) {
    case 64: return launch_tc<KT, 64>(a, counters);
    case 128: return launch_tc<KT, 128>(a, counters);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16, 2 = fp8 e4m3, 3 = int8 (pools
// only; q is 0 or 1).  Code pools (2, 3) need k_scales/v_scales (P, page,
// KVH) f32; dense pools take null there.  q and out are (B, C, H, D);
// n_chunks = ceil(n_blocks * page / 128).  variant (chosen by the host):
//   0  CUDA cores, four launches; ws_s: (B, KVH, C * rep, n_blocks * page)
//      f32 and ws_pv: (B, KVH, n_chunks, C * rep, D) f32 scratch; page
//      must divide 64;
//   1  tensor cores, one launch, bf16 q over bf16/fp8/int8 pools, D 64/128,
//      page a multiple of 16; ws_pv: (B, KVH, n_splits, C * rep, D) f32 and
//      ws_s: (B, KVH, n_splits, C * rep, 2) f32 scratch, n_splits =
//      ceil(n_blocks * page / 256); counters: B KVH int32, zero before the
//      call and zero again after it.
// Returns a cudaError_t (0 = ok).
int paged_exact_attention(const void* q, const void* k_pages, const void* v_pages,
                          const void* k_scales, const void* v_scales,
                          const void* page_table, const void* start, void* out,
                          void* ws_s, void* ws_pv, void* counters, int B, int C, int kvh,
                          int rep, int D, int page, int n_blocks, int window, float scale,
                          int q_dtype, int kv_dtype, int variant, void* stream) {
  if (B < 1 || C < 1 || kvh < 1 || rep < 1 || C * rep > kMaxRows || page < 1 ||
      n_blocks < 1 || B > 65535 || kvh > 65535)
    return (int)cudaErrorInvalidValue;
  const bool quantized = kv_dtype == 2 || kv_dtype == 3;
  if (quantized != (k_scales != nullptr && v_scales != nullptr))
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (n_blocks * page + kChunkPos - 1) / kChunkPos;
  const int n_score_chunks = (n_blocks * page + kScoreChunkPos - 1) / kScoreChunkPos;
  const Args a{q, k_pages, v_pages,
               static_cast<const float*>(k_scales), static_cast<const float*>(v_scales),
               static_cast<const int*>(page_table), static_cast<const int*>(start), out,
               static_cast<float*>(ws_s), static_cast<float*>(ws_pv),
               B, C, kvh, rep, page, n_blocks, n_chunks, n_score_chunks, window, scale,
               static_cast<cudaStream_t>(stream)};
  if (variant == 1) {
    if (q_dtype != 1 || page % 16 != 0 || counters == nullptr)
      return (int)cudaErrorInvalidValue;
    int* cnt = static_cast<int*>(counters);
    switch (kv_dtype) {
      case 1: return (int)dispatch_tc<__nv_bfloat16>(D, a, cnt);
      case 2: return (int)dispatch_tc<__nv_fp8_e4m3>(D, a, cnt);
      case 3: return (int)dispatch_tc<int8_t>(D, a, cnt);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (variant != 0 || kScoreChunkPos % page != 0) return (int)cudaErrorInvalidValue;
  if (q_dtype == 0) return (int)dispatch_kv<float>(kv_dtype, D, a);
  if (q_dtype == 1) return (int)dispatch_kv<__nv_bfloat16>(kv_dtype, D, a);
  return (int)cudaErrorInvalidValue;
}

const char* paged_exact_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
