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
// are dequantized per token as float(code) * scale[t] (the plain version's
// op sequence).
//
// The contract that makes it "exact": the order of every sum taken for one
// (slot row, query position, head) is fixed by that position alone -- not
// by B, C, n_blocks, the grid or the number of SMs.  So a verify launch of
// C = gamma + 1 queries gives, bit for bit, what C launches of one query
// would, and a row gives the same bits in any batch:
//   * a score is a D-long dot product: each lane sums its D/32 elements in
//     order, then a fixed butterfly over the warp;
//   * the row's maximum is exact in any order; its sum of exponentials is
//     taken by thread i of a fixed 128-thread block over the positions
//     t == i (mod 128) in increasing order, then a fixed tree;
//   * P.V for one output element is summed over fixed chunks of 128
//     absolute positions, each chunk in position order, and the chunks'
//     partial sums are then folded in chunk order;
//   * no atomics.  Positions outside a row's range are never read into its
//     sums (the masked tail of a rejected speculative window, dead table
//     entries on the scratch page).
//
// What bounds it: it reads every live K/V byte of a slot once for all C
// queries and does ~4 * C * rep flops per K/V element pair it reads, still
// far below the card's ~295 flop/byte ridge for C * rep <= 64, so device
// memory bytes bound it.  The f32 scores (B, KVH, C * rep, n_blocks * page)
// do not fit on chip for long rows (C 5 x rep 4 x 4096 x 4 B = 320 KB per
// (slot, kv head) > 227 KB), so they go through a device workspace the
// wrapper allocates: ~2 x 4 B per (query row, position) written and read,
// against 2 x 2 x D B of bf16 K/V per (kv head, position) -- at C * rep 20
// and D 128 that is about a third more bytes than the K/V stream.
//
// Four kernels:
//   1. exact_scores: one CTA per (64-position chunk, kv head, slot) walks
//      the chunk's live pages, double-buffered in shared memory with
//      cp.async, and writes the scaled scores of all C * rep query rows.
//      Warps take tokens; each lane holds D/32 elements of the K row and of
//      8 query rows at a time, whose 8 butterflies interleave (a row's
//      reduction alone is a chain of 5 dependent shuffles);
//   2. exact_softmax: one CTA per (query row, kv head, slot) takes the
//      row's max and sum of exp(s - max) and overwrites the scores with the
//      probabilities exp(s - max) / sum;
//   3. exact_pv: one CTA per (128-position chunk, kv head, slot) stages
//      the chunk's probabilities position-major (one float4 load serves 4
//      rows) and walks its V pages; thread d accumulates column d of every
//      row in position order and writes the chunk's partial sums;
//   4. exact_combine: folds each row's chunk partials in chunk order and
//      writes the output in q's dtype.
// The scores' chunk only sets the grid; the P.V chunk is part of the sum
// order, fixed at 128 absolute positions.

#include <cuda_bf16.h>
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

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16, 2 = fp8 e4m3, 3 = int8 (pools
// only; q is 0 or 1).  Code pools (2, 3) need k_scales/v_scales (P, page,
// KVH) f32; dense pools take null there.  q and out are (B, C, H, D);
// ws_s: (B, KVH, C * rep, n_blocks * page) f32 and ws_pv: (B, KVH,
// n_chunks, C * rep, D) f32 scratch, n_chunks = ceil(n_blocks * page /
// 128).  page must divide 64.  Returns a cudaError_t (0 = ok).
int paged_exact_attention(const void* q, const void* k_pages, const void* v_pages,
                          const void* k_scales, const void* v_scales,
                          const void* page_table, const void* start, void* out,
                          void* ws_s, void* ws_pv, int B, int C, int kvh, int rep, int D,
                          int page, int n_blocks, int window, float scale, int q_dtype,
                          int kv_dtype, void* stream) {
  if (B < 1 || C < 1 || kvh < 1 || rep < 1 || C * rep > kMaxRows || page < 1 ||
      kScoreChunkPos % page != 0 || n_blocks < 1)
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
  if (q_dtype == 0) return (int)dispatch_kv<float>(kv_dtype, D, a);
  if (q_dtype == 1) return (int)dispatch_kv<__nv_bfloat16>(kv_dtype, D, a);
  return (int)cudaErrorInvalidValue;
}

const char* paged_exact_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
