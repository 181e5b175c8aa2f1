// Paged single-token GQA flash-decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention/paged_kernel.py::paged_decode_attention
// (online accumulator, optional sliding window): dense bf16/f32 pools, and
// fp8 (e4m3) / int8 code pools with (P, page, KVH) f32 per-token scale
// pools (its k_scales/v_scales branch).
//
// out[b, g*rep + r, :] = softmax_t(q[b, g*rep + r] . K[t] * scale) @ V
// over the positions t visible from pos[b] (t <= pos, and t > pos - window
// when a window is set), where token t of slot b lives at
// pool[page_table[b, t / page], t % page, g, :].
//
// What bounds it: decode attention reads every live K/V byte once and does
// ~4 flops per element read, far below the card's ~295 flop/byte ridge, so
// it is bound by device-memory bytes, and what matters is how many bytes
// are in flight and how short the chain of dependent instructions per token
// is.  The first version (CUDA cores: D threads a CTA double-buffering one
// 16-token page, a 5-shuffle butterfly per (token, query row), a second
// kernel to fold the splits) read 0.1027 / 0.3629 ms at B 8, ctx 1024 /
// 4096: 3.9x / 5.7x a plain read of the same bytes, and 2.8x / 4.9x SDPA
// with enable_gqa (NVIDIA H100 80GB HBM3, 700 W).
//
// bf16 q over bf16, fp8 or int8 pools at D 64, 80, 96 or 128 with a page of
// 16 or a multiple of 16 (paged_decode_tc, the serve path) now -- the dense
// decode's tensor-core design (dense_decode.cu) over a page walk:
//   * one CTA per (split, kv head, slot) of 4 warps walks the split's share
//     of the slot's live 64-token tiles, [max(0, pos - window + 1), pos].
//     Warp w owns tokens 16w..16w+15 of each tile: 16 aligned tokens lie in
//     one page, so the warp reads that page's table entry itself (the
//     lanes hold the entries of its next 32 tiles, one shuffle each) and
//     copies the tokens with cp.async into its own 3-stage ring (tokens
//     outside the window zero-filled, never read; a slice with none live
//     is neither copied nor computed), so the loop needs no block barrier;
//   * scores on the tensor cores: the rep query heads of kv head g, padded
//     to 16 rows, are the M dimension of mma.m16n8k16, K the B operand;
//   * P.V on the tensor cores without losing f32 precision: P = hi + lo,
//     two bf16 values, two mma each; the online softmax per warp in f32
//     with exp2f; the mask only on a slice that holds the window's lower
//     edge or pos;
//   * code pools: an e4m3 or int8 code is exact in bf16, so the codes are
//     converted as the fragments are formed, straight from shared memory
//     (no ldmatrix: the head dim of K and of the output is permuted so
//     that each thread's codes are one 16-byte load; q is stored in the
//     same order).  The per-token K scale multiplies the score after the
//     product and the V scale folds into P before the hi/lo split -- the
//     plain version dequantizes first (float(code) * scale), so the two
//     differ in rounding only.  D 80 and 96 (h2o-danube, phi3-mini) keep
//     that design with the head dims in groups of 64 and a tail of 16 or 32:
//     a thread's K codes are one 16-byte load per full group and a 4- or
//     8-byte load for the tail (1 or 2 k-steps), its V codes 8 bytes for
//     the first 64 dims and 2 or 4 for the tail, in 192-byte K and D + 16
//     byte V rows (no padding of the pools; the tail loads hit two banks
//     twice); bf16 pools take them as they are (5 or 6 k-steps, 10 or 12
//     n8 tiles, 2D + 16 byte rows, conflict-free);
//   * the split count is what one wave holds (two CTAs an SM), at most one
//     split per 64-token tile of the table; a split takes an even share of
//     its slot's live tiles, and a split with none exits at once;
//   * one launch: the warps fold their states in the CTA, each CTA writes
//     its split's (m, l, acc), and the last CTA of (slot, kv head) to
//     finish -- an integer counter per (slot, kv head), zeroed when the
//     wrapper allocates it and reset by that CTA -- folds the splits in
//     split order.  No float atomics: sampled streams reproduce.
//
// Every other pairing (f32 q or f32 pools: the parity checks; D 256; a page
// that is not a multiple of 16) keeps the first version's CUDA-core kernels
// below, chosen by dtype, head dim and page before the launch
// (paged_kernel.py: variant()).  Partial kernel: one CTA per (kv head g,
// slot b, split s), D threads.  Per live page of its share:
//   1. (already in flight) the page's K and V rows of head g land in shared
//      memory; the next page's copies are issued (for code pools with their
//      scales, dequantized right after the page lands, float(code) *
//      scale[token]);
//   2. warps take tokens; each lane holds D/32 elements of the K row and the
//      rep query rows' dot products reduce across the warp by shuffles;
//   3. one warp per query row folds the page's scores into (m, l);
//   4. thread d accumulates acc[r][d] += p[r][t] * V[t][d] in registers.
// It writes its unnormalised (m, l, acc) to a workspace; the combine kernel
// rescales the splits to a common max, sums, divides by max(l, 1e-30) and
// writes in q's dtype.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRep = 16;        // query heads per kv head (registers)
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

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

// N contiguous elements loaded as one (or, above 16 bytes, several) wide
// shared-memory access; aligned to the largest power of two that divides
// their bytes (12 bytes of three floats: 4)
__host__ __device__ constexpr size_t vec_align(size_t n) { return n >= 16 ? 16 : (n & (~n + 1)); }
template <typename T, int N>
struct alignas(vec_align(sizeof(T) * N)) Vec {
  T v[N];
};

// threads of a CUDA-core CTA for head dim D: whole warps (D 80: 96, the
// last 16 idle in the P.V loop)
__host__ __device__ constexpr int cc_threads(int D) { return (D + 31) / 32 * 32; }

// this lane's kLane elements of a row of D (lane * kLane onwards; zero
// past D), f32
template <typename T, int D, int kLane>
__device__ __forceinline__ void lane_row(const T* row, int lane, float (&out)[kLane]) {
  if constexpr (D % 32 == 0) {
    const Vec<T, kLane> x = *reinterpret_cast<const Vec<T, kLane>*>(row + lane * kLane);
#pragma unroll
    for (int i = 0; i < kLane; ++i) out[i] = to_float(x.v[i]);
  } else {
#pragma unroll
    for (int i = 0; i < kLane; ++i) {
      const int e = lane * kLane + i;
      out[i] = e < D ? to_float(row[e]) : 0.f;
    }
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem));
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared memory layout (floats first, then two staged K/V pages, then for
// code pools their staged scales):
//   q_s[rep][D] f32 | s_s[rep][page] f32 | m_s, l_s, c_s [rep] f32 | pad16 |
//   kv_s[2 buffers][K, V][page][D] KT | sc_s[2 buffers][K, V][page] f32
__host__ __device__ inline size_t float_words(int rep, int D, int page) {
  size_t n = (size_t)rep * D + (size_t)rep * page + 3 * (size_t)rep;
  return (n + 3) & ~(size_t)3;     // 16-byte align the K/V staging area
}

template <typename KT>
__host__ __device__ inline size_t smem_bytes(int rep, int D, int page) {
  return float_words(rep, D, page) * sizeof(float) + 4 * (size_t)page * D * sizeof(KT) +
         (kQuantized<KT> ? 4 * (size_t)page * sizeof(float) : 0);
}

template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(cc_threads(D))
paged_decode_partial(const QT* __restrict__ q,           // (B, H, D)
                     const KT* __restrict__ k_pages,     // (P, page, KVH, D)
                     const KT* __restrict__ v_pages,     // (P, page, KVH, D)
                     const float* __restrict__ k_scales, // (P, page, KVH) or null
                     const float* __restrict__ v_scales, // (P, page, KVH) or null
                     const int* __restrict__ page_table, // (B, n_blocks)
                     const int* __restrict__ pos_arr,    // (B,)
                     float* __restrict__ ws_acc,         // (B, H, n_split, D)
                     float* __restrict__ ws_ml,          // (B, H, n_split, 2)
                     int kvh, int rep, int page, int n_blocks, int n_split,
                     int window, float scale) {
  constexpr int kThreads = cc_threads(D);
  constexpr int kWarps = kThreads / 32;
  constexpr int kLane = kThreads / 32;          // K-row elements per lane
  constexpr int kChunk = 16 / sizeof(KT);       // elements per 16-byte copy
  constexpr int kChunksPerRow = D / kChunk;

  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h = kvh * rep;

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* s_s = q_s + rep * D;
  float* m_s = s_s + rep * page;
  float* l_s = m_s + rep;
  float* c_s = l_s + rep;
  KT* kv_s = reinterpret_cast<KT*>(q_s + float_words(rep, D, page));
  const int page_elems = page * D;              // one K or V page of head g
  float* sc_s = reinterpret_cast<float*>(kv_s + 4 * (size_t)page_elems);

  // this CTA's share of the row's live pages [lo, hi]
  const int p = pos_arr[b];
  int hi = p / page;
  if (hi > n_blocks - 1) hi = n_blocks - 1;
  int lo = 0;
  if (window > 0) {
    const int first = p - window + 1;
    lo = first > 0 ? first / page : 0;
  }
  const int per = (hi - lo + n_split) / n_split;   // ceil(live / n_split)
  const int j0 = lo + split * per;
  int j1 = j0 + per - 1;
  if (j1 > hi) j1 = hi;

  const size_t tok_stride = (size_t)kvh * D;    // elements between tokens
  const int* row_table = page_table + (size_t)b * n_blocks;
  auto issue = [&](int phys, int buf) {
    const KT* kg = k_pages + ((size_t)phys * page * kvh + g) * D;
    const KT* vg = v_pages + ((size_t)phys * page * kvh + g) * D;
    KT* ks = kv_s + (size_t)buf * 2 * page_elems;
    KT* vs = ks + page_elems;
    for (int c = tid; c < page * kChunksPerRow; c += kThreads) {
      const int t = c / kChunksPerRow;
      const int e = (c % kChunksPerRow) * kChunk;
      cp_async16(ks + t * D + e, kg + t * tok_stride + e);
      cp_async16(vs + t * D + e, vg + t * tok_stride + e);
    }
    if constexpr (kQuantized<KT>) {
      float* kss = sc_s + (size_t)buf * 2 * page;
      const size_t s0 = (size_t)phys * page * kvh + g;
      for (int t = tid; t < page; t += kThreads) {
        cp_async4(kss + t, k_scales + s0 + (size_t)t * kvh);
        cp_async4(kss + page + t, v_scales + s0 + (size_t)t * kvh);
      }
    }
    cp_async_commit();
  };
  int phys_next = 0;
  if (j0 <= j1) {
    issue(row_table[j0], 0);
    if (j0 + 1 <= j1) phys_next = row_table[j0 + 1];
  }

  // query rows g*rep .. g*rep+rep-1 of slot b are contiguous
  const QT* qg = q + ((size_t)b * h + (size_t)g * rep) * D;
  for (int i = tid; i < rep * D; i += kThreads) q_s[i] = to_float(qg[i]);
  if (tid < rep) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kMaxRep];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) acc[r] = 0.f;

  for (int j = j0; j <= j1; ++j) {
    const int buf = (j - j0) & 1;
    if (j < j1) {                      // prefetch the next page, then wait
      issue(phys_next, buf ^ 1);       // for this one only
      if (j + 2 <= j1) phys_next = row_table[j + 2];
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const KT* k_s = kv_s + (size_t)buf * 2 * page_elems;
    const KT* v_s = k_s + page_elems;
    const float* ksc = sc_s + (size_t)buf * 2 * page;   // code pools only
    const float* vsc = ksc + page;

    // 2. scores s[r][t] = q_r . k_t * scale (masked to NEG_INF)
    for (int t = warp; t < page; t += kWarps) {
      float kf[kLane];
      lane_row<KT, D, kLane>(k_s + t * D, lane, kf);
      if constexpr (kQuantized<KT>) {
        const float sk = ksc[t];
#pragma unroll
        for (int i = 0; i < kLane; ++i) kf[i] *= sk;
      }
      const int idx = j * page + t;
      const bool ok = idx <= p && (window <= 0 || idx > p - window);
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) {
        if (r < rep) {
          float qr[kLane];
          lane_row<float, D, kLane>(q_s + r * D, lane, qr);
          float part = 0.f;
#pragma unroll
          for (int i = 0; i < kLane; ++i) part += qr[i] * kf[i];
          part = warp_sum(part);
          if (lane == 0) s_s[r * page + t] = ok ? part * scale : kNegInf;
        }
      }
    }
    __syncthreads();

    // 3. online softmax: fold this page into (m, l); p overwrites s
    for (int r = warp; r < rep; r += kWarps) {
      float* sr = s_s + r * page;
      float mx = kNegInf;
      for (int t = lane; t < page; t += 32) mx = fmaxf(mx, sr[t]);
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < page; t += 32) {
        const float e = expf(sr[t] - m_new);
        sr[t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // 4. acc[r][d] = acc[r][d] * corr[r] + sum_t p[r][t] * V[t][d]
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r)
      if (r < rep) acc[r] *= c_s[r];
    if (tid < D) {
      for (int t = 0; t < page; ++t) {
        float vv = to_float(v_s[t * D + tid]);
        if constexpr (kQuantized<KT>) vv *= vsc[t];
#pragma unroll
        for (int r = 0; r < kMaxRep; ++r)
          if (r < rep) acc[r] += s_s[r * page + t] * vv;
      }
    }
    __syncthreads();   // buf is refilled by the next iteration's prefetch
  }

  // unnormalised partial state of this split (m = NEG_INF, l = 0 when the
  // split got no page)
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    if (r < rep) {
      const size_t row = ((size_t)b * h + (size_t)g * rep + r) * n_split + split;
      if (tid < D) ws_acc[row * D + tid] = acc[r];
      if (tid == 0) {
        ws_ml[row * 2] = m_s[r];
        ws_ml[row * 2 + 1] = l_s[r];
      }
    }
  }
}

// out[bh, :] = sum_s acc_s * exp(m_s - M) / max(sum_s l_s * exp(m_s - M), 1e-30)
template <typename QT, int D>
__global__ void __launch_bounds__(D)
paged_decode_combine(const float* __restrict__ ws_acc, const float* __restrict__ ws_ml,
                     QT* __restrict__ out, int n_split) {
  const size_t bh = blockIdx.x;
  const int d = threadIdx.x;
  const float* ml = ws_ml + bh * n_split * 2;
  float mx = kNegInf;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, ml[2 * s]);
  float l = 0.f, a = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float w = expf(ml[2 * s] - mx);
    l += ml[2 * s + 1] * w;
    a += ws_acc[(bh * n_split + s) * D + d] * w;
  }
  out[bh * D + d] = from_float<QT>(a / fmaxf(l, 1e-30f));
}

struct Args {
  const void *q, *k, *v;
  const float *ks, *vs;
  const int *table, *pos;
  void* out;
  float *ws_acc, *ws_ml;
  int B, kvh, rep, page, n_blocks, n_split, window;
  float scale;
  cudaStream_t stream;
};

template <typename QT, typename KT, int D>
cudaError_t launch(const Args& a) {
  auto partial = paged_decode_partial<QT, KT, D>;
  const size_t smem = smem_bytes<KT>(a.rep, D, a.page);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        partial, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  partial<<<dim3(a.kvh, a.B, a.n_split), cc_threads(D), smem, a.stream>>>(
      static_cast<const QT*>(a.q), static_cast<const KT*>(a.k),
      static_cast<const KT*>(a.v), a.ks, a.vs, a.table, a.pos, a.ws_acc, a.ws_ml,
      a.kvh, a.rep, a.page, a.n_blocks, a.n_split, a.window, a.scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  paged_decode_combine<QT, D><<<a.B * a.kvh * a.rep, D, 0, a.stream>>>(
      a.ws_acc, a.ws_ml, static_cast<QT*>(a.out), a.n_split);
  return cudaGetLastError();
}

template <typename QT, typename KT>
cudaError_t dispatch_dim(int D, const Args& a) {
  switch (D) {
    case 64: return launch<QT, KT, 64>(a);
    case 80: return launch<QT, KT, 80>(a);
    case 96: return launch<QT, KT, 96>(a);
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

constexpr int kTile = 64;          // tokens per tile: 16 per warp
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;         // cp.async ring depth
constexpr unsigned kFull = 0xffffffffu;

template <typename KT, int D>
struct Cfg {
  static constexpr bool kCodes = sizeof(KT) == 1;
  static constexpr int kQRow = 2 * D + 16;                // padded bf16 q row, bytes
  // a warp's K and V rows, bytes: bf16 rows padded for ldmatrix; code rows
  // padded so that the direct 16-byte (K) and D/8-byte (V) loads of a warp
  // fall on distinct banks (D 80 / 96: their tail loads collide two ways)
  static constexpr int kKRow = kCodes ? (D == 64 ? 64 : 192) : 2 * D + 16;
  static constexpr int kVRow = kCodes ? D + 16 : 2 * D + 16;
  static constexpr int kKSlice = 16 * kKRow;
  static constexpr int kVSlice = 16 * kVRow;
  static constexpr int kScBytes = kCodes ? 2 * 16 * 4 : 0;  // K, V scales of 16 tokens
  static constexpr int kWarpStage = kKSlice + kVSlice + kScBytes;
  static constexpr int kStageBytes = kWarps * kWarpStage;
  static constexpr int kQBytes = 16 * kQRow;              // q padded to 16 rows
  static constexpr int kSmem = kQBytes + kStages * kStageBytes;
  static constexpr int kAccRow = D + 8;                   // fold rows, floats
  // the warps' (m, l, acc) for the in-CTA fold, over the ring once it is idle
  static_assert(kWarps * 16 * (2 + kAccRow) * 4 <= kStages * kStageBytes, "fold area");
  static_assert(kWarpStage % 16 == 0, "16-byte aligned stages");
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
// N (2 or 4) bytes from shared memory, as the low bytes of a word
template <int N>
__device__ __forceinline__ uint32_t load_bytes(const unsigned char* p) {
  static_assert(N == 2 || N == 4, "2 or 4 bytes");
  if constexpr (N == 4) return *reinterpret_cast<const uint32_t*>(p);
  else return *reinterpret_cast<const uint16_t*>(p);
}

// byte k of a and byte k of b, as the low 16 bits
__device__ __forceinline__ uint32_t byte_pair(uint32_t a, uint32_t b, int k) {
  return __byte_perm(a, b, k | ((4 + k) << 4));
}

// Code pools: the head dims fall into groups of 64 and, at D 80 / 96, a
// tail of 16 / 32; group h holds group_steps(h) k-steps of 16.
template <int D>
__device__ __forceinline__ constexpr int group_steps(int h) {
  if constexpr (D % 64 == 0) return 4;
  else return D - 64 * h >= 64 ? 4 : (D - 64 * h) / 16;
}
// The physical head-dim index of logical column L of the score product.  A
// thread's load of 4T bytes at byte 64h + 4T quad (T = group_steps(h): 16
// bytes in a full group) serves the group's k-steps 4h .. 4h+T-1 (4 codes
// each), so q is stored in shared memory in this order.
template <int D>
__device__ __forceinline__ int code_dim(int L) {
  const int h = L >> 6, kk = (L >> 4) & 3, half = (L >> 3) & 1, qd = (L >> 1) & 3;
  return 64 * h + 4 * group_steps<D>(h) * qd + 4 * kk + 2 * half + (L & 1);
}
// Code pools: output column n of P.V's n8 block dt is head dim v_dim(dt, n):
// thread gq's codes of a token are D/8 contiguous bytes at byte (D/8) gq (D
// 64 / 128); at D 80 / 96, 8 bytes at 8 gq for blocks 0-7 and the tail's
// (D - 64)/8 bytes at 64 + (D - 64)/8 gq for the rest
template <int D>
__device__ __forceinline__ int v_dim(int dt, int n) {
  if constexpr (D % 64 == 0) return (D / 8) * n + dt;
  else return dt < 8 ? 8 * n + dt : 64 + ((D - 64) / 8) * n + (dt - 8);
}

// One CTA per (split, kv head g, slot b): 4 warps walk the split's share of
// the slot's live 64-token tiles, warp w owning tokens 16w..16w+15 of each
// tile (one page's worth: it reads the table entry, loads, scores and folds
// them itself, no block barrier in the loop).  Query rows g*rep ..
// g*rep+rep-1 are the M dimension of mma.m16n8k16, padded to 16 with zeros.
// Then the warps fold their states in the CTA, the CTA writes its split's
// partial (m, l, acc), and the last CTA of (b, g) folds every split in
// split order.
template <typename KT, int D>
__global__ void __launch_bounds__(kThreads, 2)
paged_decode_tc(const __nv_bfloat16* __restrict__ q,  // (B, H, D)
                const KT* __restrict__ k_pages,       // (P, page, KVH, D)
                const KT* __restrict__ v_pages,       // (P, page, KVH, D)
                const float* __restrict__ k_scales,   // (P, page, KVH) or null
                const float* __restrict__ v_scales,   // (P, page, KVH) or null
                const int* __restrict__ page_table,   // (B, n_blocks)
                const int* __restrict__ pos_arr,      // (B,)
                __nv_bfloat16* __restrict__ out,      // (B, H, D)
                float* __restrict__ ws_acc,           // (B * KVH, n_split, rep, D)
                float* __restrict__ ws_ml,            // (B * KVH, n_split, rep, 2)
                int* __restrict__ counters,           // (>= B * KVH,), zero between calls
                int kvh, int rep, int page, int n_blocks, int window, float scale_log2) {
  using C = Cfg<KT, D>;
  constexpr bool kCodes = C::kCodes;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t q_s = smem_u32(smem);
  const uint32_t ring = q_s + C::kQBytes;

  const int split = blockIdx.x;
  const int n_split = gridDim.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int bg = b * kvh + g;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;          // fragment row (query row gq and gq + 8)
  const int quad = lane & 3;

  // the slot's live tokens [lo, last] and tiles; this split's share [j0, j1)
  const int p = pos_arr[b];
  const int last = min(p, n_blocks * page - 1);
  const int lo = window > 0 ? max(0, p - window + 1) : 0;
  const int t_lo = lo / kTile;
  const int n_tiles = last / kTile - t_lo + 1;
  const int j0 = t_lo + split * n_tiles / n_split;
  const int j1 = t_lo + (split + 1) * n_tiles / n_split;
  if (j0 >= j1) return;              // no tile: this split is not folded

  const int* row_table = page_table + (size_t)b * n_blocks;
  const uint32_t my_k = ring + warp * C::kWarpStage;     // + stage * kStageBytes
  const uint32_t my_v = my_k + C::kKSlice;
  const uint32_t my_sc = my_v + C::kVSlice;               // code pools: K, V scales
  // a slice (this warp's 16 tokens of tile j) holds a live token
  auto live_slice = [&](int t0) { return t0 <= last && t0 + 15 >= lo; };
  // lane i holds the table entry of this warp's slice of tile jb + i
  int tbl = 0;
  auto issue = [&](int j, int stage) {   // always one commit group
    if (j < j1) {
      const int i = j - j0;
      if ((i & 31) == 0) {               // the entries of the next 32 tiles
        const int t0 = (j + lane) * kTile + warp * 16;
        tbl = (j + lane < j1 && live_slice(t0)) ? __ldg(row_table + t0 / page) : 0;
      }
      const int phys = __shfl_sync(kFull, tbl, i & 31);
      const int t0 = j * kTile + warp * 16;
      if (live_slice(t0)) {
        // token row (slot token t0 + r, kv head g) of the pools: base + r * kvh
        const size_t base = ((size_t)phys * page + t0 % page) * kvh + g;
        const uint32_t ks = my_k + stage * C::kStageBytes;
        const uint32_t vs = my_v + stage * C::kStageBytes;
        constexpr int kPer = 16 / sizeof(KT);           // elements per 16 bytes
        constexpr int kChunks = D / kPer;               // 16-byte chunks per row
#pragma unroll
        for (int c = lane; c < 16 * kChunks; c += 32) {
          const int r = c / kChunks, e = (c % kChunks) * kPer;
          const bool live = t0 + r >= lo && t0 + r <= last;
          const size_t off = live ? (base + (size_t)r * kvh) * D + e : 0;
          cp_async16_zfill(ks + r * C::kKRow + e * sizeof(KT), k_pages + off, live ? 16 : 0);
          cp_async16_zfill(vs + r * C::kVRow + e * sizeof(KT), v_pages + off, live ? 16 : 0);
        }
        if constexpr (kCodes) {          // lanes 0-15: K scales, 16-31: V scales
          const int r = lane & 15;
          const bool live = t0 + r >= lo && t0 + r <= last;
          const float* src = (lane < 16 ? k_scales : v_scales) + (live ? base + (size_t)r * kvh : 0);
          cp_async4_zfill(my_sc + stage * C::kStageBytes + lane * 4, src, live ? 4 : 0);
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(j0 + s, s);
  // while they land: q rows of kv head g, zero-padded to 16 rows, 8
  // columns a load (code pools: in code_dim order, 4 pairs)
  const __nv_bfloat16* qg = q + ((size_t)b * kvh * rep + (size_t)g * rep) * D;
  for (int i = tid; i < 16 * (D / 8); i += kThreads) {
    const int r = i / (D / 8), col = (i % (D / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < rep) {
      if constexpr (!kCodes) {
        val = *reinterpret_cast<const uint4*>(qg + r * D + col);
      } else {   // head dims +0, +4T, +8T, +12T (T = 4 in a full group)
        const int T = group_steps<D>(col >> 6);
        const uint32_t* pr = reinterpret_cast<const uint32_t*>(qg + r * D + code_dim<D>(col));
        val = make_uint4(pr[0], pr[2 * T], pr[4 * T], pr[6 * T]);
      }
    }
    *reinterpret_cast<uint4*>(smem + r * C::kQRow + 2 * col) = val;
  }
  __syncthreads();                   // q is in shared memory

  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.f, 0.f};
  // ldmatrix row addresses: A (q) matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15);
  // bf16 K's B matrices (tokens 0-7 | 8-15) x (d 0-7 | 8-15); V's, transposed
  const int mi = lane >> 3;
  const uint32_t qa_addr = q_s + ((lane & 7) + (mi & 1) * 8) * C::kQRow + (mi >> 1) * 16;
  const uint32_t kb_off = ((lane & 7) + (mi >> 1) * 8) * C::kKRow + (mi & 1) * 16;
  const uint32_t vb_off = ((lane & 7) + (mi & 1) * 8) * C::kVRow + (mi >> 1) * 16;

  for (int j = j0; j < j1; ++j) {
    const int stage = (j - j0) % kStages;
    issue(j + kStages - 1, (j - j0 + kStages - 1) % kStages);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1));
    __syncwarp();
    const int t0 = j * kTile + warp * 16;
    if (live_slice(t0)) {              // warp-uniform
      const uint32_t ks = my_k + stage * C::kStageBytes;
      const uint32_t vs = my_v + stage * C::kStageBytes;
      const unsigned char* ks_p = smem + (ks - q_s);
      const unsigned char* vs_p = smem + (vs - q_s);
      const float* sc_p = reinterpret_cast<const float*>(smem + (my_sc + stage * C::kStageBytes - q_s));

      // scores of 16 query rows x this warp's 16 tokens (column n of block
      // nb is token 8nb + n), exact products of bf16 in f32
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      if constexpr (!kCodes) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t a[4], kb[4];
          ldmatrix_x4(a, qa_addr + kk * 32);
          ldmatrix_x4(kb, ks + kb_off + kk * 32);
          mma_bf16(sc[0], a, kb[0], kb[1]);
          mma_bf16(sc[1], a, kb[2], kb[3]);
        }
      } else {
#pragma unroll
        for (int h = 0; h < D / 64; ++h) {
          const uint4 w0 = *reinterpret_cast<const uint4*>(ks_p + gq * C::kKRow + 64 * h + 16 * quad);
          const uint4 w1 =
              *reinterpret_cast<const uint4*>(ks_p + (8 + gq) * C::kKRow + 64 * h + 16 * quad);
          const uint32_t x0[4] = {w0.x, w0.y, w0.z, w0.w};
          const uint32_t x1[4] = {w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            uint32_t a[4];
            ldmatrix_x4(a, qa_addr + (4 * h + s) * 32);
            mma_bf16(sc[0], a, codes_bf16x2<KT>(x0[s]), codes_bf16x2<KT>(x0[s] >> 16));
            mma_bf16(sc[1], a, codes_bf16x2<KT>(x1[s]), codes_bf16x2<KT>(x1[s] >> 16));
          }
        }
        if constexpr (D % 64 != 0) {   // the tail group of D 80 / 96
          constexpr int h = D / 64, T = group_steps<D>(D / 64);
          Words<T> x0, x1;
          x0.load(ks_p + gq * C::kKRow + 64 * h + 4 * T * quad);
          x1.load(ks_p + (8 + gq) * C::kKRow + 64 * h + 4 * T * quad);
#pragma unroll
          for (int s = 0; s < T; ++s) {
            uint32_t a[4];
            ldmatrix_x4(a, qa_addr + (4 * h + s) * 32);
            mma_bf16(sc[0], a, codes_bf16x2<KT>(x0.w[s]), codes_bf16x2<KT>(x0.w[s] >> 16));
            mma_bf16(sc[1], a, codes_bf16x2<KT>(x1.w[s]), codes_bf16x2<KT>(x1.w[s] >> 16));
          }
        }
      }
      // scaled to the log2 domain (code pools: times the token's K scale);
      // masked to NEG_INF outside [lo, last]
      const bool edge = t0 < lo || t0 + 15 > last;
      float vsc[2][2];                 // code pools: the V scales of my tokens
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        float f0 = scale_log2, f1 = scale_log2;
        if constexpr (kCodes) {
          const float2 k2 = *reinterpret_cast<const float2*>(sc_p + nb * 8 + 2 * quad);
          const float2 v2 = *reinterpret_cast<const float2*>(sc_p + 16 + nb * 8 + 2 * quad);
          f0 *= k2.x;
          f1 *= k2.y;
          vsc[nb][0] = v2.x;
          vsc[nb][1] = v2.y;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& x = sc[nb][e];
          x *= (e & 1) ? f1 : f0;
          if (edge) {
            const int t = t0 + nb * 8 + 2 * quad + (e & 1);
            if (t < lo || t > last) x = kNegInf;
          }
        }
      }
      // online softmax per row
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = fmaxf(fmaxf(sc[0][2 * hh], sc[0][2 * hh + 1]),
                         fmaxf(sc[1][2 * hh], sc[1][2 * hh + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        const float m_new = fmaxf(m_r[hh], mx);
        const float corr = exp2f(m_r[hh] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc[nb][2 * hh + e];
            x = x == kNegInf ? 0.f : exp2f(x - m_new);
            sum += x;
          }
        sum += __shfl_xor_sync(kFull, sum, 1);
        sum += __shfl_xor_sync(kFull, sum, 2);
        l_r[hh] = l_r[hh] * corr + sum;
        m_r[hh] = m_new;
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
          o[dt][2 * hh] *= corr;
          o[dt][2 * hh + 1] *= corr;
        }
      }
      if constexpr (kCodes) {          // fold the V scales into P
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[nb][e] *= vsc[nb][e & 1];
      }
      // O += P V with P = hi + lo (two bf16 mma): the score accumulators are
      // the A fragment of the 16-token k-step
      uint32_t ph[4], pl[4];
      split_bf16x2(sc[0][0], sc[0][1], ph[0], pl[0]);
      split_bf16x2(sc[0][2], sc[0][3], ph[1], pl[1]);
      split_bf16x2(sc[1][0], sc[1][1], ph[2], pl[2]);
      split_bf16x2(sc[1][2], sc[1][3], ph[3], pl[3]);
      if constexpr (!kCodes) {
#pragma unroll
        for (int dt = 0; dt < D / 8; dt += 2) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, vs + vb_off + dt * 16);
          mma_bf16(o[dt], ph, vb[0], vb[1]);
          mma_bf16(o[dt], pl, vb[0], vb[1]);
          mma_bf16(o[dt + 1], ph, vb[2], vb[3]);
          mma_bf16(o[dt + 1], pl, vb[2], vb[3]);
        }
      } else {
        // V's B fragments straight from the codes: tokens 2quad, 2quad + 1
        // (b0) and 2quad + 8, 2quad + 9 (b1); output column n of block dt is
        // head dim v_dim(dt, n), so thread gq's codes of each of its 4 tokens
        // are one load (D 64 / 128), or two (D 80 / 96: blocks 0-7, the tail)
        constexpr int kMain = D % 64 == 0 ? D / 8 : 8;     // bytes of the first load
        constexpr int kTail = D % 64 == 0 ? 0 : (D - 64) / 8;
        const unsigned char* vrow = vs_p + kMain * gq;
        Words<kMain / 4> va, vb2, vc, vd;
        va.load(vrow + (2 * quad) * C::kVRow);
        vb2.load(vrow + (2 * quad + 1) * C::kVRow);
        vc.load(vrow + (2 * quad + 8) * C::kVRow);
        vd.load(vrow + (2 * quad + 9) * C::kVRow);
        uint32_t ta = 0, tb = 0, tc_ = 0, td = 0;
        if constexpr (kTail > 0) {
          const unsigned char* trow = vs_p + 64 + kTail * gq;
          ta = load_bytes<kTail>(trow + (2 * quad) * C::kVRow);
          tb = load_bytes<kTail>(trow + (2 * quad + 1) * C::kVRow);
          tc_ = load_bytes<kTail>(trow + (2 * quad + 8) * C::kVRow);
          td = load_bytes<kTail>(trow + (2 * quad + 9) * C::kVRow);
        }
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
          uint32_t p0, p1;
          if (dt < kMain) {
            const int w = (dt < kMain ? dt : kMain - 1) >> 2, k = dt & 3;
            p0 = byte_pair(va.w[w], vb2.w[w], k);
            p1 = byte_pair(vc.w[w], vd.w[w], k);
          } else {
            p0 = byte_pair(ta, tb, dt - kMain);
            p1 = byte_pair(tc_, td, dt - kMain);
          }
          const uint32_t b0 = codes_bf16x2<KT>(p0);
          const uint32_t b1 = codes_bf16x2<KT>(p1);
          mma_bf16(o[dt], ph, b0, b1);
          mma_bf16(o[dt], pl, b0, b1);
        }
      }
    }
    __syncwarp();                    // the stage is refilled next iteration
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();                   // the ring is idle: fold area

  // fold the 4 warps: (m, l) per row, then acc
  float* ml_s = reinterpret_cast<float*>(smem + C::kQBytes);   // [warp][16][2]
  float* acc_s = ml_s + kWarps * 16 * 2;                       // [warp][16][kAccRow]
  if (quad == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      ml_s[(warp * 16 + gq + 8 * hh) * 2] = m_r[hh];
      ml_s[(warp * 16 + gq + 8 * hh) * 2 + 1] = l_r[hh];
    }
  }
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float* row = acc_s + (warp * 16 + gq + 8 * hh) * C::kAccRow;
      if constexpr (!kCodes) {
        *reinterpret_cast<float2*>(row + dt * 8 + 2 * quad) =
            make_float2(o[dt][2 * hh], o[dt][2 * hh + 1]);
      } else {
        row[v_dim<D>(dt, 2 * quad)] = o[dt][2 * hh];
        row[v_dim<D>(dt, 2 * quad + 1)] = o[dt][2 * hh + 1];
      }
    }
  __syncthreads();

  const size_t part = (size_t)bg * n_split + split;
  for (int i = tid; i < rep * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, ml_s[(w * 16 + r) * 2]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp2f(ml_s[(w * 16 + r) * 2] - mx);
      l += ml_s[(w * 16 + r) * 2 + 1] * wt;
      a += acc_s[(w * 16 + r) * C::kAccRow + d] * wt;
    }
    ws_acc[(part * rep + r) * D + d] = a;
    if (d == 0) {
      ws_ml[(part * rep + r) * 2] = mx;
      ws_ml[(part * rep + r) * 2 + 1] = l;
    }
  }

  // the last CTA of (b, g) to finish folds the splits that hold a tile, in
  // split order
  const int n_live = n_tiles < n_split ? n_tiles : n_split;
  __threadfence();
  __syncthreads();
  __shared__ int is_last;
  if (tid == 0) is_last = atomicAdd(counters + bg, 1) == n_live - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const size_t part0 = (size_t)bg * n_split;
  for (int i = tid; i < rep * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float mx = kNegInf;
    for (int s = 0; s < n_split; ++s)
      if (s * n_tiles / n_split < (s + 1) * n_tiles / n_split)
        mx = fmaxf(mx, __ldcg(ws_ml + ((part0 + s) * rep + r) * 2));
    float l = 0.f, a = 0.f;
    for (int s = 0; s < n_split; ++s) {
      if (s * n_tiles / n_split == (s + 1) * n_tiles / n_split) continue;
      const size_t pr = (part0 + s) * rep + r;
      const float wt = exp2f(__ldcg(ws_ml + pr * 2) - mx);
      l += __ldcg(ws_ml + pr * 2 + 1) * wt;
      a += __ldcg(ws_acc + pr * D + d) * wt;
    }
    out[((size_t)b * kvh * rep + (size_t)g * rep + r) * D + d] =
        __float2bfloat16_rn(a / fmaxf(l, 1e-30f));
  }
  if (tid == 0) counters[bg] = 0;    // ready for the next call
}

}  // namespace tc

template <typename KT, int D>
cudaError_t launch_tc(const Args& a, int* counters) {
  using C = tc::Cfg<KT, D>;
  auto kernel = tc::paged_decode_tc<KT, D>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(a.n_split, a.kvh, a.B), tc::kThreads, C::kSmem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const KT*>(a.k),
      static_cast<const KT*>(a.v), a.ks, a.vs, a.table, a.pos,
      static_cast<__nv_bfloat16*>(a.out), a.ws_acc, a.ws_ml, counters, a.kvh, a.rep, a.page,
      a.n_blocks, a.window, a.scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <typename KT>
cudaError_t dispatch_tc(int D, const Args& a, int* counters) {
  switch (D) {
    case 64: return launch_tc<KT, 64>(a, counters);
    case 80: return launch_tc<KT, 80>(a, counters);
    case 96: return launch_tc<KT, 96>(a, counters);
    case 128: return launch_tc<KT, 128>(a, counters);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16, 2 = fp8 e4m3, 3 = int8 (pools
// only; q is 0 or 1).  Code pools (2, 3) need k_scales/v_scales (P, page,
// KVH) f32; dense pools take null there.  ws_acc: (B, H, n_split, D) f32
// and ws_ml: (B, H, n_split, 2) f32 scratch.  variant (chosen by the host):
//   0  CUDA cores, any of the dtypes, D 64/80/96/128/256 (two launches:
//      partial and combine);
//   1  tensor cores, bf16 q over bf16/fp8/int8 pools, D 64/80/96/128, page a
//      multiple of 16 (one launch); counters: B KVH int32, zero before the
//      call and zero again after it.
// Returns a cudaError_t (0 = ok).
int paged_decode_attention(const void* q, const void* k_pages, const void* v_pages,
                           const void* k_scales, const void* v_scales,
                           const void* page_table, const void* pos, void* out,
                           void* ws_acc, void* ws_ml, void* counters, int B, int kvh,
                           int rep, int D, int page, int n_blocks, int n_split, int window,
                           float scale, int q_dtype, int kv_dtype, int variant,
                           void* stream) {
  if (rep < 1 || rep > kMaxRep || page < 1 || n_blocks < 1 || B < 1 || kvh < 1 ||
      n_split < 1 || B > 65535 || kvh > 65535)
    return (int)cudaErrorInvalidValue;
  const bool quantized = kv_dtype == 2 || kv_dtype == 3;
  if (quantized != (k_scales != nullptr && v_scales != nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages,
               static_cast<const float*>(k_scales), static_cast<const float*>(v_scales),
               static_cast<const int*>(page_table), static_cast<const int*>(pos), out,
               static_cast<float*>(ws_acc), static_cast<float*>(ws_ml),
               B, kvh, rep, page, n_blocks, n_split, window, scale,
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
  if (variant != 0) return (int)cudaErrorInvalidValue;
  if (q_dtype == 0) return (int)dispatch_kv<float>(kv_dtype, D, a);
  if (q_dtype == 1) return (int)dispatch_kv<__nv_bfloat16>(kv_dtype, D, a);
  return (int)cudaErrorInvalidValue;
}

const char* paged_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
