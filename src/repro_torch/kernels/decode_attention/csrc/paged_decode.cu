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
// it is bound by device-memory bytes.  The design therefore
//   * walks only the live pages of each row -- [max(0, (pos-window+1)/page),
//     pos/page] -- straight from the physical pool through the page table
//     (no dense gather, no masked dead pages);
//   * keeps q, the scores and the online-softmax state (m, l, acc) on chip
//     in f32;
//   * splits each row's live pages over n_split CTAs (flash-decoding), so
//     that a decode batch of B x KVH (kv head, slot) pairs still puts
//     several CTAs on every SM, and a second small kernel folds the
//     n_split partial states;
//   * double-buffers pages in shared memory with cp.async, so the next
//     page's K/V stream in while the current page is folded;
//   * for code pools, stages the page's K and V scales beside its codes
//     (4-byte cp.async: a head's scales are strided by KVH, so they are not
//     one 16-byte row) and dequantizes right after the page lands,
//     float(code) * scale[token], the plain version's op sequence.  A code
//     pool moves a quarter (f32) or half (bf16) of the bytes, so the
//     kernel's byte bound falls by as much.
//
// Partial kernel: one CTA per (kv head g, slot b, split s), D threads.  Per
// live page of its share:
//   1. (already in flight) the page's K and V rows of head g land in shared
//      memory; the next page's copies are issued;
//   2. warps take tokens; each lane holds D/32 elements of the K row and the
//      rep query rows' dot products reduce across the warp by shuffles;
//   3. one warp per query row folds the page's scores into (m, l);
//   4. thread d accumulates acc[r][d] += p[r][t] * V[t][d] in registers.
// It writes its unnormalised (m, l, acc) to a workspace; the combine kernel
// rescales the splits to a common max, sums, divides by max(l, 1e-30) and
// writes in q's dtype.

#include <cuda_bf16.h>
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
// shared-memory access
template <typename T, int N>
struct alignas(sizeof(T) * N > 16 ? 16 : sizeof(T) * N) Vec {
  T v[N];
};

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
__global__ void __launch_bounds__(D)
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
  constexpr int kWarps = D / 32;
  constexpr int kLane = D / 32;                 // K-row elements per lane
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
    for (int c = tid; c < page * kChunksPerRow; c += D) {
      const int t = c / kChunksPerRow;
      const int e = (c % kChunksPerRow) * kChunk;
      cp_async16(ks + t * D + e, kg + t * tok_stride + e);
      cp_async16(vs + t * D + e, vg + t * tok_stride + e);
    }
    if constexpr (kQuantized<KT>) {
      float* kss = sc_s + (size_t)buf * 2 * page;
      const size_t s0 = (size_t)phys * page * kvh + g;
      for (int t = tid; t < page; t += D) {
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
  for (int i = tid; i < rep * D; i += D) q_s[i] = to_float(qg[i]);
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
      const Vec<KT, kLane> kv =
          *reinterpret_cast<const Vec<KT, kLane>*>(k_s + t * D + lane * kLane);
      float kf[kLane];
#pragma unroll
      for (int i = 0; i < kLane; ++i) kf[i] = to_float(kv.v[i]);
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
          const Vec<float, kLane> qr =
              *reinterpret_cast<const Vec<float, kLane>*>(q_s + r * D + lane * kLane);
          float part = 0.f;
#pragma unroll
          for (int i = 0; i < kLane; ++i) part += qr.v[i] * kf[i];
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
    for (int t = 0; t < page; ++t) {
      float vv = to_float(v_s[t * D + tid]);
      if constexpr (kQuantized<KT>) vv *= vsc[t];
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r)
        if (r < rep) acc[r] += s_s[r * page + t] * vv;
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
      ws_acc[row * D + tid] = acc[r];
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
  partial<<<dim3(a.kvh, a.B, a.n_split), D, smem, a.stream>>>(
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
// KVH) f32; dense pools take null there.  ws_acc: (B, H, n_split, D) f32
// and ws_ml: (B, H, n_split, 2) f32 scratch.  Returns a cudaError_t (0 = ok).
int paged_decode_attention(const void* q, const void* k_pages, const void* v_pages,
                           const void* k_scales, const void* v_scales,
                           const void* page_table, const void* pos, void* out,
                           void* ws_acc, void* ws_ml, int B, int kvh, int rep, int D,
                           int page, int n_blocks, int n_split, int window, float scale,
                           int q_dtype, int kv_dtype, void* stream) {
  if (rep < 1 || rep > kMaxRep || page < 1 || n_blocks < 1 || B < 1 || kvh < 1 ||
      n_split < 1)
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
  if (q_dtype == 0) return (int)dispatch_kv<float>(kv_dtype, D, a);
  if (q_dtype == 1) return (int)dispatch_kv<__nv_bfloat16>(kv_dtype, D, a);
  return (int)cudaErrorInvalidValue;
}

const char* paged_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
