// Dense-cache single-token GQA flash-decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention/kernel.py::decode_attention:
//
//   out[b, g*rep + r, :] = softmax_t(q[b, g*rep + r] . K[b, t, g] * scale) @ V[b, :, g]
//
// over the valid prefix t < cur_len[b] of a dense (B, S, KVH, D) cache --
// the static serve engine's decode step, where row b's cache holds
// positions 0 .. cur_pos.
//
// What bounds it: like the paged kernel (paged_decode.cu) it reads every
// valid K/V byte once and does ~4 flops per element read, far below the
// card's ~295 flop/byte ridge, so it is bound by device-memory bytes.  The
// design is the paged kernel's with the page table replaced by direct
// addressing:
//   * each row's loop is bounded by its own cur_len: the cache is walked in
//     tiles of 32 tokens, only the tiles below cur_len are visited, and in
//     the last one the tokens at or past cur_len are zero-filled in shared
//     memory instead of loaded (they score NEG_INF), so the dead tail of
//     the preallocated cache is never read;
//   * each row's valid tiles are split over n_split CTAs (flash-decoding),
//     so B x KVH (kv head, row) pairs still put several CTAs on every SM,
//     and a second small kernel folds the n_split partial states in a fixed
//     order (no atomics: sampled streams reproduce bit for bit);
//   * q (the rep query heads of one kv head), the scores and the
//     online-softmax state (m, l, acc) stay on chip in f32;
//   * tiles are double-buffered in shared memory with cp.async, so the next
//     tile's K/V stream in while the current one is folded.
//
// Partial kernel: one CTA per (kv head g, row b, split s), D threads.  Per
// tile of its share: warps take tokens, each lane holding D/32 elements of
// the K row, the rep dot products reduce across the warp by shuffles; one
// warp per query row folds the tile's scores into (m, l); thread d
// accumulates acc[r][d] += p[r][t] * V[t][d] in registers.  It writes its
// unnormalised (m, l, acc) to a workspace; the combine kernel rescales the
// splits to a common max, sums, divides by max(l, 1e-30) and writes in q's
// dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRep = 16;        // query heads per kv head (registers)
constexpr int kTile = 32;          // tokens per staged tile
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared memory layout (floats first, then two staged K/V tiles):
//   q_s[rep][D] f32 | s_s[rep][kTile] f32 | m_s, l_s, c_s [rep] f32 | pad16 |
//   kv_s[2 buffers][K, V][kTile][D] KT
__host__ __device__ inline size_t float_words(int rep, int D) {
  size_t n = (size_t)rep * D + (size_t)rep * kTile + 3 * (size_t)rep;
  return (n + 3) & ~(size_t)3;     // 16-byte align the K/V staging area
}

template <typename KT>
__host__ __device__ inline size_t smem_bytes(int rep, int D) {
  return float_words(rep, D) * sizeof(float) + 4 * (size_t)kTile * D * sizeof(KT);
}

template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(D)
dense_decode_partial(const QT* __restrict__ q,          // (B, H, D)
                     const KT* __restrict__ k_cache,    // (B, S, KVH, D)
                     const KT* __restrict__ v_cache,    // (B, S, KVH, D)
                     const int* __restrict__ cur_len,   // (B,)
                     float* __restrict__ ws_acc,        // (B, H, n_split, D)
                     float* __restrict__ ws_ml,         // (B, H, n_split, 2)
                     int S, int kvh, int rep, int n_split, float scale) {
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
  float* m_s = s_s + rep * kTile;
  float* l_s = m_s + rep;
  float* c_s = l_s + rep;
  KT* kv_s = reinterpret_cast<KT*>(q_s + float_words(rep, D));
  constexpr int kTileElems = kTile * D;         // one K or V tile of head g

  // this CTA's share [j0, j1] of the row's valid tiles
  int len = cur_len[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  const int n_tiles = (len + kTile - 1) / kTile;
  const int per = (n_tiles + n_split - 1) / n_split;
  const int j0 = split * per;
  int j1 = j0 + per - 1;
  if (j1 > n_tiles - 1) j1 = n_tiles - 1;

  const size_t tok_stride = (size_t)kvh * D;    // elements between tokens
  const KT* kg = k_cache + ((size_t)b * S * kvh + g) * D;
  const KT* vg = v_cache + ((size_t)b * S * kvh + g) * D;
  auto issue = [&](int j, int buf) {
    KT* ks = kv_s + (size_t)buf * 2 * kTileElems;
    KT* vs = ks + kTileElems;
    for (int c = tid; c < kTile * kChunksPerRow; c += D) {
      const int t = c / kChunksPerRow;
      const int e = (c % kChunksPerRow) * kChunk;
      const int tok = j * kTile + t;
      if (tok < len) {
        cp_async16(ks + t * D + e, kg + tok * tok_stride + e);
        cp_async16(vs + t * D + e, vg + tok * tok_stride + e);
      } else {                       // past cur_len: never read
        *reinterpret_cast<uint4*>(ks + t * D + e) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(vs + t * D + e) = make_uint4(0, 0, 0, 0);
      }
    }
    cp_async_commit();
  };
  if (j0 <= j1) issue(j0, 0);

  // query rows g*rep .. g*rep+rep-1 of row b are contiguous
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
    if (j < j1) {                      // prefetch the next tile, then wait
      issue(j + 1, buf ^ 1);           // for this one only
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const KT* k_s = kv_s + (size_t)buf * 2 * kTileElems;
    const KT* v_s = k_s + kTileElems;

    // scores s[r][t] = q_r . k_t * scale (NEG_INF past cur_len)
    for (int t = warp; t < kTile; t += kWarps) {
      const Vec<KT, kLane> kv =
          *reinterpret_cast<const Vec<KT, kLane>*>(k_s + t * D + lane * kLane);
      float kf[kLane];
#pragma unroll
      for (int i = 0; i < kLane; ++i) kf[i] = to_float(kv.v[i]);
      const bool ok = j * kTile + t < len;
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) {
        if (r < rep) {
          const Vec<float, kLane> qr =
              *reinterpret_cast<const Vec<float, kLane>*>(q_s + r * D + lane * kLane);
          float part = 0.f;
#pragma unroll
          for (int i = 0; i < kLane; ++i) part += qr.v[i] * kf[i];
          part = warp_sum(part);
          if (lane == 0) s_s[r * kTile + t] = ok ? part * scale : kNegInf;
        }
      }
    }
    __syncthreads();

    // online softmax: fold this tile into (m, l); p overwrites s
    for (int r = warp; r < rep; r += kWarps) {
      float* sr = s_s + r * kTile;
      const float x = sr[lane];         // kTile == 32: one score per lane
      const float mx = warp_max(x);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float e = expf(x - m_new);
      sr[lane] = e;
      const float sum = warp_sum(e);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc[r][d] = acc[r][d] * corr[r] + sum_t p[r][t] * V[t][d]
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r)
      if (r < rep) acc[r] *= c_s[r];
    for (int t = 0; t < kTile; ++t) {
      const float vv = to_float(v_s[t * D + tid]);
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r)
        if (r < rep) acc[r] += s_s[r * kTile + t] * vv;
    }
    __syncthreads();   // buf is refilled by the next iteration's prefetch
  }

  // unnormalised partial state of this split (m = NEG_INF, l = 0 when the
  // split got no tile)
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
dense_decode_combine(const float* __restrict__ ws_acc, const float* __restrict__ ws_ml,
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
  const int* cur_len;
  void* out;
  float *ws_acc, *ws_ml;
  int B, S, kvh, rep, n_split;
  float scale;
  cudaStream_t stream;
};

template <typename QT, typename KT, int D>
cudaError_t launch(const Args& a) {
  auto partial = dense_decode_partial<QT, KT, D>;
  const size_t smem = smem_bytes<KT>(a.rep, D);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        partial, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  partial<<<dim3(a.kvh, a.B, a.n_split), D, smem, a.stream>>>(
      static_cast<const QT*>(a.q), static_cast<const KT*>(a.k),
      static_cast<const KT*>(a.v), a.cur_len, a.ws_acc, a.ws_ml, a.S, a.kvh,
      a.rep, a.n_split, a.scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dense_decode_combine<QT, D><<<a.B * a.kvh * a.rep, D, 0, a.stream>>>(
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
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16.  q (B, H, D), caches (B, S, KVH,
// D), cur_len (B,) int32 (each in [1, S]; larger values are clamped to S),
// out (B, H, D); ws_acc: (B, H, n_split, D) f32 and ws_ml: (B, H, n_split,
// 2) f32 scratch.  Returns a cudaError_t (0 = ok).
int dense_decode_attention(const void* q, const void* k_cache, const void* v_cache,
                           const void* cur_len, void* out, void* ws_acc, void* ws_ml,
                           int B, int S, int kvh, int rep, int D, int n_split,
                           float scale, int q_dtype, int kv_dtype, void* stream) {
  if (rep < 1 || rep > kMaxRep || S < 1 || B < 1 || kvh < 1 || n_split < 1 ||
      B > 65535 || n_split > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k_cache, v_cache, static_cast<const int*>(cur_len), out,
               static_cast<float*>(ws_acc), static_cast<float*>(ws_ml),
               B, S, kvh, rep, n_split, scale, static_cast<cudaStream_t>(stream)};
  if (q_dtype == 0) return (int)dispatch_kv<float>(kv_dtype, D, a);
  if (q_dtype == 1) return (int)dispatch_kv<__nv_bfloat16>(kv_dtype, D, a);
  return (int)cudaErrorInvalidValue;
}

const char* dense_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
