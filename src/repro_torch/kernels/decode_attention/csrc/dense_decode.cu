// Dense-cache single-token GQA flash-decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention/kernel.py:67 (decode_attention, its
// pallas_call at :90):
//
//   out[b, g*rep + r, :] = softmax_t(q[b, g*rep + r] . K[b, t, g] * scale) @ V[b, :, g]
//
// over the valid prefix t < cur_len[b] of a dense (B, S, KVH, D) cache --
// the static serve engine's decode step and the legacy speculative
// engine's draft and target steps, where row b's cache holds positions
// 0 .. cur_pos.
//
// What bounds it: it reads every valid K/V byte once and does ~4 flops per
// element read (rep 4: 2 per multiply-add, q.k and p.v), far below the
// card's ~295 flop/byte ridge, so it is bound by device-memory bytes, and
// what matters is how many bytes are in flight and how short the chain of
// dependent instructions per token is.  The first version (32-token
// tiles double-buffered, three block barriers a tile, CUDA-core dot
// products with a 5-shuffle warp reduction per (token, query row), P.V as
// FMAs from scores in shared memory, a second kernel to fold the splits,
// the split count sized from the cache length S) read 0.0731 ms at B 8,
// KVH 8, D 128, cur_len 1088 of 2048: 6.8x its bound and 2.5x slower than
// SDPA (NVIDIA H100 80GB HBM3, 700 W).
//
// bf16 q over a bf16 cache at D 64 / 128 (dense_decode_tc, the serve path) now:
//   * one CTA per (split, kv head, row) of 4 warps walks the split's share
//     of the row's valid 64-token tiles.  Warp w owns tokens 16w..16w+15 of
//     each tile: it copies them itself with cp.async (tokens at or past
//     cur_len zero-filled, never read) into a 3-stage ring, so a tile needs
//     no block barrier, only the warp's own wait; a CTA keeps two tiles
//     (64 KB at D 128) in flight, two CTAs an SM;
//   * scores on the tensor cores: the rep query heads of kv head g, padded
//     to 16 rows, are the M dimension of mma.m16n8k16 (A from q in shared
//     memory by ldmatrix), K the B operand by ldmatrix; products of bf16
//     are exact in the f32 accumulator.  Padding the rows rather than
//     making the tokens M keeps the score accumulator in the exact layout
//     of P.V's A operand (no shuffle or shared-memory round trip), and any
//     rep up to 16 fits one M tile; the wasted rows cost tensor-core time
//     the kernel has to spare (~16 flop/byte at rep 4);
//   * P.V on the tensor cores without losing f32 precision: P = hi + lo,
//     two bf16 values (16 bits of P's mantissa), two mma each with V by
//     ldmatrix.trans, f32 accumulation;
//   * the online softmax per warp in f32 with exp2f (scale * log2 e folded
//     into one FMA); the mask only on the tile that holds cur_len;
//   * the split count is as many CTAs as one wave holds (two an SM), at
//     most one per tile of the cache's S; a split takes an even share of
//     its row's valid tiles (shares differ by one at most), so each row
//     walks only its own cur_len and a split with no tile exits at once;
//   * one launch: the warps fold their states in the CTA, each CTA writes
//     its split's (m, l, acc), and the last CTA of (b, g) to finish -- an
//     integer counter per (b, g), zeroed once when the wrapper allocates it
//     and reset by that CTA -- folds the splits in split order.  No float
//     atomics: sampled streams reproduce bit for bit.
//
// Every other dtype pairing (the f32 caches of the parity checks, f32 q
// over bf16) keeps the first version's CUDA-core kernels
// (dense_decode_partial + dense_decode_combine), chosen by dtype and head
// dim before the launch (kernel.py: variant()), so card-vs-CPU stream
// checks are undisturbed.  So does D 256: its 211 KB ring would fit one
// CTA an SM, a layout not yet measured on the card.  Partial kernel: one CTA per (kv head g, row b, split s), D
// threads, 32-token tiles; warps take tokens, the rep dot products reduce
// across the warp by shuffles; one warp per query row folds the tile's
// scores into (m, l); thread d accumulates acc[r][d] += p[r][t] * V[t][d].
// The combine kernel rescales the splits to a common max, sums, divides by
// max(l, 1e-30) and writes in q's dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRep = 16;        // query heads per kv head (registers)
constexpr int kTile = 32;          // tokens per staged tile (CUDA-core kernel)
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

// ---------------------------------------------------------------------------
// CUDA cores: every other dtype pairing
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// bf16 q over a bf16 cache: tensor cores, one launch
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kTile = 64;          // tokens per tile: 16 per warp
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;         // cp.async ring depth

template <int D>
struct Cfg {
  static constexpr int kRow = 2 * D + 16;                 // padded bf16 row, bytes
  static constexpr int kSlice = 16 * kRow;                // a warp's 16 tokens of K or V
  static constexpr int kStageBytes = kWarps * 2 * kSlice; // K and V of one tile
  static constexpr int kQBytes = 16 * kRow;               // q padded to 16 rows
  static constexpr int kSmem = kQBytes + kStages * kStageBytes;
  // the warps' (m, l, acc) for the in-CTA fold, over the ring once it is idle
  static_assert(kWarps * 16 * (D + 10) * 4 <= kStages * kStageBytes, "fold area");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes, or 16 zero bytes when src_bytes is 0 (nothing is read)
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src,
                                                 int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
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

// One CTA per (split, kv head g, row b): 4 warps walk the split's share of
// the row's valid 64-token tiles, warp w owning tokens 16w..16w+15 of each
// tile (it loads, scores and folds them itself: no block barrier in the
// loop).  Query rows g*rep .. g*rep+rep-1 are the M dimension of
// mma.m16n8k16, padded to 16 with zeros.  Then the warps fold their states
// in the CTA, the CTA writes its split's partial (m, l, acc), and the last
// CTA of (b, g) to finish folds every split in split order.
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
dense_decode_tc(const __nv_bfloat16* __restrict__ q,        // (B, H, D)
                const __nv_bfloat16* __restrict__ k_cache,  // (B, S, KVH, D)
                const __nv_bfloat16* __restrict__ v_cache,  // (B, S, KVH, D)
                const int* __restrict__ cur_len,            // (B,)
                __nv_bfloat16* __restrict__ out,            // (B, H, D)
                float* __restrict__ ws_acc,   // (B * KVH, n_split, rep, D)
                float* __restrict__ ws_ml,    // (B * KVH, n_split, rep, 2)
                int* __restrict__ counters,   // (>= B * KVH,), zero between calls
                int S, int kvh, int rep, float scale_log2) {
  using C = Cfg<D>;
  constexpr int kChunks = D / 8;                 // 16-byte chunks per row
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

  int len = cur_len[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  const int n_tiles = (len + kTile - 1) / kTile;
  const int j0 = split * n_tiles / n_split;       // this split's tiles [j0, j1):
  const int j1 = (split + 1) * n_tiles / n_split; // shares differ by one at most

  // q rows of kv head g, zero-padded to 16 rows
  const __nv_bfloat16* qg = q + ((size_t)b * kvh * rep + (size_t)g * rep) * D;
  for (int c = tid; c < 16 * kChunks; c += kThreads) {
    const int r = c / kChunks, e = (c % kChunks) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < rep) val = *reinterpret_cast<const uint4*>(qg + r * D + e);
    *reinterpret_cast<uint4*>(smem + r * C::kRow + e * 2) = val;
  }

  const size_t tok_stride = (size_t)kvh * D;
  const __nv_bfloat16* kg = k_cache + ((size_t)b * S * kvh + g) * D;
  const __nv_bfloat16* vg = v_cache + ((size_t)b * S * kvh + g) * D;
  const uint32_t my_k = ring + warp * 2 * C::kSlice;     // + stage * kStageBytes
  const uint32_t my_v = my_k + C::kSlice;
  // this warp's 16 tokens of tile j into a stage; tokens at or past len
  // are zero-filled, never read.  Always one commit group per call.
  auto issue = [&](int j, int stage) {
    if (j < j1) {
      const int tok0 = j * kTile + warp * 16;
      const uint32_t ks = my_k + stage * C::kStageBytes;
      const uint32_t vs = my_v + stage * C::kStageBytes;
#pragma unroll
      for (int c = lane; c < 16 * kChunks; c += 32) {
        const int r = c / kChunks, e = (c % kChunks) * 8;
        const bool live = tok0 + r < len;
        const size_t off = live ? (size_t)(tok0 + r) * tok_stride + e : 0;
        cp_async16_zfill(ks + r * C::kRow + e * 2, kg + off, live ? 16 : 0);
        cp_async16_zfill(vs + r * C::kRow + e * 2, vg + off, live ? 16 : 0);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) issue(j0 + p, p);
  __syncthreads();                   // q is in shared memory

  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.f, 0.f};
  // ldmatrix row addresses: A (q) matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15);
  // K's B matrices (tokens 0-7 | 8-15) x (d 0-7 | 8-15); V's, transposed
  const int mi = lane >> 3;
  const uint32_t qa_addr = q_s + ((lane & 7) + (mi & 1) * 8) * C::kRow + (mi >> 1) * 16;
  const uint32_t kb_off = ((lane & 7) + (mi >> 1) * 8) * C::kRow + (mi & 1) * 16;
  const uint32_t vb_off = ((lane & 7) + (mi & 1) * 8) * C::kRow + (mi >> 1) * 16;

  for (int j = j0; j < j1; ++j) {
    const int stage = (j - j0) % kStages;
    issue(j + kStages - 1, (j - j0 + kStages - 1) % kStages);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1));
    __syncwarp();
    const uint32_t ks = my_k + stage * C::kStageBytes;
    const uint32_t vs = my_v + stage * C::kStageBytes;

    // scores of 16 query rows x this warp's 16 tokens, exact products of
    // bf16 in f32
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], kb[4];
      ldmatrix_x4(a, qa_addr + kk * 32);
      ldmatrix_x4(kb, ks + kb_off + kk * 32);
      mma_bf16(sc[0], a, kb[0], kb[1]);
      mma_bf16(sc[1], a, kb[2], kb[3]);
    }
    const int tok0 = j * kTile + warp * 16;
    const bool edge = tok0 + 16 > len;
    if (edge) {
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (tok0 + nb * 8 + 2 * quad + (e & 1) >= len) sc[nb][e] = kNegInf;
    }
    // online softmax per row, log2 domain
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = fmaxf(fmaxf(sc[0][2 * hh], sc[0][2 * hh + 1]),
                       fmaxf(sc[1][2 * hh], sc[1][2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[hh], mx * scale_log2);
      const float corr = exp2f(m_r[hh] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[nb][2 * hh + e];
          const bool dead = edge && tok0 + nb * 8 + 2 * quad + e >= len;
          x = dead ? 0.f : exp2f(fmaf(x, scale_log2, -m_new));
          sum += x;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_r[hh] = l_r[hh] * corr + sum;
      m_r[hh] = m_new;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        o[dt][2 * hh] *= corr;
        o[dt][2 * hh + 1] *= corr;
      }
    }
    // O += P V with P = hi + lo (two bf16 mma): the score accumulators are
    // the A fragment of the 16-token k-step
    uint32_t ph[4], pl[4];
    split_bf16x2(sc[0][0], sc[0][1], ph[0], pl[0]);
    split_bf16x2(sc[0][2], sc[0][3], ph[1], pl[1]);
    split_bf16x2(sc[1][0], sc[1][1], ph[2], pl[2]);
    split_bf16x2(sc[1][2], sc[1][3], ph[3], pl[3]);
#pragma unroll
    for (int dt = 0; dt < D / 8; dt += 2) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, vs + vb_off + dt * 16);
      mma_bf16(o[dt], ph, vb[0], vb[1]);
      mma_bf16(o[dt], pl, vb[0], vb[1]);
      mma_bf16(o[dt + 1], ph, vb[2], vb[3]);
      mma_bf16(o[dt + 1], pl, vb[2], vb[3]);
    }
    __syncwarp();                    // the stage is refilled next iteration
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();                   // the ring is idle: fold area

  // fold the 4 warps: (m, l) per row, then acc (rows padded by 8 floats so
  // a warp's float2 stores spread over the banks)
  constexpr int kAccRow = D + 8;
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
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(acc_s + (warp * 16 + gq + 8 * hh) * kAccRow + dt * 8 +
                                 2 * quad) = make_float2(o[dt][2 * hh], o[dt][2 * hh + 1]);
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
      a += acc_s[(w * 16 + r) * kAccRow + d] * wt;
    }
    ws_acc[(part * rep + r) * D + d] = a;
    if (d == 0) {
      ws_ml[(part * rep + r) * 2] = mx;
      ws_ml[(part * rep + r) * 2 + 1] = l;
    }
  }

  // the last CTA of (b, g) to finish folds the splits in split order
  __threadfence();
  __syncthreads();
  __shared__ int last;
  if (tid == 0) last = atomicAdd(counters + bg, 1) == n_split - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const size_t part0 = (size_t)bg * n_split;
  for (int i = tid; i < rep * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float mx = kNegInf;
    for (int s = 0; s < n_split; ++s)
      mx = fmaxf(mx, __ldcg(ws_ml + ((part0 + s) * rep + r) * 2));
    float l = 0.f, a = 0.f;
    for (int s = 0; s < n_split; ++s) {
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

template <int D>
cudaError_t launch_tc(const Args& a, int* counters) {
  using C = tc::Cfg<D>;
  auto kernel = tc::dense_decode_tc<D>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(a.n_split, a.kvh, a.B), tc::kThreads, C::kSmem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), a.cur_len, static_cast<__nv_bfloat16*>(a.out),
      a.ws_acc, a.ws_ml, counters, a.S, a.kvh, a.rep, a.scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, H, D), caches (B, S, KVH, D), cur_len (B,) int32 (each in [1, S];
// larger values are clamped to S), out (B, H, D); ws_acc: B H n_split D f32
// and ws_ml: B H n_split 2 f32 scratch.  variant (chosen by the host):
//   0  CUDA cores, dtype codes 0 = float32, 1 = bfloat16 for q and the cache
//      (two launches: partial and combine);
//   1  tensor cores, bf16 q over a bf16 cache, D 64/128 (one launch); counters: B KVH
//      int32, zero before the call and zero again after it.
// Returns a cudaError_t (0 = ok).
int dense_decode_attention(const void* q, const void* k_cache, const void* v_cache,
                           const void* cur_len, void* out, void* ws_acc, void* ws_ml,
                           void* counters, int B, int S, int kvh, int rep, int D,
                           int n_split, float scale, int q_dtype, int kv_dtype,
                           int variant, void* stream) {
  if (rep < 1 || rep > kMaxRep || S < 1 || B < 1 || kvh < 1 || n_split < 1 ||
      B > 65535 || n_split > 65535 || kvh > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k_cache, v_cache, static_cast<const int*>(cur_len), out,
               static_cast<float*>(ws_acc), static_cast<float*>(ws_ml),
               B, S, kvh, rep, n_split, scale, static_cast<cudaStream_t>(stream)};
  if (variant == 1) {
    if (q_dtype != 1 || kv_dtype != 1 || counters == nullptr)
      return (int)cudaErrorInvalidValue;
    int* cnt = static_cast<int*>(counters);
    switch (D) {
      case 64: return (int)launch_tc<64>(a, cnt);
      case 128: return (int)launch_tc<128>(a, cnt);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
  if (q_dtype == 0) return (int)dispatch_kv<float>(kv_dtype, D, a);
  if (q_dtype == 1) return (int)dispatch_kv<__nv_bfloat16>(kv_dtype, D, a);
  return (int)cudaErrorInvalidValue;
}

const char* dense_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
