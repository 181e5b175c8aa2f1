// Flash-attention forward (prefill / full-sequence scoring) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py::flash_attention together with
// its GQA op wrapper (src/repro/kernels/flash_attention/ops.py):
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
// does ~4 S^2 D / 2 flops per (b, h) on 4 S D elements, far above the card's
// ~295 flop/byte ridge, so it is bound by operations.  The design:
//   * a CTA owns 64 query rows of one (b, h) pair and walks the key tiles of
//     64 keys that its rows can see -- when causal it stops at the diagonal,
//     so key tiles wholly above it are never loaded; CTAs of the largest
//     query blocks (the most tiles) are launched first;
//   * the (64 x 64) score tile and the (m, l, acc) state stay on chip, so
//     device memory sees q, k, v read and out written, and nothing else;
//   * bf16 inputs: four warps of 16 query rows each run QK^T and PV as
//     mma.sync m16n8k16 bf16 -> f32 on the tensor cores.  The score
//     accumulators are re-packed in registers as the A fragments of the PV
//     product (P rounded to bf16 there, as FlashAttention-2 does; the row
//     sums l use the f32 values); V's B fragments come from ldmatrix.trans.
//     K/V tiles are double-buffered in shared memory with cp.async, rows
//     padded by 16 bytes so the fragment loads hit 32 distinct banks;
//   * f32 inputs (the parity checks run the model in f32): the same tiling
//     on CUDA cores in full f32 FMAs, 16 x 16 threads each holding a 4 x 4
//     block of scores and a 4 x D/16 block of the accumulator, so the result
//     differs from the plain version only in the order of the f32 sums.
// Ragged Sq and Skv are masked: query rows past Sq load as zeros and are not
// written; keys past Skv load as zeros and score NEG_INF.  wgmma/TMA and a
// persistent schedule are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
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

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

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
cudaError_t dispatch_dtype(int dtype, const Args& a) {
  if (dtype == 0) return launch_f32<D>(a);
  if (dtype == 1) return launch_bf16<D>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q (B, Sq, H, D), k / v (B, Skv, KVH, D), out (B, Sq, H, D), all contiguous
// and 16-byte aligned, of one dtype: 0 = float32, 1 = bfloat16.  D in
// {32, 64, 128}; H a multiple of KVH; causal: 0 or 1 (top-left aligned).
// Returns a cudaError_t (0 = ok).
int flash_attention(const void* q, const void* k, const void* v, void* out, int B,
                    int Sq, int Skv, int H, int KVH, int D, int causal, float scale,
                    int dtype, void* stream) {
  if (B < 1 || Sq < 1 || Skv < 1 || KVH < 1 || H < KVH || H % KVH != 0 || B > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, out, B, Sq, Skv, H, KVH, causal != 0, scale,
               static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 32: return (int)dispatch_dtype<32>(dtype, a);
    case 64: return (int)dispatch_dtype<64>(dtype, a);
    case 128: return (int)dispatch_dtype<128>(dtype, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
