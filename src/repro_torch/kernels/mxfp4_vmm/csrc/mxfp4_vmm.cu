// MXFP4 weight-streaming VMM for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/mxfp4_vmm/kernel.py::mxfp4_vmm (the RPU's Stream
// Decoder + TMAC stripe dataflow):
//
//   out[M, N] (f32, or rounded once to bf16) = x[M, K] (bf16) @ W[K, N],
//   W[k, n] = bf16( E2M1(code(k, n)) * 2^(scale(k / 32, n) - 127) )
//
// codes (K/2, N) uint8 hold two E2M1 codes per byte along K (low nibble =
// even k); scales (K/32, N) uint8 are E8M0 biased exponents.  The decoded
// weight is exact in bf16 (an E2M1 value has at most two significant bits)
// and every product is exact in f32, so the kernel computes the same
// function as the plain version (dequantize to bf16, f32-accumulating
// matmul) up to the order of the f32 sums.
//
// What bounds it: at decode (M = the slot batch, 1..16) it streams 0.53125
// bytes per weight element and does 2*M flops on it, far below the card's
// ridge, so it is bound by device-memory bytes (llama3-8b: 3.71 GB of codes
// and scales per decode step, 1.107 ms at 3.35 TB/s).  At prefill (M = the
// rows of a chunk batch, hundreds to thousands) it is bound by operations.
// The design:
//   * a CTA owns a 128-column stripe of the output and 16*MT rows of x, and
//     walks its share of K in 32-row stages (one MX block, so one scale per
//     column per stage); code bytes, scales and the x rows of a stage stream
//     into shared memory with 16-byte cp.async through a 6-stage ring, so
//     several stages are in flight while one is computed;
//   * K is split over gridDim.z when the (N, M) tiles alone would leave the
//     132 SMs idle (a decode step's 4096x1024 projections have only 8
//     stripes); the splits write f32 partials that a second small kernel
//     sums in a fixed order (deterministic, no atomics);
//   * the weights never exist in bf16 in device memory: each warp decodes
//     the code bytes it needs straight into mma.sync m16n8k16 B fragments.
//     One code byte is exactly the two consecutive k of one column that a
//     B register holds.  The columns of a warp's four n8 tiles are
//     interleaved (tile t, fragment column q = output column 4q + t), so a
//     thread's four code bytes of a row -- and its four scale bytes -- are
//     one 32-bit shared load.  A 256-entry table in shared memory maps a byte to
//     both E2M1 values as a bf16x2 word, a second one maps the scale byte s
//     to 2^(s-127) twice (built once per CTA with ldexpf: s = 0 gives the
//     subnormal 2^-127), and one bf16x2 multiply gives the fragment.  The
//     product of an E2M1 value and a power of two is exact in bf16, so this
//     is dequantize_mxfp4(..., bf16) bit for bit.  x is already bf16 (the
//     wrapper casts it, as the reference op does); the tensor cores
//     accumulate in f32.
// The result is written in f32, or rounded once to bf16 (what the serve
// path wants: the f32 sum, then a cast) by whichever kernel writes it last.
// Ragged edges are masked: rows past M load as zeros, columns past N as
// zero codes, and neither is written.  Any M >= 1, K a multiple of 32 and
// any N are accepted -- every shape the quantizer packs.
// wgmma/TMA and a persistent schedule are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBN = 128;             // output columns per CTA (4 warps x 32)
constexpr int kKT = 32;              // K rows per stage (one MX block)
constexpr int kThreads = 128;
constexpr int kStages = 6;
constexpr int kCodeRow = kBN + 32;   // padded shared row of code bytes
constexpr int kXRow = kKT + 8;       // padded shared row of x (bf16)

template <int MT>
struct Smem {
  alignas(16) uint8_t codes[kStages][kKT / 2][kCodeRow];
  alignas(16) uint8_t scales[kStages][kBN];
  alignas(16) uint16_t x[kStages][16 * MT][kXRow];   // bf16 bits
  uint32_t codes2[256];   // code byte -> bf16x2 (E2M1 lo, E2M1 hi)
  uint32_t scale2[256];   // scale byte s -> bf16x2 (2^(s-127), 2^(s-127))
};

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

// value = sign * (e == 0 ? 0.5 m : (1 + 0.5 m) 2^(e-1))
__device__ __forceinline__ float e2m1(int c) {
  const float sign = (c & 8) ? -1.f : 1.f;
  const int e = (c >> 1) & 3;
  const float m = static_cast<float>(c & 1);
  return sign * (e == 0 ? 0.5f * m : ldexpf(1.f + 0.5f * m, e - 1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 p = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// 8 consecutive outputs at a 16-byte aligned (bf16) or 32-byte (f32) place
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  u.x = pack_bf16x2(v[0], v[1]);
  u.y = pack_bf16x2(v[2], v[3]);
  u.z = pack_bf16x2(v[4], v[5]);
  u.w = pack_bf16x2(v[6], v[7]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int MT, typename OutT>
__global__ void __launch_bounds__(kThreads)
mxfp4_vmm_kernel(const __nv_bfloat16* __restrict__ x,   // (M, K)
                 const uint8_t* __restrict__ codes,     // (K/2, N)
                 const uint8_t* __restrict__ scales,    // (K/32, N)
                 OutT* __restrict__ out,                // (splits, M, N)
                 int M, int K, int N, int per, int vec) {
  constexpr int BM = 16 * MT;
  __shared__ Smem<MT> sm;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  const int k_tiles = K / kKT;
  const int kt0 = blockIdx.z * per;
  const int n_kt = min(per, k_tiles - kt0);
  const bool vec_cols = vec && n0 + kBN <= N;    // whole stripe, aligned rows

  for (int i = tid; i < 256; i += kThreads) {
    sm.codes2[i] = pack_bf16x2(e2m1(i & 15), e2m1(i >> 4));
    const float scale = ldexpf(1.f, i - 127);
    sm.scale2[i] = pack_bf16x2(scale, scale);
  }

  auto load_stage = [&](int kt, int s) {
    const uint8_t* cg = codes + (size_t)kt * (kKT / 2) * N + n0;
    const uint8_t* sg = scales + (size_t)kt * N + n0;
    if (vec_cols) {                  // 16 rows x 8 chunks: one per thread
      const int r = tid >> 3, c = (tid & 7) * 16;
      cp_async16(&sm.codes[s][r][c], cg + (size_t)r * N + c);
      if (tid < kBN / 16) cp_async16(&sm.scales[s][tid * 16], sg + tid * 16);
    } else {                         // ragged or unaligned stripe
      for (int i = tid; i < (kKT / 2) * kBN; i += kThreads) {
        const int r = i / kBN, c = i % kBN;
        sm.codes[s][r][c] = n0 + c < N ? cg[(size_t)r * N + c] : 0;
      }
      for (int c = tid; c < kBN; c += kThreads)
        sm.scales[s][c] = n0 + c < N ? sg[c] : 127;
    }
    for (int i = tid; i < BM * 4; i += kThreads) {   // 4 x 16 B per x row
      const int r = i >> 2, c = (i & 3) * 8;
      uint16_t* dst = &sm.x[s][r][c];
      if (m0 + r < M) {
        cp_async16(dst, x + (size_t)(m0 + r) * K + (size_t)kt * kKT + c);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
    }
  };

  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_kt) load_stage(kt0 + i, i);
    cp_async_commit();
  }

  const int cols = warp * 32 + (lane >> 2) * 4;     // + nt: tile nt's column
  for (int i = 0; i < n_kt; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // stage i landed; every warp is done with stage i-1
    const int nxt = i + kStages - 1;
    if (nxt < n_kt) load_stage(kt0 + nxt, nxt % kStages);
    cp_async_commit();

    const int s = i % kStages;
    const uint32_t sbytes = *reinterpret_cast<const uint32_t*>(&sm.scales[s][cols]);
    uint32_t sc[4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) sc[nt] = sm.scale2[(sbytes >> (8 * nt)) & 0xFF];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {                 // two k16 steps
      uint32_t a[MT][4];
      const int kc = ks * 16 + (lane & 3) * 2;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = mt * 16 + (lane >> 2);
        a[mt][0] = *reinterpret_cast<const uint32_t*>(&sm.x[s][r][kc]);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(&sm.x[s][r + 8][kc]);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(&sm.x[s][r][kc + 8]);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(&sm.x[s][r + 8][kc + 8]);
      }
      const int crow = ks * 8 + (lane & 3);
      const uint32_t c0 =                                        // k, k+1
          *reinterpret_cast<const uint32_t*>(&sm.codes[s][crow][cols]);
      const uint32_t c1 =                                        // k+8, k+9
          *reinterpret_cast<const uint32_t*>(&sm.codes[s][crow + 4][cols]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const uint32_t b0 = mul_bf16x2(sm.codes2[(c0 >> (8 * nt)) & 0xFF], sc[nt]);
        const uint32_t b1 = mul_bf16x2(sm.codes2[(c1 >> (8 * nt)) & 0xFF], sc[nt]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][nt], a[mt], b0, b1);
      }
    }
  }
  cp_async_wait<0>();

  // accumulator (mt, nt, 2h + e) is row 8h + lane/4 of tile mt and column
  // 4 * (2 * (lane % 4) + e) + nt = 8 * (lane % 4) + 4e + nt of the warp's
  // 32 columns: each thread holds 8 consecutive columns of its rows, and
  // the 4 threads of a row hold 32, so a row is one coalesced vector store
  OutT* dst = out + (size_t)blockIdx.z * M * N;
  const int nb = n0 + warp * 32 + (lane & 3) * 8;
  const bool vec_out = (N & 7) == 0 && nb + 8 <= N;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + mt * 16 + (lane >> 2) + h * 8;
      if (m >= M) continue;
      float v[8];
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) v[4 * e + nt] = acc[mt][nt][2 * h + e];
      OutT* row = dst + (size_t)m * N + nb;
      if (vec_out) {
        store8(row, v);
      } else {
        for (int c = 0; c < 8 && nb + c < N; ++c) store(row + c, v[c]);
      }
    }
  }
}

// out[i] = sum over splits of ws[split][i], in split order
template <typename OutT>
__global__ void mxfp4_vmm_reduce(const float* __restrict__ ws, OutT* __restrict__ out,
                                 size_t mn, int splits) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < splits; ++p) s += ws[(size_t)p * mn + i];
    store(out + i, s);
  }
}

template <int MT, typename OutT>
cudaError_t launch(const void* x, const void* codes, const void* scales, OutT* part,
                   int M, int K, int N, int splits, int per, int vec, cudaStream_t s) {
  const dim3 grid((N + kBN - 1) / kBN, (M + 16 * MT - 1) / (16 * MT), splits);
  mxfp4_vmm_kernel<MT, OutT><<<grid, kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(codes),
      static_cast<const uint8_t*>(scales), part, M, K, N, per, vec);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_rows(const void* x, const void* codes, const void* scales, OutT* part,
                        int M, int K, int N, int splits, int per, int vec,
                        cudaStream_t s) {
  if (M <= 16) return launch<1>(x, codes, scales, part, M, K, N, splits, per, vec, s);
  if (M <= 32) return launch<2>(x, codes, scales, part, M, K, N, splits, per, vec, s);
  return launch<4>(x, codes, scales, part, M, K, N, splits, per, vec, s);
}

}  // namespace

extern "C" {

// x (M, K) bf16, codes (K/2, N) u8, scales (K/32, N) u8, out (M, N) f32
// (out_bf16 == 0) or bf16; ws (splits, M, N) f32 scratch when splits > 1.
// K % 32 == 0; the splits cover K in chunks of per 32-row stages (splits ==
// ceil(K/32 / per)).  vec != 0 promises N % 16 == 0 and 16-byte aligned
// codes/scales.  x must be 16-byte aligned.  Returns a cudaError_t (0 = ok).
int mxfp4_vmm(const void* x, const void* codes, const void* scales, void* out,
              void* ws, int M, int K, int N, int splits, int per, int vec,
              int out_bf16, void* stream) {
  if (M < 1 || N < 1 || K < kKT || K % kKT != 0 || splits < 1 || per < 1 ||
      (splits - 1) * per >= K / kKT || splits * per < K / kKT)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* out_b = static_cast<__nv_bfloat16*>(out);
  float* out_f = static_cast<float*>(out);
  if (splits == 1)
    return (int)(out_bf16 ? launch_rows(x, codes, scales, out_b, M, K, N, 1, per, vec, s)
                          : launch_rows(x, codes, scales, out_f, M, K, N, 1, per, vec, s));
  float* part = static_cast<float*>(ws);
  cudaError_t e = launch_rows(x, codes, scales, part, M, K, N, splits, per, vec, s);
  if (e != cudaSuccess) return (int)e;
  const size_t mn = (size_t)M * N;
  const int blocks = (int)((mn + 255) / 256 < 4096 ? (mn + 255) / 256 : 4096);
  if (out_bf16)
    mxfp4_vmm_reduce<<<blocks, 256, 0, s>>>(part, out_b, mn, splits);
  else
    mxfp4_vmm_reduce<<<blocks, 256, 0, s>>>(part, out_f, mn, splits);
  return (int)cudaGetLastError();
}

const char* mxfp4_vmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
