// Block-quantized matmul for Hopper (sm_90a): K7, (M,K) float32 or
// bfloat16 activations x (K,N) ggml-family weights in plane layout ->
// (M,N) float32, in two variants.
//
// Replaces qmatmul_pallas in src/repro/kernels/qmatmul/kernel.py: grid
// (M/bm, N/bn, K/bk), K innermost, an f32 VMEM accumulator, and
//   * dequant_dot (_dequant_tile + _qmatmul_dequant_kernel): dequantize
//     the (bk, bn) weight tile from its planes on the VPU, then an f32
//     dot on the MXU -- llama.cpp's "dequantize + GEMM";
//   * dot_i8 (_qmatmul_i8_kernel, q8_0 only): quantize the activation
//     tile per (row, 32-wide k-block) to int8, int8 x int8 -> int32 per
//     block, then the f32 epilogue part * x_scale * w_scale summed over
//     blocks -- llama.cpp's dp4a vec_dot, the integer pipe the CMP 170HX
//     leaves unthrottled (Path.DOT_I8).
//
// Planes (repro_torch/quant/quantize.py), all row-major along K:
//   q8_0  values int8 (K,N), super_scales f32 (K/32,N)
//   q6_k  values int8 (K,N), sub_scales int8 (K/16,N), super f32 (K/256,N)
//   q4_k  values uint8 (K/2,N), 2 per byte; sub scales/mins int8 (K/32,N)
//   q2_k  values uint8 (K/4,N), 4 per byte; sub scales/mins int8 (K/16,N)
//         super scales/mins f32 (K/256,N)
// Element k of a packed column sits in byte row k / per at bit
// bits * (k % per), low bits first.
//
// Numbers: every weight is dequantized with exactly the reference's
// algebra -- sub * super, an effective scale of 0 read as 1, value *
// scale, and for q4_k/q2_k q * eff_d - eff_m as a multiply and then a
// subtract, each rounded (__fmul_rn, __fsub_rn: nvcc may not fuse them)
// -- so the tile equals the plain version's dequantize bit for bit and
// only the order of the f32 sums differs.  dot_i8 quantizes x with IEEE
// division (amax / 127, then x / scale) and rintf (round half to even),
// so its int8 values equal the plain version's; the int32 block dots are
// exact (__dp4a), and the epilogue multiplies by x_scale, then w_scale,
// then adds, each rounded, as the reference orders it.
//
// What bounds it on the H100: at the qwen2.5-1.5b MLP shapes (K x N =
// 1536 x 8960 or 8960 x 1536, M = 8 or 128) the weight planes are 7 to
// 15 MB and the product 0.2 to 3.5 GFLOP: bytes-bound at M = 8 and near
// the knee at M = 128 on the tensor cores' rates (the bound chip_smoke
// reports); this first kernel computes on the CUDA cores.
//
// What the design does, simply: one CTA of 256 threads per 32 x 64
// output tile, each thread a 2 x 4 register block.  dequant_dot stages
// 32 deep: the x tile as f32, the weight tile dequantized to f32 in
// shared memory, then fmaf into the accumulators (tensor cores for this
// arm are for later).  dot_i8 stages 128 deep (four q8_0 blocks): each
// warp quantizes (row, block) pairs of x into int8 words in shared
// memory with a warp max, the int8 weight tile is transposed so that
// four consecutive k of one column form one 32-bit word, and eight
// __dp4a per block give the exact int32 dot.  Left for later: int8 and
// bf16 mma, TMA, and split-K for small M.
//
// C interface (loaded with ctypes): qmatmul_fwd returns the cudaError_t
// of the launch; it allocates nothing and launches on the stream it is
// given.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;
constexpr int BN = 64;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// format codes: 0 q8_0, 1 q6_k, 2 q4_k, 3 q2_k
template <int F> struct Fmt;
template <> struct Fmt<0> {
  static constexpr int kBlock = 32, kSub = 32, kBits = 8, kPer = 1;
};
template <> struct Fmt<1> {
  static constexpr int kBlock = 256, kSub = 16, kBits = 8, kPer = 1;
};
template <> struct Fmt<2> {
  static constexpr int kBlock = 256, kSub = 32, kBits = 4, kPer = 2;
};
template <> struct Fmt<3> {
  static constexpr int kBlock = 256, kSub = 16, kBits = 2, kPer = 4;
};

__device__ __forceinline__ float one_if_zero(float v) {
  return v == 0.0f ? 1.0f : v;
}

// The dequantized weight at (k, n): _dequant_tile's algebra.
template <int F>
__device__ __forceinline__ float dequant(const void* __restrict__ values,
                                         const int8_t* __restrict__ sub_s,
                                         const int8_t* __restrict__ sub_m,
                                         const float* __restrict__ sup_s,
                                         const float* __restrict__ sup_m,
                                         int k, int n, int N) {
  using P = Fmt<F>;
  const float d_super = sup_s[(int64_t)(k / P::kBlock) * N + n];
  if constexpr (F == 0) {
    const int8_t v = ((const int8_t*)values)[(int64_t)k * N + n];
    return __fmul_rn((float)v, d_super);
  } else if constexpr (F == 1) {
    const int8_t v = ((const int8_t*)values)[(int64_t)k * N + n];
    const int64_t s = (int64_t)(k / P::kSub) * N + n;
    const float eff = one_if_zero(__fmul_rn((float)sub_s[s], d_super));
    return __fmul_rn((float)v, eff);
  } else {
    const uint8_t byte =
        ((const uint8_t*)values)[(int64_t)(k / P::kPer) * N + n];
    const int q = (byte >> (P::kBits * (k % P::kPer))) & ((1 << P::kBits) - 1);
    const int64_t s = (int64_t)(k / P::kSub) * N + n;
    const float eff_d = one_if_zero(__fmul_rn((float)sub_s[s], d_super));
    const float eff_m = __fmul_rn(
        (float)sub_m[s], sup_m[(int64_t)(k / P::kBlock) * N + n]);
    return __fsub_rn(__fmul_rn((float)q, eff_d), eff_m);
  }
}

// ---------------------------------------------------------------------
// dequant_dot
// ---------------------------------------------------------------------

constexpr int BKD = 32;

template <int F, typename T>
__device__ __forceinline__ void dequant_dot_body(
    const T* __restrict__ x, const void* __restrict__ values,
    const int8_t* __restrict__ sub_s, const int8_t* __restrict__ sub_m,
    const float* __restrict__ sup_s, const float* __restrict__ sup_m,
    float* __restrict__ out, int M, int K, int N) {
  __shared__ float Xs[BM * (BKD + 1)];
  __shared__ float Ws[BKD * BN];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BKD) {
    for (int e = threadIdx.x; e < BM * BKD; e += kThreads) {
      int r = e / BKD, c = e % BKD;
      int gr = m0 + r, gc = k0 + c;
      Xs[r * (BKD + 1) + c] =
          (gr < M && gc < K) ? to_f32(x[(int64_t)gr * K + gc]) : 0.0f;
    }
    for (int e = threadIdx.x; e < BKD * BN; e += kThreads) {
      int r = e / BN, c = e % BN;
      int gk = k0 + r, gn = n0 + c;
      Ws[r * BN + c] = (gk < K && gn < N)
                           ? dequant<F>(values, sub_s, sub_m, sup_s, sup_m,
                                        gk, gn, N)
                           : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BKD; ++kk) {
      float a[2], b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) a[i] = Xs[(ty + 16 * i) * (BKD + 1) + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ws[kk * BN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int r = m0 + ty + 16 * i, c = n0 + tx + 16 * j;
      if (r < M && c < N) out[(int64_t)r * N + c] = acc[i][j];
    }
}

template <int F, typename T>
__global__ void __launch_bounds__(kThreads)
qmatmul_dequant_dot(const T* x, const void* values, const int8_t* sub_s,
                    const int8_t* sub_m, const float* sup_s,
                    const float* sup_m, float* out, int M, int K, int N) {
  dequant_dot_body<F, T>(x, values, sub_s, sub_m, sup_s, sup_m, out, M, K,
                         N);
}

// ---------------------------------------------------------------------
// dot_i8 (q8_0)
// ---------------------------------------------------------------------

constexpr int QB = 32;            // q8_0 block = the activation's k-block
constexpr int NQ = 4;             // k-blocks per stage
constexpr int BKI = QB * NQ;      // 128
constexpr int WPAD = BKI + 4;     // bytes per transposed weight column

template <typename T>
__device__ __forceinline__ void dot_i8_body(const T* __restrict__ x,
                                            const int8_t* __restrict__ wq,
                                            const float* __restrict__ w_scale,
                                            float* __restrict__ out, int M,
                                            int K, int N) {
  __shared__ __align__(16) int8_t Xq[BM * BKI];    // [row][k]
  __shared__ float Xsc[BM * NQ];                   // [row][block]
  __shared__ __align__(16) int8_t Wt[BN * WPAD];   // [col][k]
  __shared__ float Wsc[NQ * BN];                   // [block][col]
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BKI) {
    const int nq = min(NQ, (K - k0) / QB);   // K is a multiple of 32
    // quantize x: one warp per (row, block), one lane per k
    for (int u = warp; u < BM * nq; u += kThreads / 32) {
      const int r = u / nq, qb = u % nq;
      const int gr = m0 + r;
      const float v =
          gr < M ? to_f32(x[(int64_t)gr * K + k0 + qb * QB + lane]) : 0.0f;
      float amax = fabsf(v);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      const float scale = one_if_zero(__fdiv_rn(amax, 127.0f));
      const float q = fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.0f),
                            127.0f);
      Xq[r * BKI + qb * QB + lane] = (int8_t)q;
      if (lane == 0) Xsc[r * NQ + qb] = scale;
    }
    // the int8 weight tile, transposed to [col][k]
    for (int e = threadIdx.x; e < nq * QB * BN; e += kThreads) {
      const int r = e / BN, c = e % BN;
      const int gn = n0 + c;
      Wt[c * WPAD + r] = gn < N ? wq[(int64_t)(k0 + r) * N + gn] : (int8_t)0;
    }
    for (int e = threadIdx.x; e < nq * BN; e += kThreads) {
      const int qb = e / BN, c = e % BN;
      const int gn = n0 + c;
      Wsc[qb * BN + c] =
          gn < N ? w_scale[(int64_t)(k0 / QB + qb) * N + gn] : 0.0f;
    }
    __syncthreads();
    for (int qb = 0; qb < nq; ++qb) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = ty + 16 * i;
        const int* xw = (const int*)(Xq + r * BKI + qb * QB);
        const float xs = Xsc[r * NQ + qb];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const int* ww = (const int*)(Wt + c * WPAD + qb * QB);
          int part = 0;
#pragma unroll
          for (int t = 0; t < QB / 4; ++t) part = __dp4a(xw[t], ww[t], part);
          const float pf = __fmul_rn(__fmul_rn((float)part, xs),
                                     Wsc[qb * BN + c]);
          acc[i][j] = __fadd_rn(acc[i][j], pf);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int r = m0 + ty + 16 * i, c = n0 + tx + 16 * j;
      if (r < M && c < N) out[(int64_t)r * N + c] = acc[i][j];
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
qmatmul_dot_i8(const T* x, const int8_t* wq, const float* w_scale,
               float* out, int M, int K, int N) {
  dot_i8_body<T>(x, wq, w_scale, out, M, K, N);
}

template <typename T>
cudaError_t launch(const void* x, const void* values, const void* sub_s,
                   const void* sub_m, const void* sup_s, const void* sup_m,
                   void* out, int M, int K, int N, int fmt, int variant,
                   cudaStream_t s) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const T* xt = (const T*)x;
  const int8_t* ss = (const int8_t*)sub_s;
  const int8_t* sm = (const int8_t*)sub_m;
  const float* us = (const float*)sup_s;
  const float* um = (const float*)sup_m;
  float* o = (float*)out;
  if (variant == 1) {
    if (fmt != 0 || K % QB) return cudaErrorInvalidValue;
    qmatmul_dot_i8<T><<<grid, kThreads, 0, s>>>(xt, (const int8_t*)values,
                                                us, o, M, K, N);
    return cudaGetLastError();
  }
  if (variant != 0) return cudaErrorInvalidValue;
  switch (fmt) {
    case 0:
      qmatmul_dequant_dot<0, T><<<grid, kThreads, 0, s>>>(xt, values, ss, sm,
                                                          us, um, o, M, K, N);
      break;
    case 1:
      qmatmul_dequant_dot<1, T><<<grid, kThreads, 0, s>>>(xt, values, ss, sm,
                                                          us, um, o, M, K, N);
      break;
    case 2:
      qmatmul_dequant_dot<2, T><<<grid, kThreads, 0, s>>>(xt, values, ss, sm,
                                                          us, um, o, M, K, N);
      break;
    case 3:
      qmatmul_dequant_dot<3, T><<<grid, kThreads, 0, s>>>(xt, values, ss, sm,
                                                          us, um, o, M, K, N);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// fmt: 0 q8_0, 1 q6_k, 2 q4_k, 3 q2_k; variant: 0 dequant_dot, 1 dot_i8
// (q8_0 only); x_dtype: 0 float32, 1 bfloat16.  Planes a format lacks
// are passed as null.
extern "C" int qmatmul_fwd(const void* x, const void* values,
                           const void* sub_s, const void* sub_m,
                           const void* sup_s, const void* sup_m, void* out,
                           int M, int K, int N, int fmt, int variant,
                           int x_dtype, void* stream) {
  if (M < 1 || K < 1 || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == 0)
    return (int)launch<float>(x, values, sub_s, sub_m, sup_s, sup_m, out, M,
                              K, N, fmt, variant, s);
  if (x_dtype == 1)
    return (int)launch<__nv_bfloat16>(x, values, sub_s, sub_m, sup_s, sup_m,
                                      out, M, K, N, fmt, variant, s);
  return (int)cudaErrorInvalidValue;
}
