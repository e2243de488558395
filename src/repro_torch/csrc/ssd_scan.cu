// SSD (Mamba-2) intra-chunk scan (K10) for Hopper (sm_90a).
//
// Replaces: ssd_chunk_pallas in src/repro/kernels/ssd_scan/kernel.py
//   (pl.pallas_call, grid (B, H, n_chunks); per step the chunk's x/dt/B/C
//   tiles in VMEM, the log-decay cumsum on the VPU, C.B^T and the two
//   products on the MXU, writing y_intra, the chunk's boundary state and
//   its total decay).  The inter-chunk recurrence stays in PyTorch
//   (kernels/ssd_scan/ops.py), as it stays in jnp in the reference.
//
// What it computes, per (batch b, head h, chunk z) with la_i = dt_i * A_h
// and cum the inclusive cumsum of la over the chunk's Q positions:
//   y_intra[i]  = sum_{j<=i} exp(cum_i - cum_j) (C_i . B_j) dt_j x_j   (P)
//   states      = sum_j exp(cum_{Q-1} - cum_j) B_j (dt_j x_j)^T        (N x P)
//   chunk_decay = exp(cum_{Q-1})
//
// What bounds it on the H100: bytes.  At mamba2-780m's widths (H 48, P 64,
// N 128, Q 256) and S = 1024, B = 1, the function needs C.B over the lower
// triangle once per (b, z) (B and C are shared by the heads), and per head
// the triangle's products with dt*x plus the boundary state: 1.65 GFLOP,
// 3.3 us at 495 TFLOP/s TF32, against ~26 MB of bytes (7.7 us at 3.35
// TB/s).  On the CUDA cores in f32, as this kernel computes them, the same
// products take 24.7 us at 66.9 TFLOP/s.  Computed per head and over the
// full square, as the Pallas kernel does, it is 5.64 GFLOP.
//
// What the design does about it (a first, simple kernel):
//   * one CTA per (b, h, z): 192 CTAs at S = 1024 on 132 SMs, two CTAs per
//     SM (~101 KB of shared memory each);
//   * dt, and the cumsum taken by one thread in position order with
//     unfused multiply and add (the reference's sequential sum), in shared
//     memory;
//   * rows i in tiles of 64; key positions j <= i staged through shared
//     memory in tiles of 64 B rows (N wide, padded against bank conflicts)
//     and dt*x rows (P wide); key tiles wholly above the diagonal are
//     skipped, and exp is taken only where j <= i (above the diagonal
//     cum_i - cum_j is positive and may overflow);
//   * 256 threads as a 16x16 grid; each holds a 4x4 register tile of the
//     weights w = (C.B) exp(cum_i - cum_j) and a 4 x P/16 slice of the f32
//     output; the boundary state is a second pass over the staged tiles,
//     each thread holding 8 x P/16 of the N x P state;
//   * x, B and C read as float32 or bfloat16 and converted on load; dt and
//     A float32; every product on the CUDA cores in f32.
//   C.B is recomputed by each head's CTA (48x the needed work) and nothing
//   runs on the tensor cores: computing C.B once per (b, z) and moving the
//   products onto wgmma are later work.
//
// C interface (loaded with ctypes): ssd_chunk_fwd returns the cudaError_t
// of the launch; it allocates nothing and launches on the stream it is
// given.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;   // 16 x 16
constexpr int TI = 64;         // rows per tile
constexpr int TJ = 64;         // key positions per staged tile
constexpr int MAX_N = 128;     // state width the register tiles cover
constexpr int MAX_P = 64;      // head width the register tiles cover
constexpr int MAX_Q = 1024;    // longest chunk
constexpr int RI = TI / 16;    // output rows per thread (ty + 16 r)
constexpr int CJ = TJ / 16;    // weight columns per thread (tx + 16 k)
constexpr int CP = MAX_P / 16; // output columns per thread (tx + 16 c)
constexpr int RN = MAX_N / 16; // state rows per thread (ty + 16 r)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

size_t smem_bytes(int Q, int N, int P) {
  // dt and cum (Q each), C and B tiles (N+1 wide), dt*x tile, weight tile
  return sizeof(float) * ((size_t)2 * Q + (size_t)(TI + TJ) * (N + 1) +
                          (size_t)TJ * P + (size_t)TI * (TJ + 1));
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a, const T* __restrict__ bm,
                 const T* __restrict__ cm, float* __restrict__ y,
                 float* __restrict__ states, float* __restrict__ decay,
                 int S, int H, int P, int N, int Q) {
  const int z = blockIdx.x, h = blockIdx.y, bb = blockIdx.z;
  const int NC = S / Q;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int NP = N + 1;
  extern __shared__ float smem[];
  float* dt_s = smem;                 // Q
  float* cum_s = dt_s + Q;            // Q
  float* c_s = cum_s + Q;             // TI * NP
  float* b_s = c_s + TI * NP;         // TJ * NP
  float* x_s = b_s + TJ * NP;         // TJ * P   (dt_j * x_j)
  float* w_s = x_s + TJ * P;          // TI * (TJ + 1)

  // global row (b, s) of the chunk's first position
  const long long row0 = (long long)bb * S + (long long)z * Q;
  const float A = a[h];
  for (int i = tid; i < Q; i += THREADS) dt_s[i] = dt[(row0 + i) * H + h];
  __syncthreads();
  if (tid == 0) {
    float acc = 0.f;
    for (int i = 0; i < Q; ++i) {
      acc = __fadd_rn(acc, __fmul_rn(dt_s[i], A));
      cum_s[i] = acc;
    }
  }
  __syncthreads();

  // stage key positions [j0, j0 + nj) of B (times the decay to the
  // chunk's end when `to_end`) and of dt*x; rows past nj are zero
  auto stage = [&](int j0, int nj, bool to_end) {
    const float cum_last = cum_s[Q - 1];
    for (int e = tid; e < TJ * N; e += THREADS) {
      const int r = e / N, n = e - r * N;
      float v = 0.f;
      if (r < nj) {
        v = to_f32(bm[(row0 + j0 + r) * N + n]);
        if (to_end) v *= expf(cum_last - cum_s[j0 + r]);
      }
      b_s[r * NP + n] = v;
    }
    for (int e = tid; e < TJ * P; e += THREADS) {
      const int r = e / P, p = e - r * P;
      x_s[r * P + p] =
          r < nj ? to_f32(x[((row0 + j0 + r) * H + h) * P + p]) * dt_s[j0 + r]
                 : 0.f;
    }
  };

  const int n_tiles = (Q + TI - 1) / TI;
  for (int it = 0; it < n_tiles; ++it) {
    const int i0 = it * TI;
    const int ni = min(TI, Q - i0);
    __syncthreads();                  // previous tile done with c_s
    for (int e = tid; e < TI * N; e += THREADS) {
      const int r = e / N, n = e - r * N;
      c_s[r * NP + n] = r < ni ? to_f32(cm[(row0 + i0 + r) * N + n]) : 0.f;
    }
    float acc[RI][CP];
#pragma unroll
    for (int r = 0; r < RI; ++r)
#pragma unroll
      for (int c = 0; c < CP; ++c) acc[r][c] = 0.f;

    for (int jt = 0; jt <= it; ++jt) {   // tiles above the diagonal skipped
      const int j0 = jt * TJ;
      const int nj = min(TJ, Q - j0);
      __syncthreads();                // b_s, x_s, w_s free
      stage(j0, nj, false);
      __syncthreads();
      float sc[RI][CJ];
#pragma unroll
      for (int r = 0; r < RI; ++r)
#pragma unroll
        for (int k = 0; k < CJ; ++k) sc[r][k] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[RI], bv[CJ];
#pragma unroll
        for (int r = 0; r < RI; ++r) cv[r] = c_s[(ty + 16 * r) * NP + n];
#pragma unroll
        for (int k = 0; k < CJ; ++k) bv[k] = b_s[(tx + 16 * k) * NP + n];
#pragma unroll
        for (int r = 0; r < RI; ++r)
#pragma unroll
          for (int k = 0; k < CJ; ++k) sc[r][k] += cv[r] * bv[k];
      }
#pragma unroll
      for (int r = 0; r < RI; ++r) {
#pragma unroll
        for (int k = 0; k < CJ; ++k) {
          const int i = ty + 16 * r, j = tx + 16 * k;
          float w = 0.f;
          if (i < ni && j < nj && j0 + j <= i0 + i)
            w = sc[r][k] * expf(cum_s[i0 + i] - cum_s[j0 + j]);
          w_s[i * (TJ + 1) + j] = w;
        }
      }
      __syncthreads();
      for (int j = 0; j < nj; ++j) {
        float xv[CP];
#pragma unroll
        for (int c = 0; c < CP; ++c) {
          const int p = tx + 16 * c;
          xv[c] = p < P ? x_s[j * P + p] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < RI; ++r) {
          const float wv = w_s[(ty + 16 * r) * (TJ + 1) + j];
#pragma unroll
          for (int c = 0; c < CP; ++c) acc[r][c] += wv * xv[c];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RI; ++r) {
      const int i = ty + 16 * r;
      if (i >= ni) continue;
#pragma unroll
      for (int c = 0; c < CP; ++c) {
        const int p = tx + 16 * c;
        if (p < P) y[((row0 + i0 + i) * H + h) * P + p] = acc[r][c];
      }
    }
  }

  // boundary state: sum_j exp(cum_{Q-1} - cum_j) B_j (dt_j x_j)^T
  float st[RN][CP];
#pragma unroll
  for (int r = 0; r < RN; ++r)
#pragma unroll
    for (int c = 0; c < CP; ++c) st[r][c] = 0.f;
  for (int jt = 0; jt < n_tiles; ++jt) {
    const int j0 = jt * TJ;
    const int nj = min(TJ, Q - j0);
    __syncthreads();
    stage(j0, nj, true);
    __syncthreads();
    for (int j = 0; j < nj; ++j) {
      float bv[RN], xv[CP];
#pragma unroll
      for (int r = 0; r < RN; ++r) {
        const int n = ty + 16 * r;
        bv[r] = n < N ? b_s[j * NP + n] : 0.f;
      }
#pragma unroll
      for (int c = 0; c < CP; ++c) {
        const int p = tx + 16 * c;
        xv[c] = p < P ? x_s[j * P + p] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < RN; ++r)
#pragma unroll
        for (int c = 0; c < CP; ++c) st[r][c] += bv[r] * xv[c];
    }
  }
  float* st_out = states + (((long long)bb * NC + z) * H + h) * N * P;
#pragma unroll
  for (int r = 0; r < RN; ++r) {
    const int n = ty + 16 * r;
    if (n >= N) continue;
#pragma unroll
    for (int c = 0; c < CP; ++c) {
      const int p = tx + 16 * c;
      if (p < P) st_out[n * P + p] = st[r][c];
    }
  }
  if (tid == 0) decay[((long long)bb * NC + z) * H + h] = expf(cum_s[Q - 1]);
}

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* b,
           const void* c, void* y, void* states, void* decay, int B, int S,
           int H, int P, int N, int Q, cudaStream_t stream) {
  const size_t smem = smem_bytes(Q, N, P);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(S / Q, H, B);
  ssd_chunk_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<float*>(y),
      static_cast<float*>(states), static_cast<float*>(decay), S, H, P, N,
      Q);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ssd_chunk_fwd(const void* x, const void* dt, const void* a,
                             const void* b, const void* c, void* y,
                             void* states, void* decay, int B, int S, int H,
                             int P, int N, int Q, int dtype, void* stream) {
  if (B < 1 || H < 1 || Q < 1 || Q > MAX_Q || S < Q || S % Q != 0 ||
      P < 1 || P > MAX_P || N < 1 || N > MAX_N || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, a, b, c, y, states, decay, B, S, H, P, N, Q,
                         s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, a, b, c, y, states, decay, B, S, H,
                                 P, N, Q, s);
  return (int)cudaErrorInvalidValue;
}
