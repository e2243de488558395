// Flash attention prefill (K2) for Hopper (sm_90a).
//
// Replaces: flash_attention_pallas in
//   src/repro/kernels/flash_attention/kernel.py (pl.pallas_call, grid
//   (B, H, Sq/bq, Sk/bk), key axis innermost, f32 running max/sum/acc in
//   VMEM scratch, GQA through kv_head = h // group, optional window).
//
// What bounds it on the H100: operations.  A causal prompt of S tokens
// does ~2*S*S*D flops per head against ~4*S*D bytes: at S=512, D=128 that
// is ~128 flop/byte in bf16 before the causal half is dropped, so the
// least time is the causal flops over the 989 TFLOP/s bf16 tensor-core
// peak (the byte bound is smaller).
//
// What the design does about it (a first, simple kernel):
//   * grid (B*H, ceil(Sq/64)); one CTA owns 64 query rows of one head and
//     walks the key axis in 64-key blocks staged through shared memory
//     (f32, rows padded against bank conflicts; dynamic shared memory
//     above the 48 KB static limit);
//   * 256 threads as a 16x16 grid, each holding a 4x4 register tile of
//     the scores and a 4 x D/16 slice of the f32 accumulator; per-row
//     running max and sum are reduced across the 16 threads of a row with
//     warp shuffles;
//   * causal, window and ragged-edge masks as in the Pallas kernel; key
//     blocks wholly above the diagonal or wholly outside the window are
//     skipped (they would add p = 0 with alpha = 1, so the result is
//     unchanged); rows with no live key write 0.
//   The products run on the CUDA cores in f32, far from the tensor-core
//   bound: wgmma with TMA-fed shared-memory tiles is later work.
//
// C interface (loaded with ctypes): flash_attention_fwd returns the
// cudaError_t of the launch; it allocates nothing and launches on the
// stream it is given.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // query rows per CTA
constexpr int BK = 64;         // keys per shared-memory stage
constexpr int THREADS = 256;   // 16 x 16
constexpr int R = 4;           // rows per thread (ty + 16*r)
constexpr int C = 4;           // key columns per thread (tx + 16*c)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_bytes() {
  // Q and K tiles padded to D+1, V tile D, P tile BK+1, all f32
  return sizeof(float) *
         (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int H, int Hkv,
             int Sq, int Sk, int causal, int window, float scale) {
  constexpr int DP = D + 1;
  constexpr int NK = D / 16;   // accumulator columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                 // BQ * DP
  float* ks = qs + BQ * DP;         // BK * DP
  float* vs = ks + BK * DP;         // BK * D
  float* ps = vs + BK * D;          // BQ * (BK + 1)

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / Hkv);
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  const T* qb = q + ((size_t)b * H + h) * (size_t)Sq * D;
  const T* kb = k + ((size_t)b * Hkv + kvh) * (size_t)Sk * D;
  const T* vb = v + ((size_t)b * Hkv + kvh) * (size_t)Sk * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int qi = q0 + r;
    qs[r * DP + d] = qi < Sq ? to_f32(qb[(size_t)qi * D + d]) * scale : 0.f;
  }

  float acc[R][NK];
  float m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NK; ++c) acc[r][c] = 0.f;
  }

  // key blocks that can hold a live key for rows [q0, q_last]
  const int q_last = min(q0 + BQ, Sq) - 1;
  int k_end = Sk;
  if (causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 - window + 1);
  k_begin = (k_begin / BK) * BK;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();   // previous block's ks/vs/ps reads are done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int j = i / D, d = i % D;
      const int kj = k0 + j;
      float kk = 0.f, vv = 0.f;
      if (kj < Sk) {
        kk = to_f32(kb[(size_t)kj * D + d]);
        vv = to_f32(vb[(size_t)kj * D + d]);
      }
      ks[j * DP + d] = kk;
      vs[j * D + d] = vv;
    }
    __syncthreads();

    float s[R][C];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[R], bb[C];
#pragma unroll
      for (int r = 0; r < R; ++r) a[r] = qs[(ty + 16 * r) * DP + d];
#pragma unroll
      for (int c = 0; c < C; ++c) bb[c] = ks[(tx + 16 * c) * DP + d];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c) s[r][c] = fmaf(a[r], bb[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int qi = q0 + ty + 16 * r;
      bool live[C];
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int kj = k0 + tx + 16 * c;
        bool ok = kj < Sk;
        if (causal) ok = ok && (qi >= kj);
        if (window > 0) ok = ok && (qi - kj < window);
        live[c] = ok;
        if (!ok) s[r][c] = NEG_INF;
        mx = fmaxf(mx, s[r][c]);
      }
      // the 16 threads of a row are lanes tx = 0..15 of one half-warp
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o, 16));
      const float m_new = fmaxf(m[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float p = live[c] ? expf(s[r][c] - m_new) : 0.f;
        ps[(ty + 16 * r) * (BK + 1) + tx + 16 * c] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o, 16);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NK; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();

    for (int j = 0; j < BK; ++j) {
      float pr[R];
#pragma unroll
      for (int r = 0; r < R; ++r) pr[r] = ps[(ty + 16 * r) * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < NK; ++c) {
        const float vv = vs[j * D + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r][c] = fmaf(pr[r], vv, acc[r][c]);
      }
    }
  }

  T* ob = out + ((size_t)b * H + h) * (size_t)Sq * D;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qi = q0 + ty + 16 * r;
    if (qi >= Sq) continue;
    const float inv = l[r] == 0.f ? 0.f : 1.f / l[r];
#pragma unroll
    for (int c = 0; c < NK; ++c)
      from_f32(ob + (size_t)qi * D + tx + 16 * c, acc[r][c] * inv);
  }
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int Hkv, int Sq, int Sk, int causal,
                   int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_kernel<D, T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Hkv, Sq, Sk, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       int B, int H, int Hkv, int Sq, int Sk, int D,
                       int causal, int window, float scale,
                       cudaStream_t s) {
  switch (D) {
    case 32:
      return launch<32, T>(q, k, v, o, B, H, Hkv, Sq, Sk, causal, window,
                           scale, s);
    case 64:
      return launch<64, T>(q, k, v, o, B, H, Hkv, Sq, Sk, causal, window,
                           scale, s);
    case 128:
      return launch<128, T>(q, k, v, o, B, H, Hkv, Sq, Sk, causal, window,
                            scale, s);
    case 256:
      return launch<256, T>(q, k, v, o, B, H, Hkv, Sq, Sk, causal, window,
                            scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// window <= 0 means no sliding window.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int B, int H,
                                   int Hkv, int Sq, int Sk, int D, int causal,
                                   int window, float scale, int dtype,
                                   void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float>(q, k, v, out, B, H, Hkv, Sq, Sk, D, causal,
                                  window, scale, s);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(q, k, v, out, B, H, Hkv, Sq, Sk, D,
                                          causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
