// Paged decode attention (K1) for Hopper (sm_90a).
//
// Replaces: decode_attention_paged_pallas in
//   src/repro/kernels/decode_attention/kernel.py (pl.pallas_call, grid
//   (B, H, T), one page per grid step, f32 online softmax in VMEM).
//
// What bounds it on the H100: bytes.  One query token per lane meets
// every live key once: ~2 flops per KV byte read, far below the ~295
// flop/byte at which the tensor cores would become the limit.  The least
// time is the live KV bytes over 3.35 TB/s.
//
// What the design does about it:
//   * one CTA per (lane, kv_head) owns all group = H/Hkv query heads of
//     that KV head, so each live KV row is read from device memory once
//     (the Pallas grid re-reads it once per query head);
//   * the CTA walks only positions < min(len, T*ps), reading its own
//     block-table entries, so dead pages are never touched and a lane of
//     length 0 reads nothing and writes 0; any page size works, since
//     the walk is by position;
//   * each warp runs its own f32 online softmax over an interleaved
//     share of the positions, two keys per step so their loads overlap,
//     with no block-wide barrier in the walk: a lane holds D/32 elements
//     of each key row, dot products are reduced by warp shuffles, the
//     running max and sum of query head g live in a register of lane
//     g % 32, and the accumulators in the warp's slice of shared memory;
//     the warps' states are merged once at the end.
//   Left for later: splitting long contexts across CTAs (FlashDecoding
//   reduce) to fill 132 SMs at small batch, and 16-byte vector loads.
//
// C interface (loaded with ctypes): decode_attention_paged_fwd returns
// the cudaError_t of the launch; it allocates nothing and launches on
// the stream it is given.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;   // warps, each with its own softmax
constexpr int NJ = 8;              // max key elements per lane (D <= 256)
constexpr int KU = 2;              // keys per warp step
constexpr int MAX_GROUP = 64;      // two (m, l) registers per lane
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Shared-memory floats: scaled q (group x D), one accumulator per warp
// (NW x group x D), and each warp's final m and l (NW x group each).
size_t smem_bytes(int group, int d) {
  return sizeof(float) *
         (size_t)(group * d + NW * group * d + 2 * NW * group);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp,
                    const int32_t* __restrict__ block_tables,
                    const int32_t* __restrict__ lens, T* __restrict__ out,
                    int H, int Hkv, int ps, int D, int T_width,
                    float scale) {
  extern __shared__ float smem[];
  const int group = H / Hkv;
  float* qs = smem;                        // group * D
  float* accs = qs + group * D;            // NW * group * D
  float* ms = accs + NW * group * D;       // NW * group
  float* ls = ms + NW * group;             // NW * group

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  int len = lens[b];
  len = len < 0 ? 0 : len;
  const int cap = T_width * ps;
  len = len < cap ? len : cap;

  const T* qb = q + ((size_t)b * H + (size_t)kvh * group) * D;
  for (int i = tid; i < group * D; i += THREADS)
    qs[i] = to_f32(qb[i]) * scale;
  for (int i = tid; i < NW * group * D; i += THREADS) accs[i] = 0.f;
  __syncthreads();

  const int32_t* bt = block_tables + (size_t)b * T_width;
  float* acc = accs + (size_t)warp * group * D;
  // running max / sum of head g sit in lane g % 32 (m0/l0: g < 32)
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  for (int base = warp * KU; base < len; base += NW * KU) {
    float kr[KU][NJ], vr[KU][NJ];
#pragma unroll
    for (int u = 0; u < KU; ++u) {
      const int pos = base + u;
      const bool live = pos < len;
      size_t row = 0;
      if (live) {
        const size_t page = (size_t)bt[pos / ps];
        row = ((page * Hkv + kvh) * ps + (pos % ps)) * (size_t)D;
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = lane + 32 * j;
        const bool ok = live && d < D;
        kr[u][j] = ok ? to_f32(kp[row + d]) : 0.f;
        vr[u][j] = ok ? to_f32(vp[row + d]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < KU; ++u) {
      if (base + u >= len) break;          // warp-uniform
      for (int g = 0; g < group; ++g) {
        const float* qg = qs + g * D;
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int d = lane + 32 * j;
          if (d < D) s = fmaf(qg[d], kr[u][j], s);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
        const int src = g & 31;
        const float m_old = __shfl_sync(FULL, g < 32 ? m0 : m1, src);
        const float l_old = __shfl_sync(FULL, g < 32 ? l0 : l1, src);
        const float m_new = fmaxf(m_old, s);
        const float alpha = expf(m_old - m_new);
        const float p = expf(s - m_new);
        const float l_new = l_old * alpha + p;
        if (lane == src) {
          if (g < 32) { m0 = m_new; l0 = l_new; }
          else { m1 = m_new; l1 = l_new; }
        }
        float* ag = acc + g * D;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int d = lane + 32 * j;
          if (d < D) ag[d] = fmaf(ag[d], alpha, p * vr[u][j]);
        }
      }
    }
  }

  // publish this warp's (m, l); lane g % 32 holds head g
  for (int g = lane; g < group; g += 32) {
    ms[warp * group + g] = g < 32 ? m0 : m1;
    ls[warp * group + g] = g < 32 ? l0 : l1;
  }
  __syncthreads();

  T* ob = out + ((size_t)b * H + (size_t)kvh * group) * D;
  for (int i = tid; i < group * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float mx = NEG_INF;
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, ms[w * group + g]);
    float lsum = 0.f, a = 0.f;
    for (int w = 0; w < NW; ++w) {
      const float f = expf(ms[w * group + g] - mx);
      lsum = fmaf(ls[w * group + g], f, lsum);
      a = fmaf(accs[((size_t)w * group + g) * D + d], f, a);
    }
    from_f32(ob + i, lsum == 0.f ? 0.f : a / lsum);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int32_t* bt, const int32_t* lens, void* out, int B,
                   int H, int Hkv, int ps, int D, int T_width, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(H / Hkv, D);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B, Hkv);
  paged_decode_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), bt, lens, static_cast<T*>(out), H, Hkv, ps,
      D, T_width, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int decode_attention_paged_fwd(const void* q, const void* k_pages,
                                          const void* v_pages,
                                          const void* block_tables,
                                          const void* kv_lengths, void* out,
                                          int B, int H, int Hkv, int P, int ps,
                                          int D, int T_width, float scale,
                                          int dtype, void* stream) {
  (void)P;
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > MAX_GROUP || D <= 0 ||
      D > 32 * NJ || ps <= 0 || T_width <= 0)
    return (int)cudaErrorInvalidValue;
  const int32_t* bt = static_cast<const int32_t*>(block_tables);
  const int32_t* lens = static_cast<const int32_t*>(kv_lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k_pages, v_pages, bt, lens, out, B, H, Hkv,
                              ps, D, T_width, scale, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k_pages, v_pages, bt, lens, out, B,
                                      H, Hkv, ps, D, T_width, scale, s);
  return (int)cudaErrorInvalidValue;
}
