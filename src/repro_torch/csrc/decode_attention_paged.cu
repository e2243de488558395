// Paged decode attention for Hopper (sm_90a): K1 over pools in q's
// dtype and K4 over int8 pools with f32 scale pools, one template.
//
// Replaces, in src/repro/kernels/decode_attention/kernel.py:
//   * decode_attention_paged_pallas (K1): pl.pallas_call, grid (B, H,
//     T), one page per grid step, f32 online softmax in VMEM;
//   * decode_attention_paged_q8_pallas (K4): the same grid over int8
//     pages and (ps/qblock, 1) f32 scale pages fetched through the same
//     block-table entry, dequantized after the VMEM load.
//
// What bounds it on the H100: bytes.  One query token per lane meets
// every live key once: ~2 flops per KV byte read, far below the ~295
// flop/byte at which the tensor cores would become the limit.  The least
// time is the live KV bytes (K4: int8 values plus their f32 scales) over
// 3.35 TB/s.
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
//     the warps' states are merged once at the end;
//   * int8 (K4): each loaded element becomes (float)kq * ks, one f32
//     multiply -- the product the reference's dequantize makes -- with
//     the scale row found through the same table entry as the values:
//     page bt[b, pos / ps], row (pos % ps) / qblock.  qblock = 1 is the
//     model's per-(token, head) scale pool (P, Hkv, ps, 1); the
//     reference kernel's own is qblock = 16 for 16-token pages.
//   Left for later: splitting long contexts across CTAs (FlashDecoding
//   reduce) to fill 132 SMs at small batch, and 16-byte vector loads.
//
// C interface (loaded with ctypes): decode_attention_paged_fwd returns
// the cudaError_t of the launch; it allocates nothing and launches on
// the stream it is given.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

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
// one K/V element in f32: the int8 overload dequantizes with its scale
template <typename T>
__device__ __forceinline__ float kv_f32(T x, float) { return to_f32(x); }
__device__ __forceinline__ float kv_f32(int8_t x, float s) {
  return (float)x * s;
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

// KV is T (K1; ksp/vsp unused) or int8_t (K4; ksp/vsp are the
// (P, Hkv, ps/qblock) f32 scale pools)
template <typename T, typename KV>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q, const KV* __restrict__ kp,
                    const float* __restrict__ ksp,
                    const KV* __restrict__ vp,
                    const float* __restrict__ vsp,
                    const int32_t* __restrict__ block_tables,
                    const int32_t* __restrict__ lens, T* __restrict__ out,
                    int H, int Hkv, int ps, int D, int T_width, int qblock,
                    float scale) {
  constexpr bool Q8 = std::is_same<KV, int8_t>::value;
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
      float ksc = 1.f, vsc = 1.f;
      if (live) {
        const size_t page = (size_t)bt[pos / ps];
        row = ((page * Hkv + kvh) * ps + (pos % ps)) * (size_t)D;
        if constexpr (Q8) {
          const size_t srow =
              (page * Hkv + kvh) * (size_t)(ps / qblock) + (pos % ps) / qblock;
          ksc = ksp[srow];
          vsc = vsp[srow];
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = lane + 32 * j;
        const bool ok = live && d < D;
        kr[u][j] = ok ? kv_f32(kp[row + d], ksc) : 0.f;
        vr[u][j] = ok ? kv_f32(vp[row + d], vsc) : 0.f;
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

template <typename T, typename KV>
cudaError_t launch(const void* q, const void* kp, const float* ksp,
                   const void* vp, const float* vsp, const int32_t* bt,
                   const int32_t* lens, void* out, int B, int H, int Hkv,
                   int ps, int D, int T_width, int qblock, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(H / Hkv, D);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T, KV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B, Hkv);
  paged_decode_kernel<T, KV><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(kp), ksp,
      static_cast<const KV*>(vp), vsp, bt, lens, static_cast<T*>(out), H,
      Hkv, ps, D, T_width, qblock, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_kv(const void* q, const void* kp, const float* ksp,
                        const void* vp, const float* vsp, const int32_t* bt,
                        const int32_t* lens, void* out, int B, int H, int Hkv,
                        int ps, int D, int T_width, int qblock, float scale,
                        int kv_int8, cudaStream_t stream) {
  if (kv_int8)
    return launch<T, int8_t>(q, kp, ksp, vp, vsp, bt, lens, out, B, H, Hkv,
                             ps, D, T_width, qblock, scale, stream);
  return launch<T, T>(q, kp, ksp, vp, vsp, bt, lens, out, B, H, Hkv, ps, D,
                      T_width, qblock, scale, stream);
}

}  // namespace

// k_scale_pages/v_scale_pages and qblock are read only when kv_int8 is
// 1: the pools are then int8 (P, Hkv, ps, D) and the scale pools f32
// (P, Hkv, ps/qblock, 1); otherwise the pools have q's dtype.
extern "C" int decode_attention_paged_fwd(
    const void* q, const void* k_pages, const void* k_scale_pages,
    const void* v_pages, const void* v_scale_pages, const void* block_tables,
    const void* kv_lengths, void* out, int B, int H, int Hkv, int P, int ps,
    int D, int T_width, int qblock, float scale, int kv_int8, int dtype,
    void* stream) {
  (void)P;
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > MAX_GROUP || D <= 0 ||
      D > 32 * NJ || ps <= 0 || T_width <= 0)
    return (int)cudaErrorInvalidValue;
  if (kv_int8 && (qblock <= 0 || ps % qblock != 0 || !k_scale_pages ||
                  !v_scale_pages))
    return (int)cudaErrorInvalidValue;
  if (!kv_int8) qblock = 1;
  const int32_t* bt = static_cast<const int32_t*>(block_tables);
  const int32_t* lens = static_cast<const int32_t*>(kv_lengths);
  const float* ksp = static_cast<const float*>(k_scale_pages);
  const float* vsp = static_cast<const float*>(v_scale_pages);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_kv<float>(q, k_pages, ksp, v_pages, vsp, bt, lens,
                                   out, B, H, Hkv, ps, D, T_width, qblock,
                                   scale, kv_int8, s);
  if (dtype == 1)
    return (int)dispatch_kv<__nv_bfloat16>(q, k_pages, ksp, v_pages, vsp, bt,
                                           lens, out, B, H, Hkv, ps, D,
                                           T_width, qblock, scale, kv_int8,
                                           s);
  return (int)cudaErrorInvalidValue;
}
