// Dense-cache decode attention for Hopper (sm_90a): K3 (length-aware)
// and K6a (masked) over a cache in q's dtype, K5 (length-aware) and K6b
// (masked) over an int8 cache with f32 scales, one template.
//
// Replaces, in src/repro/kernels/decode_attention/kernel.py:
//   * decode_attention_lengthaware_pallas (K3): grid (B, H, S/bk), the
//     key-block index clamped to the lane's last live block by a
//     scalar-prefetched length, dead-block compute skipped;
//   * decode_attention_pallas (K6a): the same grid streaming all S/bk
//     blocks of every lane and masking dead positions in the softmax;
//   * decode_attention_q8_lengthaware_pallas (K5) and
//     decode_attention_q8_pallas (K6b): the same two over int8 K/V
//     tiles and (bk/qblock, 1) f32 scale tiles, dequantized on the VPU
//     after the VMEM load (_dequant_tile).
//   All fold each (bk, D) tile into an f32 online softmax kept in VMEM
//   (_flash_block) and write 0 for a lane whose softmax sum is 0.
//
// What bounds it on the H100: bytes.  One query token per lane meets
// every key once: ~2 flops per KV byte, far below the ~295 flop/byte at
// which the tensor cores would be the limit.  The least time is the K/V
// bytes the variant must read (K3/K5: live positions; K6a/K6b: all S of
// every lane; int8 values plus their f32 scales for K5/K6b) over
// 3.35 TB/s.
//
// What the design does about it (the design of K1,
// decode_attention_paged.cu, with the cache addressed by position):
//   * one CTA per (lane, kv_head) holds all group = H/Hkv query heads of
//     that KV head, so each K/V row is read from device memory once (the
//     Pallas grid re-reads it once per query head);
//   * each warp runs its own f32 online softmax over an interleaved share
//     of the positions, two keys per step so their loads overlap, with no
//     block-wide barrier in the walk; the warps merge once at the end;
//   * K3 walks positions < min(len, S) only: a lane of length 0 reads no
//     K/V and writes 0.  K6a walks all S positions, loads every row and
//     folds a dead position in as score -inf, weight 0: alpha = 1 and
//     p = 0 leave the running state bit-for-bit as K3 leaves it, so the
//     two variants give the same output for finite caches;
//   * any S works: the walk is by position (the Pallas kernels need
//     S % bk == 0);
//   * int8 (K5/K6b): each loaded element becomes (float)kq * ks[pos /
//     qblock], one f32 multiply -- the product the reference's
//     dequantize makes -- so the cache is read as int8 and no f32 copy
//     of it is ever written.  qblock = 1 is the model's per-(token,
//     head) scale layout (B, Hkv, S, 1); the reference kernels' own is
//     qblock = 32.  Scales of dead positions are read only by K6b.
//   Left for later: splitting long contexts across CTAs (FlashDecoding
//   reduce) to fill 132 SMs at small batch, and 16-byte vector loads.
//
// C interface (loaded with ctypes): decode_attention_dense_fwd returns
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

// KV is T (K3/K6a; ks/vs unused) or int8_t (K5/K6b; ks/vs are the
// (B, Hkv, S/qblock) f32 scales)
template <typename T, typename KV, bool MASKED>
__global__ void __launch_bounds__(THREADS)
dense_decode_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                    const float* __restrict__ ks,
                    const KV* __restrict__ v,
                    const float* __restrict__ vs,
                    const int32_t* __restrict__ lens, T* __restrict__ out,
                    int H, int Hkv, int S, int D, int qblock, float scale) {
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
  len = len < S ? len : S;
  const int walk = MASKED ? S : len;       // positions this CTA visits

  const T* qb = q + ((size_t)b * H + (size_t)kvh * group) * D;
  for (int i = tid; i < group * D; i += THREADS)
    qs[i] = to_f32(qb[i]) * scale;
  for (int i = tid; i < NW * group * D; i += THREADS) accs[i] = 0.f;
  __syncthreads();

  const size_t head = ((size_t)b * Hkv + kvh) * (size_t)S * D;
  const KV* kh = k + head;
  const KV* vh = v + head;
  const size_t shead = ((size_t)b * Hkv + kvh) * (size_t)(S / qblock);
  float* acc = accs + (size_t)warp * group * D;
  // running max / sum of head g sit in lane g % 32 (m0/l0: g < 32)
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  for (int base = warp * KU; base < walk; base += NW * KU) {
    float kr[KU][NJ], vr[KU][NJ];
#pragma unroll
    for (int u = 0; u < KU; ++u) {
      const int pos = base + u;
      const bool in = pos < walk;
      const size_t row = (size_t)(in ? pos : 0) * D;
      float ksc = 1.f, vsc = 1.f;
      if constexpr (Q8) {
        if (in) {
          ksc = ks[shead + pos / qblock];
          vsc = vs[shead + pos / qblock];
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = lane + 32 * j;
        const bool ok = in && d < D;
        kr[u][j] = ok ? kv_f32(kh[row + d], ksc) : 0.f;
        vr[u][j] = ok ? kv_f32(vh[row + d], vsc) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < KU; ++u) {
      const int pos = base + u;
      if (pos >= walk) break;              // warp-uniform
      const bool live = !MASKED || pos < len;
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
        // dead (K6a/K6b only): at most -1e30, and still a function of the
        // loaded key, so the compiler cannot drop the dead rows' loads
        if (!live) s = fminf(s, NEG_INF);
        const int src = g & 31;
        const float m_old = __shfl_sync(FULL, g < 32 ? m0 : m1, src);
        const float l_old = __shfl_sync(FULL, g < 32 ? l0 : l1, src);
        const float m_new = fmaxf(m_old, s);
        const float alpha = expf(m_old - m_new);
        const float p = live ? expf(s - m_new) : 0.f;
        // explicit fma: both variants must round this the same way
        const float l_new = fmaf(l_old, alpha, p);
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

template <typename T, typename KV, bool MASKED>
cudaError_t launch(const void* q, const void* k, const float* ks,
                   const void* v, const float* vs, const int32_t* lens,
                   void* out, int B, int H, int Hkv, int S, int D,
                   int qblock, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(H / Hkv, D);
  cudaError_t err = cudaFuncSetAttribute(
      dense_decode_kernel<T, KV, MASKED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B, Hkv);
  dense_decode_kernel<T, KV, MASKED><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k), ks,
      static_cast<const KV*>(v), vs, lens, static_cast<T*>(out), H, Hkv, S,
      D, qblock, scale);
  return cudaGetLastError();
}

template <typename T, typename KV>
cudaError_t dispatch(const void* q, const void* k, const float* ks,
                     const void* v, const float* vs, const int32_t* lens,
                     void* out, int B, int H, int Hkv, int S, int D,
                     int qblock, float scale, int masked,
                     cudaStream_t stream) {
  if (masked)
    return launch<T, KV, true>(q, k, ks, v, vs, lens, out, B, H, Hkv, S, D,
                               qblock, scale, stream);
  return launch<T, KV, false>(q, k, ks, v, vs, lens, out, B, H, Hkv, S, D,
                              qblock, scale, stream);
}

template <typename T>
cudaError_t dispatch_kv(const void* q, const void* k, const float* ks,
                        const void* v, const float* vs, const int32_t* lens,
                        void* out, int B, int H, int Hkv, int S, int D,
                        int qblock, float scale, int masked, int kv_int8,
                        cudaStream_t stream) {
  if (kv_int8)
    return dispatch<T, int8_t>(q, k, ks, v, vs, lens, out, B, H, Hkv, S, D,
                               qblock, scale, masked, stream);
  return dispatch<T, T>(q, k, ks, v, vs, lens, out, B, H, Hkv, S, D, qblock,
                        scale, masked, stream);
}

}  // namespace

// k_scale/v_scale and qblock are read only when kv_int8 is 1: k/v are
// then int8 (B, Hkv, S, D) and the scales f32 (B, Hkv, S/qblock, 1);
// otherwise k/v have q's dtype.
extern "C" int decode_attention_dense_fwd(const void* q, const void* k,
                                          const void* k_scale, const void* v,
                                          const void* v_scale,
                                          const void* kv_lengths, void* out,
                                          int B, int H, int Hkv, int S,
                                          int D, int qblock, float scale,
                                          int masked, int kv_int8, int dtype,
                                          void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > MAX_GROUP || D <= 0 ||
      D > 32 * NJ || S <= 0)
    return (int)cudaErrorInvalidValue;
  if (kv_int8 && (qblock <= 0 || S % qblock != 0 || !k_scale || !v_scale))
    return (int)cudaErrorInvalidValue;
  if (!kv_int8) qblock = 1;
  const int32_t* lens = static_cast<const int32_t*>(kv_lengths);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_kv<float>(q, k, ks, v, vs, lens, out, B, H, Hkv, S,
                                   D, qblock, scale, masked, kv_int8, s);
  if (dtype == 1)
    return (int)dispatch_kv<__nv_bfloat16>(q, k, ks, v, vs, lens, out, B, H,
                                           Hkv, S, D, qblock, scale, masked,
                                           kv_int8, s);
  return (int)cudaErrorInvalidValue;
}
