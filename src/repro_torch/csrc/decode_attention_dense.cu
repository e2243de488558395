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
// 3.35 TB/s: under a microsecond at the serve's shapes, so in practice
// the kernel is bound by latency -- how many loads are in flight and how
// long the longest CTA's chain of dependent steps is.
//
// What the design does about it (split-KV, one launch):
//   * grid (B * Hkv, ceil(S / CH)): one CTA per (lane, kv head, chunk of
//     CH positions), CH a function of the shapes alone (the lengths live
//     on the device), chosen by the wrapper (split_plan in
//     kernels/decode_attention/ops.py) so that the grid fills the SMs;
//     each CTA holds all group = H / Hkv query heads of its kv head, so
//     each K/V row is read from device memory once;
//   * a CTA issues all its chunk's K and V rows as 16-byte cp.async
//     copies into shared memory at once (rows padded so the score pass
//     meets no bank twice), then computes the group x CH scores with all
//     threads (4 threads a key, each summing two heads at a time in 4
//     independent chains each, q scaled in f32), takes one block softmax over the chunk (max, exp,
//     sum; no per-key online update) and acc = P V in f32 (4 chains of
//     rows a thread), and writes the partial (m, l, acc) to a workspace;
//   * the last CTA of each (lane, kv head) to finish -- it learns so from
//     an atomic counter after a __threadfence, and resets the counter for
//     the next launch -- merges that head's partials in chunk order (a
//     warp a head, 8 chunks' loads in flight), so every launch gives the
//     same bits;
//   * K3 reads positions < min(len, S) only: a chunk past the lane's
//     length reads nothing and leaves no partial (the merge stops at the
//     last live chunk); a lane of length 0 writes 0.  K6a reads every
//     row of every chunk and folds a dead position in as score -1e30,
//     p = 0: every slot of the softmax and every term of P V that K3
//     leaves out K6a adds as an exact zero, in the same reduction trees,
//     so the two variants give the same bits for finite caches;
//   * int8 (K5/K6b): each element is used as (float)kq * ks[pos /
//     qblock], one f32 multiply -- the product the reference's dequantize
//     makes -- so the cache is read as int8 and no f32 copy of it is ever
//     written; at qblock = 1 (the model's per-(token, head) scales) K5
//     gives the bits of dequantize-then-K3.  Scales of dead positions
//     are read only by K6b.
//   All arithmetic is f32 on the CUDA cores: a kernel bound by bytes
//   gains nothing from the tensor cores.
//
// C interface (loaded with ctypes): decode_attention_dense_fwd returns
// the cudaError_t of the launch; it allocates nothing and launches on
// the stream it is given.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "smem_limit.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;
constexpr int TPK = 4;               // threads a key in the score pass
constexpr int KPP = THREADS / TPK;   // keys a score pass
constexpr int MERGE = 8;             // chunks a merge step loads at once
constexpr int MAX_GROUP = 64;
constexpr int MAX_D = 256;
constexpr int NI = MAX_D / 16;       // 4-element slices a thread, a key
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

// four consecutive K/V elements of a shared-memory row in f32; int8
// elements are dequantized with their position's scale
__device__ __forceinline__ void kv4(const float* p, float, float (&o)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
}
__device__ __forceinline__ void kv4(const __nv_bfloat16* p, float,
                                    float (&o)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&x.y));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}
__device__ __forceinline__ void kv4(const int8_t* p, float s,
                                    float (&o)[4]) {
  const char4 x = *reinterpret_cast<const char4*>(p);
  o[0] = (float)x.x * s; o[1] = (float)x.y * s;
  o[2] = (float)x.z * s; o[3] = (float)x.w * s;
}

// Bytes between two K/V rows in shared memory: the rows one shared-memory
// access phase reads in the score pass (two keys for f32, four for bf16,
// eight for int8; each key's 4 threads reading 16 elements in a row) fall
// in different banks at D = 128.
template <typename KV>
__host__ __device__ constexpr int row_pad() {
  return 16 * (int)sizeof(KV);
}
template <typename KV>
__host__ __device__ constexpr int row_bytes(int d) {
  return d * (int)sizeof(KV) + row_pad<KV>();
}

// Shared memory: the chunk's K and V rows, then the scaled q (group x
// D), the scores / weights (group x CH) and the K and V scales (CH each)
template <typename KV>
__host__ __device__ constexpr size_t smem_bytes(int group, int d, int ch) {
  return 2 * (size_t)ch * row_bytes<KV>(d) +
         sizeof(float) * (size_t)(group * d + group * ch + 2 * ch);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

// One CTA: chunk blockIdx.y of (lane, kv head) blockIdx.x.  ws_ml holds
// (B * Hkv, n_chunks, group, 2) f32 (m, l), ws_acc (B * Hkv, n_chunks,
// group, D) f32, counters B * Hkv ints that are 0 between launches.
template <typename T, typename KV, bool MASKED>
__device__ __forceinline__ void split_body(
    const T* __restrict__ q, const KV* __restrict__ k,
    const float* __restrict__ ks, const KV* __restrict__ v,
    const float* __restrict__ vs, const int32_t* __restrict__ lens,
    T* __restrict__ out, float* __restrict__ ws_ml,
    float* __restrict__ ws_acc, int* __restrict__ counters, int H, int Hkv,
    int S, int D, int qblock, int ch, float scale) {
  constexpr bool Q8 = std::is_same<KV, int8_t>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ bool last;
  const int group = H / Hkv;
  const int rs = row_bytes<KV>(D);
  unsigned char* kt = smem;
  unsigned char* vt = kt + ch * rs;
  float* qs = reinterpret_cast<float*>(vt + ch * rs);
  float* sc = qs + group * D;
  float* kscale = sc + group * ch;
  float* vscale = kscale + ch;

  const int bk = blockIdx.x;                 // b * Hkv + kvh
  const int b = bk / Hkv, kvh = bk % Hkv;
  const int c = blockIdx.y, n_chunks = gridDim.y;
  const int p0 = c * ch;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  int len = lens[b];
  len = len < 0 ? 0 : len;
  len = len < S ? len : S;
  const int n_chunk = min(ch, S - p0);       // positions of this chunk
  const int n_live = max(0, min(n_chunk, len - p0));
  const int n_walk = MASKED ? n_chunk : n_live;   // rows this CTA reads
  const size_t slot = (size_t)bk * n_chunks + c;

  if (n_walk > 0) {
    const size_t head = ((size_t)bk * S + p0) * D;
    const unsigned char* kg = reinterpret_cast<const unsigned char*>(k + head);
    const unsigned char* vg = reinterpret_cast<const unsigned char*>(v + head);
    const int cpr = D * (int)sizeof(KV) / 16;      // 16-byte copies a row
    const size_t gstride = (size_t)D * sizeof(KV);
    for (int i = tid; i < n_walk * cpr; i += THREADS) {
      const int r = i / cpr, cc = i % cpr;
      cp_async16(smem_u32(kt + r * rs + cc * 16), kg + r * gstride + cc * 16);
      cp_async16(smem_u32(vt + r * rs + cc * 16), vg + r * gstride + cc * 16);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    if constexpr (Q8) {
      const size_t shead = (size_t)bk * (S / qblock);
      for (int j = tid; j < n_walk; j += THREADS) {
        kscale[j] = ks[shead + (p0 + j) / qblock];
        vscale[j] = vs[shead + (p0 + j) / qblock];
      }
    }
    const T* qb = q + ((size_t)b * H + (size_t)kvh * group) * D;
    for (int i = tid; i < group * D; i += THREADS)
      qs[i] = to_f32(qb[i]) * scale;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    // scores: key j's 4 threads each take the 4-element slices at
    // d = 16 i + 4 part, summed in 4 chains (one a slot of the slice),
    // and add their sums in a fixed tree; rows past n_walk are computed
    // from stale shared memory and never stored
    const int part = tid % TPK;
    for (int j0 = 0; j0 < n_walk; j0 += KPP) {
      const int j = j0 + tid / TPK;
      const float ksc = Q8 ? kscale[j < n_walk ? j : 0] : 1.f;
      const KV* krow = reinterpret_cast<const KV*>(kt + j * rs);
      float kf[NI][4];
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int d0 = 16 * i + 4 * part;
        if (d0 < D) kv4(krow + d0, ksc, kf[i]);
      }
      // two heads at a time, their chains independent
      for (int g0 = 0; g0 < group; g0 += 2) {
        const int gn = min(2, group - g0);      // 1 only for an odd tail
        float c[2][4] = {};
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const int d0 = 16 * i + 4 * part;
          if (d0 < D) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float4 qv = *reinterpret_cast<const float4*>(
                  qs + (g0 + (h < gn ? h : 0)) * D + d0);
              c[h][0] = fmaf(qv.x, kf[i][0], c[h][0]);
              c[h][1] = fmaf(qv.y, kf[i][1], c[h][1]);
              c[h][2] = fmaf(qv.z, kf[i][2], c[h][2]);
              c[h][3] = fmaf(qv.w, kf[i][3], c[h][3]);
            }
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float s = (c[h][0] + c[h][1]) + (c[h][2] + c[h][3]);
          s += __shfl_xor_sync(FULL, s, 2);
          s += __shfl_xor_sync(FULL, s, 1);
          // K6a/K6b: a dead position's score is at most -1e30
          if (h < gn && part == 0 && j < n_walk)
            sc[(g0 + h) * ch + j] = p0 + j < len ? s : NEG_INF;
        }
      }
    }
    __syncthreads();

    // one block softmax a head over the chunk's CH slots: a warp a
    // head, a lane slots lane and lane + 32; a slot that is not live
    // (K3: not read; K6a: dead) has score -1e30 and weight exactly 0
    for (int g = warp; g < group; g += NW) {
      float x[2], e[2];
      bool live[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = lane + 32 * r;
        live[r] = j < ch && p0 + j < len;
        x[r] = live[r] ? sc[g * ch + j] : NEG_INF;
      }
      float mx = fmaxf(x[0], x[1]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
#pragma unroll
      for (int r = 0; r < 2; ++r) e[r] = live[r] ? expf(x[r] - mx) : 0.f;
      float sum = e[0] + e[1];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (lane + 32 * r < ch) sc[g * ch + lane + 32 * r] = e[r];
      if (lane == 0) {
        ws_ml[(slot * group + g) * 2] = mx;
        ws_ml[(slot * group + g) * 2 + 1] = sum;
      }
    }
    __syncthreads();

    // acc = P V over the rows read, 4 columns a thread; row j goes to
    // chain j % 4 (rows in order within a chain), the chains added in a
    // fixed tree.  K6a's dead rows add p = 0 to their chains: the bits
    // of K3's shorter walk.
    const int dq = D / 4;
    for (int o = tid; o < group * dq; o += THREADS) {
      const int g = o / dq, d0 = (o % dq) * 4;
      const float* pg = sc + g * ch;
      float a[4][4] = {};
      auto row = [&](int j, float (&acc)[4]) {
        const float p = pg[j];
        float vf[4];
        kv4(reinterpret_cast<const KV*>(vt + j * rs) + d0,
            Q8 ? vscale[j] : 1.f, vf);
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[u] = fmaf(p, vf[u], acc[u]);
      };
      int j = 0;
      for (; j + 4 <= n_walk; j += 4) {
        row(j, a[0]);
        row(j + 1, a[1]);
        row(j + 2, a[2]);
        row(j + 3, a[3]);
      }
      if (j < n_walk) row(j, a[0]);
      if (j + 1 < n_walk) row(j + 1, a[1]);
      if (j + 2 < n_walk) row(j + 2, a[2]);
      float r[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) r[u] = (a[0][u] + a[1][u]) + (a[2][u] + a[3][u]);
      *reinterpret_cast<float4*>(ws_acc + (slot * group + g) * D + d0) =
          make_float4(r[0], r[1], r[2], r[3]);
    }
  }

  // the last CTA of this (lane, kv head) merges its partials
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(counters + bk, 1) == n_chunks - 1;
    if (last) counters[bk] = 0;            // ready for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();

  // chunks past the last live one hold no partial (K3) or an empty one
  // (K6a): both would add exact zeros, so the merge stops before them.
  // A thread a (head, 4 columns) folds the chunks in chunk order into a
  // running max, sum and accumulator (rescaled as the max grows), 8
  // chunks' loads in flight at once.
  const int n_live_chunks = (len + ch - 1) / ch;
  T* ob = out + ((size_t)b * H + (size_t)kvh * group) * D;
  const int dq = D / 4;
  for (int o = tid; o < group * dq; o += THREADS) {
    const int g = o / dq, d0 = (o % dq) * 4;
    const size_t base = (size_t)bk * n_chunks * group + g;   // chunk 0
    const size_t step = (size_t)group;                     // a chunk on
    float m = NEG_INF, l = 0.f, a[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c0 = 0; c0 < n_live_chunks; c0 += MERGE) {
      float mc[MERGE], lc[MERGE];
      float4 x[MERGE];
#pragma unroll
      for (int jj = 0; jj < MERGE; ++jj) {
        const size_t sl = base + (c0 + jj) * step;
        if (c0 + jj < n_live_chunks) {
          mc[jj] = __ldcg(ws_ml + sl * 2);
          lc[jj] = __ldcg(ws_ml + sl * 2 + 1);
          x[jj] = __ldcg(reinterpret_cast<const float4*>(ws_acc + sl * D +
                                                          d0));
        }
      }
#pragma unroll
      for (int jj = 0; jj < MERGE; ++jj) {
        if (c0 + jj >= n_live_chunks) break;
        const float m_new = fmaxf(m, mc[jj]);
        const float r = expf(m - m_new), f = expf(mc[jj] - m_new);
        m = m_new;
        l = fmaf(lc[jj], f, l * r);
        a[0] = fmaf(x[jj].x, f, a[0] * r);
        a[1] = fmaf(x[jj].y, f, a[1] * r);
        a[2] = fmaf(x[jj].z, f, a[2] * r);
        a[3] = fmaf(x[jj].w, f, a[3] * r);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      from_f32(ob + (size_t)g * D + d0 + u, l == 0.f ? 0.f : a[u] / l);
  }
}

#define DENSE_KERNEL(name, T, KV, MASKED)                                   \
  __global__ void __launch_bounds__(THREADS, 2)                             \
      name(const T* q, const KV* k, const float* ks, const KV* v,           \
           const float* vs, const int32_t* lens, T* out, float* ws_ml,      \
           float* ws_acc, int* counters, int H, int Hkv, int S, int D,      \
           int qblock, int ch, float scale) {                               \
    split_body<T, KV, MASKED>(q, k, ks, v, vs, lens, out, ws_ml, ws_acc,    \
                              counters, H, Hkv, S, D, qblock, ch, scale);   \
  }
DENSE_KERNEL(decode_dense_f32, float, float, false)
DENSE_KERNEL(decode_dense_bf16, __nv_bfloat16, __nv_bfloat16, false)
DENSE_KERNEL(decode_dense_masked_f32, float, float, true)
DENSE_KERNEL(decode_dense_masked_bf16, __nv_bfloat16, __nv_bfloat16, true)
DENSE_KERNEL(decode_dense_q8_f32, float, int8_t, false)
DENSE_KERNEL(decode_dense_q8_bf16, __nv_bfloat16, int8_t, false)
DENSE_KERNEL(decode_dense_q8_masked_f32, float, int8_t, true)
DENSE_KERNEL(decode_dense_q8_masked_bf16, __nv_bfloat16, int8_t, true)
#undef DENSE_KERNEL

template <typename T, typename KV>
using Kernel = void (*)(const T*, const KV*, const float*, const KV*,
                        const float*, const int32_t*, T*, float*, float*,
                        int*, int, int, int, int, int, int, float);

// one launch (at the serve's shapes it needs less shared memory than
// the default 48 KB, so allow_smem never raises the limit)
template <typename T, typename KV>
cudaError_t launch(Kernel<T, KV> kernel, int* allowed, const void* q,
                   const void* k, const float* ks, const void* v,
                   const float* vs, const int32_t* lens, void* out,
                   float* ws_ml, float* ws_acc, int* counters, int B, int H,
                   int Hkv, int S, int D, int qblock, int ch, float scale,
                   cudaStream_t stream) {
  const int smem = (int)smem_bytes<KV>(H / Hkv, D, ch);
  cudaError_t err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  dim3 grid(B * Hkv, (S + ch - 1) / ch);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k), ks,
      static_cast<const KV*>(v), vs, lens, static_cast<T*>(out), ws_ml,
      ws_acc, counters, H, Hkv, S, D, qblock, ch, scale);
  return cudaGetLastError();
}

#define PICK(T, KV, name)                                                   \
  {                                                                         \
    static int allowed[64] = {};                                            \
    return launch<T, KV>(name, allowed, q, k, ks, v, vs, lens, out, ws_ml,  \
                         ws_acc, counters, B, H, Hkv, S, D, qblock, ch,     \
                         scale, s);                                         \
  }

}  // namespace

// k_scale/v_scale and qblock are read only when kv_int8 is 1: k/v are
// then int8 (B, Hkv, S, D) and the scales f32 (B, Hkv, S/qblock, 1);
// otherwise k/v have q's dtype.  ch (32 or 64) is the chunk length;
// ws_ml and ws_acc hold B * Hkv * ceil(S / ch) * (H / Hkv) * 2 and
// ... * D floats; counters B * Hkv ints, 0 before the first launch (each
// launch leaves them 0).
extern "C" int decode_attention_dense_fwd(
    const void* q, const void* k, const void* k_scale, const void* v,
    const void* v_scale, const void* kv_lengths, void* out, void* ws_ml_p,
    void* ws_acc_p, void* counters_p, int B, int H, int Hkv, int S, int D,
    int qblock, int ch, float scale, int masked, int kv_int8, int dtype,
    void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > MAX_GROUP || D <= 0 ||
      D > MAX_D || D % 16 != 0 || S <= 0 || (ch != 32 && ch != 64) ||
      (S + ch - 1) / ch > 65535)
    return (int)cudaErrorInvalidValue;
  if (kv_int8 && (qblock <= 0 || S % qblock != 0 || !k_scale || !v_scale))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)k | (uintptr_t)v | (uintptr_t)ws_acc_p) % 16)
    return (int)cudaErrorInvalidValue;
  if (!kv_int8) qblock = 1;
  const int32_t* lens = static_cast<const int32_t*>(kv_lengths);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  float* ws_ml = static_cast<float*>(ws_ml_p);
  float* ws_acc = static_cast<float*>(ws_acc_p);
  int* counters = static_cast<int*>(counters_p);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  const int pick = (dtype << 2) | (kv_int8 << 1) | (masked ? 1 : 0);
  switch (pick) {
    case 0: PICK(float, float, decode_dense_f32)
    case 1: PICK(float, float, decode_dense_masked_f32)
    case 2: PICK(float, int8_t, decode_dense_q8_f32)
    case 3: PICK(float, int8_t, decode_dense_q8_masked_f32)
    case 4: PICK(bf16, bf16, decode_dense_bf16)
    case 5: PICK(bf16, bf16, decode_dense_masked_bf16)
    case 6: PICK(bf16, int8_t, decode_dense_q8_bf16)
    case 7: PICK(bf16, int8_t, decode_dense_q8_masked_bf16)
    default: return (int)cudaErrorInvalidValue;
  }
}
