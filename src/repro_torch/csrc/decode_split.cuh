// The split-KV decode attention body shared by decode_attention_dense.cu
// (K3, K6a, K5, K6b over a dense per-lane cache) and
// decode_attention_paged.cu (K1, K4 over page pools named by a block
// table).  The two differ only in where row `pos` of a (lane, kv head)
// lives (DenseRows, PagedRows below); the chunking, the reduction trees
// and the merge are one code, so on the same logical cache a paged
// kernel gives the bits of its dense twin.
//
// What bounds it on the H100: bytes.  One query token per lane meets
// every key once: ~2 flops per KV byte, far below the ~295 flop/byte at
// which the tensor cores would be the limit.  The least time is the K/V
// bytes read over 3.35 TB/s: under a microsecond at the serves' shapes,
// so in practice the kernels are bound by latency -- how many loads are
// in flight and how long the longest CTA's chain of dependent steps is.
//
// The design (split-KV, one launch):
//   * grid (B * Hkv, ceil(S / CH)): one CTA per (lane, kv head, chunk of
//     CH positions), CH a function of the shapes alone (the lengths live
//     on the device), chosen by the wrapper (split_plan in
//     kernels/decode_attention/ops.py) so that the grid fills the SMs;
//     each CTA holds all group = H / Hkv query heads of its kv head, so
//     each K/V row is read from device memory once;
//   * a CTA finds its chunk's rows (through a block table: one table
//     read a row, all before the first copy; a chunk may straddle pages
//     of any size), issues all their K and V rows as 16-byte cp.async
//     copies into shared memory at once (rows padded so the score pass
//     meets no bank twice), then computes the group x CH scores with all
//     threads (4 threads a key, each summing two heads at a time in 4
//     independent chains each, q scaled in f32), takes one block softmax
//     over the chunk (max, exp, sum; no per-key online update) and acc =
//     P V in f32 (4 chains of rows a thread), and writes the partial (m,
//     l, acc) to a workspace;
//   * the last CTA of each (lane, kv head) to finish -- it learns so from
//     an atomic counter after a __threadfence, and resets the counter for
//     the next launch -- merges that head's partials in chunk order (a
//     warp a head, 8 chunks' loads in flight), so every launch gives the
//     same bits;
//   * length-aware (K3, K5, K1, K4): a CTA reads positions < min(len, S)
//     only -- a chunk past the lane's length reads nothing (no table
//     entry, no row) and leaves no partial (the merge stops at the last
//     live chunk); a lane of length 0 writes 0.  Masked (K6a, K6b) reads
//     every row of every chunk and folds a dead position in as score
//     -1e30, p = 0: every slot of the softmax and every term of P V that
//     K3 leaves out K6a adds as an exact zero, in the same reduction
//     trees, so the two give the same bits for finite caches;
//   * int8 (K5, K6b, K4): each element is used as (float)kq * ks[row /
//     qblock], one f32 multiply -- the product the reference's
//     dequantize makes -- so the cache is read as int8 and no f32 copy of
//     it is ever written; at qblock = 1 (the model's per-(token, head)
//     scales) K5 gives the bits of dequantize-then-K3.
//   All arithmetic is f32 on the CUDA cores: a kernel bound by bytes
//   gains nothing from the tensor cores.

#pragma once

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
constexpr int MAX_CH = 64;           // longest chunk (the wrapper's CHUNKS)
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

// Where row `pos` of (lane b, kv head kvh) lives: its index among the
// (rows, D) rows of K and V.  The same index over qblock names its scale
// (a lane's S, or a page's ps, is a multiple of qblock).
//   DenseRows: a (B, Hkv, S, D) cache, row (b Hkv + kvh) S + pos;
//   PagedRows: (P, Hkv, ps, D) pools named by a (B, T) block table, row
//   (bt[b, pos / ps] Hkv + kvh) ps + pos % ps.  kTable: the row index
//   costs a load, so a CTA finds its chunk's rows once, before its copies.
struct DenseRows {
  static constexpr bool kTable = false;
  int S;                                   // positions a lane
  __device__ __forceinline__ size_t row(int b, int kvh, int Hkv,
                                        int pos) const {
    return ((size_t)b * Hkv + kvh) * S + pos;
  }
};
struct PagedRows {
  static constexpr bool kTable = true;
  const int32_t* __restrict__ bt;          // (B, T) physical page ids
  int T, ps;
  __device__ __forceinline__ size_t row(int b, int kvh, int Hkv,
                                        int pos) const {
    const size_t page = (size_t)bt[(size_t)b * T + pos / ps];
    return (page * Hkv + kvh) * ps + pos % ps;
  }
};

// One CTA: chunk blockIdx.y of (lane, kv head) blockIdx.x; S positions a
// lane (paged: T ps), found through `rows`.  ws_ml holds (B * Hkv,
// n_chunks, group, 2) f32 (m, l), ws_acc (B * Hkv, n_chunks, group, D)
// f32, counters B * Hkv ints that are 0 between launches.
template <typename T, typename KV, bool MASKED, typename Rows>
__device__ __forceinline__ void split_body(
    const T* __restrict__ q, const KV* __restrict__ k,
    const float* __restrict__ ks, const KV* __restrict__ v,
    const float* __restrict__ vs, const int32_t* __restrict__ lens,
    const Rows rows, T* __restrict__ out, float* __restrict__ ws_ml,
    float* __restrict__ ws_acc, int* __restrict__ counters, int H, int Hkv,
    int S, int D, int qblock, int ch, float scale) {
  constexpr bool Q8 = std::is_same<KV, int8_t>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ bool last;
  __shared__ size_t rid[Rows::kTable ? MAX_CH : 1];
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
    // through a table, each row's index is read once, before any copy,
    // so no row's copies wait behind its own table entry
    if constexpr (Rows::kTable) {
      for (int j = tid; j < n_walk; j += THREADS)
        rid[j] = rows.row(b, kvh, Hkv, p0 + j);
      __syncthreads();
    }
    auto row_of = [&](int j) -> size_t {
      if constexpr (Rows::kTable) return rid[j];
      else return rows.row(b, kvh, Hkv, p0 + j);
    };
    const unsigned char* kg = reinterpret_cast<const unsigned char*>(k);
    const unsigned char* vg = reinterpret_cast<const unsigned char*>(v);
    const int cpr = D * (int)sizeof(KV) / 16;      // 16-byte copies a row
    const size_t gstride = (size_t)D * sizeof(KV);
    for (int i = tid; i < n_walk * cpr; i += THREADS) {
      const int r = i / cpr, cc = i % cpr;
      const size_t src = row_of(r) * gstride + cc * 16;
      cp_async16(smem_u32(kt + r * rs + cc * 16), kg + src);
      cp_async16(smem_u32(vt + r * rs + cc * 16), vg + src);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    if constexpr (Q8) {
      for (int j = tid; j < n_walk; j += THREADS) {
        const size_t srow = row_of(j) / qblock;
        kscale[j] = ks[srow];
        vscale[j] = vs[srow];
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


}  // namespace
