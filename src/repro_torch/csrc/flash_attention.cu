// Flash attention prefill (K2) for Hopper (sm_90a): two kernels.
//
// Replaces: flash_attention_pallas in
//   src/repro/kernels/flash_attention/kernel.py (pl.pallas_call, grid
//   (B, H, Sq/bq, Sk/bk), key axis innermost, f32 running max/sum/acc in
//   VMEM scratch, GQA through kv_head = h // group, optional window).
//
// What bounds it on the H100: a causal prompt of S tokens does ~2*S*S*D
// flops per head against ~4*S*D bytes, so from Sq 1024 (B 1, H 12,
// Hkv 2, D 128) the least time is the causal flops over the 989 TFLOP/s
// bf16 tensor-core peak; at Sq 512 the bytes over 3.35 TB/s bind, just.
// Both are a few microseconds: in practice the heaviest CTA's walk is
// the time, one key block after another, and what each block costs is
// what python -m repro_torch.kernels.breakdown --target k2 reads.
//
// flash_attention_mma_bf16_d{64,128} (bf16, the serves' dtype: every
// prefill of a bf16 model at these head dims):
//   * grid (B*H, ceil(Sq/64)); one CTA of 8 warps owns 64 query rows of
//     one head: warp w takes rows 16 (w % 4) .. + 15 and keys 32 (w / 4)
//     .. + 31 of every key block, with a softmax state of its own, and
//     the two key halves of a row merge once, through shared memory,
//     after the walk (two warps a scheduler hide each other's latency);
//     under a causal mask the q tiles are launched heaviest (last) first,
//     so the longest walks start first;
//   * S = Q K^T and O += P V run on mma.sync.m16n8k16 bf16 with f32
//     accumulators; Q's fragments are loaded once (ldmatrix) and kept in
//     registers, K's come by ldmatrix and V's by ldmatrix.trans;
//   * Q and a ring of three K/V stages (64 keys each) come by TMA
//     (cp.async.bulk.tensor, one thread issuing, an mbarrier a stage)
//     in boxes of 64 rows x 128 bytes with the 128-byte swizzle, so the
//     fragment loads meet no bank twice; rows past Sq or Sk arrive as
//     zeros; a stage is refilled as soon as the block that used it is
//     done (one block barrier a key block), so three blocks are in
//     flight.  TMA rather than 16-byte cp.async copies: with cp.async
//     each block's copies cost its CTA more time than the products;
//   * the online softmax stays in the accumulators' own layout: a row's
//     max and sum are reduced across the 4 threads that hold it with two
//     shuffles; P is rounded to bf16 in registers as the A operand of the
//     P V product (no shared-memory P tile), and l sums the rounded
//     weights, so the output is the weighted mean of exactly the weights
//     applied;
//   * the scale is applied to the f32 scores (with log2 e, for exp2), not
//     to a bf16 q: q * scale is not a bf16 number;
//   * key blocks wholly masked are skipped; only a half block that
//     crosses the diagonal, the window's edge or Sk evaluates the mask (a
//     masked score is -1e30 and its weight 0); a row with no live key
//     writes 0.
// flash_attention_cc_* (float32 at every head dim; bf16 at D 256, where
// the tensor-core kernel's accumulators would not fit in registers, at
// D 32, whose 64-byte rows the 128-byte swizzle does not take, and at
// D 96, phi-3-vision's, until the tensor-core kernel takes it): the
// first design, on the CUDA cores in f32:
//   * grid (B*H, ceil(Sq/64)); one CTA owns 64 query rows of one head and
//     walks the key axis in 64-key blocks staged through shared memory
//     (f32, rows padded against bank conflicts);
//   * 256 threads as a 16x16 grid, each holding a 4x4 register tile of
//     the scores and a 4 x D/16 slice of the f32 accumulator; per-row
//     running max and sum are reduced across the 16 threads of a row with
//     warp shuffles; the same masks and block skipping.
//   float32 stays off the tensor cores on purpose: TF32 products would
//   miss the float32 tolerance (1e-4) and the token-exact float32 serve.
//
// C interface (loaded with ctypes): flash_attention_fwd returns the
// cudaError_t of the launch; it allocates nothing and launches on the
// stream it is given.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "smem_limit.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// ----------------------------------------------------------------------
// flash_attention_mma_bf16_d*: tensor cores
// ----------------------------------------------------------------------

constexpr int MBQ = 64;                 // query rows a CTA (16 a warp)
constexpr int MBK = 64;                 // keys a stage (32 a key half)
constexpr int MWARPS = 8;               // 4 row groups x 2 key halves
constexpr int MTHREADS = 32 * MWARPS;
constexpr int STAGES = 3;               // K/V ring depth
constexpr int BOX = 64;                 // bf16 columns of a TMA box (128 B)

// Shared memory, 1024-aligned (the swizzle's period): Q (64 rows x D),
// then STAGES stages of K and V (64 rows x D each), each a row of boxes
// of 64 rows x 64 columns; then STAGES + 1 mbarriers (one a stage, one
// for Q); and room to align.  After the walk the ring holds the key
// halves' merge.
template <int D>
constexpr int mma_smem_bytes() {
  return 1024 + (int)sizeof(bf16) * MBQ * D * (1 + 2 * STAGES) +
         8 * (STAGES + 1);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// element (r, c) of a tile stored as TMA's 128-byte swizzle left it:
// the 16-byte chunk j of row r of a box sits at chunk j ^ (r % 8), so the
// 8 rows an ldmatrix reads at one chunk fall in 32 different banks
__device__ __forceinline__ const bf16* swz(const bf16* tile, int r, int c) {
  return tile + (c >> 6) * (MBQ * BOX) + r * BOX +
         ((((c & 63) >> 3) ^ (r & 7)) << 3) + (c & 7);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// the one arrival of a phase, which also arms it for `bytes` of copies
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}
// TMA: the (64 columns, 64 rows) box of a 3-d tensor map at (c, r,
// slab) into shared memory, completing on bar; rows past the slab's
// end arrive as zeros
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        int c, int r, int slab,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(r), "r"(slab),
      "r"(smem_u32(bar))
      : "memory");
}
// rows [r, r + 64) of slab `slab`, all D columns, as D / 64 boxes
template <int D>
__device__ __forceinline__ void tma_tile(bf16* dst, const CUtensorMap* map,
                                         int r, int slab, uint64_t* bar) {
#pragma unroll
  for (int b = 0; b < D / BOX; ++b)
    tma_box(dst + b * MBQ * BOX, map, b * BOX, r, slab, bar);
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// two floats as one bf16 pair (lo in the low half), and back
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
}

// scale_log2 = scale * log2(e): scores go to exp2 in log2 units.  Warp w
// owns query rows 16 (w % 4) .. + 15 of the tile and keys 32 (w / 4) ..
// + 31 of every key block, with a softmax state of its own; the two key
// halves of a row merge once, after the walk.
template <int D>
__device__ __forceinline__ void mma_body(const CUtensorMap* qmap,
                                         const CUtensorMap* kmap,
                                         const CUtensorMap* vmap,
                                         bf16* __restrict__ out, int H,
                                         int Hkv, int Sq, int Sk, int causal,
                                         int window, float scale_log2) {
  constexpr int KT = D / 16;            // k-steps of Q K^T
  constexpr int NT = MBK / 16;          // score tiles of 8 keys, a half
  constexpr int DT = D / 8;             // output tiles of 8 columns
  constexpr int TILE = MBQ * D;         // elements of a 64-row tile
  constexpr int STAGE = 2 * TILE;       // K then V
  constexpr int TILE_BYTES = TILE * (int)sizeof(bf16);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  bf16* kv0 = qs + TILE;
  uint64_t* bars = reinterpret_cast<uint64_t*>(kv0 + STAGES * STAGE);
  uint64_t* qbar = bars + STAGES;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / Hkv);
  // heaviest causal tiles (the last rows) launch first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * MBQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wr = warp % 4, half = warp / 4;
  const int g = lane / 4, t = lane % 4;
  const int row0 = q0 + wr * 16 + g, row1 = row0 + 8;

  const int kv_slab = b * Hkv + kvh;

  // key blocks that can hold a live key for rows [q0, q_last]
  const int q_last = min(q0 + MBQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / MBK) * MBK;
  const int n_blk = k_end > k_begin ? (k_end - k_begin + MBK - 1) / MBK : 0;

  // the ring, by TMA from thread 0: block j in stage j % STAGES
  if (tid == 0) {
    for (int i = 0; i <= STAGES; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load = [&](int j) {              // block j, thread 0 only
    uint64_t* bar = &bars[j % STAGES];
    bf16* st = kv0 + (j % STAGES) * STAGE;
    mbar_expect(bar, 2 * TILE_BYTES);
    tma_tile<D>(st, kmap, k_begin + j * MBK, kv_slab, bar);
    tma_tile<D>(st + TILE, vmap, k_begin + j * MBK, kv_slab, bar);
  };
  if (tid == 0) {
    mbar_expect(qbar, TILE_BYTES);
    tma_tile<D>(qs, qmap, q0, bh, qbar);
    for (int j = 0; j < STAGES && j < n_blk; ++j) load(j);
  }

  float o[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  mbar_wait(qbar, 0);
  // Q's A fragments: rows 16 wr + lane % 16, columns 16 kk + 8 (lane / 16)
  uint32_t qa[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk)
    ldsm_x4(qa[kk], swz(qs, wr * 16 + (lane & 15), kk * 16 + (lane >> 4) * 8));

  for (int it = 0; it < n_blk; ++it) {
    mbar_wait(&bars[it % STAGES], (it / STAGES) & 1);   // block it landed
    const int k0 = k_begin + it * MBK + half * (MBK / 2);   // this half
    const int r0 = half * (MBK / 2);    // its first row in the stage
    const bf16* ks = kv0 + (it % STAGES) * STAGE;
    const bf16* vs = ks + TILE;

    // S = Q K^T: K's B fragments for score tiles 2 np and 2 np + 1
    float s[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bfr[4];
        ldsm_x4(bfr, swz(ks, r0 + np * 16 + (lane >> 4) * 8 + (lane & 7),
                         kk * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16(s[2 * np], qa[kk], bfr[0], bfr[1]);
        mma_bf16(s[2 * np + 1], qa[kk], bfr[2], bfr[3]);
      }
    }

    // only a half block crossing the diagonal, the window's edge or Sk
    // masks
    const bool need_mask = (causal && k0 + MBK / 2 - 1 > q0) ||
                           (window > 0 && q0 + MBQ - 1 - k0 >= window) ||
                           k0 + MBK / 2 > Sk;
    // element e of tile i: row (e < 2 ? row0 : row1), key
    // k0 + 8 i + 2 t + (e & 1)
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < NT; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[i][e] * scale_log2;
        if (need_mask) {
          const int kj = k0 + 8 * i + 2 * t + (e & 1);
          const int qi = e < 2 ? row0 : row1;
          bool ok = kj < Sk;
          if (causal) ok = ok && qi >= kj;
          if (window > 0) ok = ok && qi - kj < window;
          if (!ok) x = NEG_INF;
        }
        s[i][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
    // P in bf16 as the A operand of P V: k-step j takes score tiles 2 j
    // (registers 0, 1) and 2 j + 1 (registers 2, 3)
    uint32_t pa[NT / 2][4];
    float rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[i][e];
        // a masked score's weight is 0, also in a row with no live key yet
        p[e] = need_mask && x == NEG_INF ? 0.f : exp2f(x - m[e >> 1]);
      }
      const uint32_t lo = pack_bf16(p[0], p[1]), hi = pack_bf16(p[2], p[3]);
      const float2 flo = unpack_bf16(lo), fhi = unpack_bf16(hi);
      rsum[0] += flo.x + flo.y;
      rsum[1] += fhi.x + fhi.y;
      pa[i >> 1][(i & 1) * 2] = lo;
      pa[i >> 1][(i & 1) * 2 + 1] = hi;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rsum[r];
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      o[i][0] *= alpha[0]; o[i][1] *= alpha[0];
      o[i][2] *= alpha[1]; o[i][3] *= alpha[1];
    }

    // O += P V: V's B fragments (ldmatrix.trans) for output tiles 2 dp
    // and 2 dp + 1
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t bfr[4];
        ldsm_x4_t(bfr, swz(vs, r0 + kk * 16 + (lane & 7) +
                                   ((lane >> 3) & 1) * 8,
                           dp * 16 + (lane >> 4) * 8));
        mma_bf16(o[2 * dp], pa[kk], bfr[0], bfr[1]);
        mma_bf16(o[2 * dp + 1], pa[kk], bfr[2], bfr[3]);
      }
    }
    // every warp is done with block it: its stage takes block it + STAGES
    __syncthreads();
    if (tid == 0 && it + STAGES < n_blk) load(it + STAGES);
  }

  // the second key half hands its state to the first through the ring's
  // shared memory (every copy issued has landed and been read): o by
  // (warp, tile, lane) as float4, then m and l
  __syncthreads();
  float4* xo = reinterpret_cast<float4*>(kv0);
  float2* xm = reinterpret_cast<float2*>(xo + 4 * DT * 32);
  if (half == 1) {
#pragma unroll
    for (int i = 0; i < DT; ++i)
      xo[(wr * DT + i) * 32 + lane] =
          make_float4(o[i][0], o[i][1], o[i][2], o[i][3]);
    xm[wr * 64 + lane] = make_float2(m[0], m[1]);
    xm[wr * 64 + 32 + lane] = make_float2(l[0], l[1]);
  }
  __syncthreads();
  if (half == 1) return;
  {
    const float2 mb = xm[wr * 64 + lane], lb = xm[wr * 64 + 32 + lane];
    const float mbr[2] = {mb.x, mb.y}, lbr[2] = {lb.x, lb.y};
    float fa[2], fb[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mm = fmaxf(m[r], mbr[r]);
      fa[r] = exp2f(m[r] - mm);
      fb[r] = exp2f(mbr[r] - mm);
      l[r] = l[r] * fa[r] + lbr[r] * fb[r];
    }
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      const float4 x = xo[(wr * DT + i) * 32 + lane];
      o[i][0] = o[i][0] * fa[0] + x.x * fb[0];
      o[i][1] = o[i][1] * fa[0] + x.y * fb[0];
      o[i][2] = o[i][2] * fa[1] + x.z * fb[1];
      o[i][3] = o[i][3] * fa[1] + x.w * fb[1];
    }
  }

  // each thread holds a quarter of its rows' sums
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  bf16* ob = out + ((size_t)b * H + h) * (size_t)Sq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = r ? row1 : row0;
    if (qi >= Sq) continue;
    const float inv = l[r] == 0.f ? 0.f : 1.f / l[r];
#pragma unroll
    for (int i = 0; i < DT; ++i)
      *reinterpret_cast<uint32_t*>(ob + (size_t)qi * D + 8 * i + 2 * t) =
          pack_bf16(o[i][2 * r] * inv, o[i][2 * r + 1] * inv);
  }
}

#define MMA_KERNEL(D)                                                      \
  __global__ void __launch_bounds__(MTHREADS) flash_attention_mma_bf16_d##D( \
      const __grid_constant__ CUtensorMap qmap,                            \
      const __grid_constant__ CUtensorMap kmap,                            \
      const __grid_constant__ CUtensorMap vmap, bf16* out, int H, int Hkv, \
      int Sq, int Sk, int causal, int window, float scale_log2) {          \
    mma_body<D>(&qmap, &kmap, &vmap, out, H, Hkv, Sq, Sk, causal, window,  \
                scale_log2);                                               \
  }
MMA_KERNEL(64)
MMA_KERNEL(128)
#undef MMA_KERNEL

using MmaKernel = void (*)(const CUtensorMap, const CUtensorMap,
                           const CUtensorMap, bf16*, int, int, int, int, int,
                           int, float);

// cuTensorMapEncodeTiled, found through the runtime's entry-point
// lookup, so that the library links no libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a bf16 (slabs, rows, D) array at p, read in boxes of
// 64 columns x 64 rows of one slab, with the 128-byte swizzle; rows past
// a slab's end read as zeros.
bool tensor_map(CUtensorMap* map, const void* p, int d, int rows,
                int slabs) {
  const EncodeTiled encode = encode_tiled();
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)slabs};
  const cuuint64_t stride[2] = {(cuuint64_t)d * sizeof(bf16),
                                (cuuint64_t)rows * d * sizeof(bf16)};
  const cuuint32_t box[3] = {BOX, MBQ, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(p), dims, stride, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_mma(MmaKernel kernel, int* allowed, const void* q,
                       const void* k, const void* v, void* o, int B, int H,
                       int Hkv, int Sq, int Sk, int causal, int window,
                       float scale, cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes<D>();
  cudaError_t err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  CUtensorMap qmap, kmap, vmap;
  if (!tensor_map(&qmap, q, D, Sq, B * H) ||
      !tensor_map(&kmap, k, D, Sk, B * Hkv) ||
      !tensor_map(&vmap, v, D, Sk, B * Hkv))
    return cudaErrorInvalidValue;
  dim3 grid(B * H, (Sq + MBQ - 1) / MBQ);
  kernel<<<grid, MTHREADS, smem, stream>>>(
      qmap, kmap, vmap, static_cast<bf16*>(o), H, Hkv, Sq, Sk, causal,
      window, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// ----------------------------------------------------------------------
// flash_attention_cc_*: CUDA cores, f32
// ----------------------------------------------------------------------

constexpr int BQ = 64;         // query rows per CTA
constexpr int BK = 64;         // keys per shared-memory stage
constexpr int THREADS = 256;   // 16 x 16
constexpr int R = 4;           // rows per thread (ty + 16*r)
constexpr int C = 4;           // key columns per thread (tx + 16*c)

template <int D>
constexpr size_t smem_bytes() {
  // Q and K tiles padded to D+1, V tile D, P tile BK+1, all f32
  return sizeof(float) *
         (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <int D, typename T>
__device__ __forceinline__ void cc_body(const T* __restrict__ q,
                                        const T* __restrict__ k,
                                        const T* __restrict__ v,
                                        T* __restrict__ out, int H, int Hkv,
                                        int Sq, int Sk, int causal,
                                        int window, float scale) {
  constexpr int DP = D + 1;
  constexpr int NK = D / 16;   // accumulator columns per thread
  extern __shared__ float smem[];  // smem_bytes<D>()
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


#define CC_KERNEL(name, D, T)                                              \
  __global__ void __launch_bounds__(THREADS)                               \
      name(const T* q, const T* k, const T* v, T* out, int H, int Hkv,      \
           int Sq, int Sk, int causal, int window, float scale) {          \
    cc_body<D, T>(q, k, v, out, H, Hkv, Sq, Sk, causal, window, scale);    \
  }
CC_KERNEL(flash_attention_cc_f32_d32, 32, float)
CC_KERNEL(flash_attention_cc_f32_d64, 64, float)
CC_KERNEL(flash_attention_cc_f32_d96, 96, float)
CC_KERNEL(flash_attention_cc_f32_d128, 128, float)
CC_KERNEL(flash_attention_cc_f32_d256, 256, float)
CC_KERNEL(flash_attention_cc_bf16_d32, 32, bf16)
CC_KERNEL(flash_attention_cc_bf16_d96, 96, bf16)
CC_KERNEL(flash_attention_cc_bf16_d256, 256, bf16)
#undef CC_KERNEL

template <int D, typename T>
cudaError_t launch_cc(void (*kernel)(const T*, const T*, const T*, T*, int,
                                     int, int, int, int, int, float),
                      int* allowed, const void* q, const void* k,
                      const void* v, void* o, int B, int H, int Hkv, int Sq,
                      int Sk, int causal, int window, float scale,
                      cudaStream_t stream) {
  constexpr int smem = (int)smem_bytes<D>();
  cudaError_t err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Hkv, Sq, Sk, causal,
      window, scale);
  return cudaGetLastError();
}

}  // namespace

// window <= 0 means no sliding window.  kernel 1 is the tensor-core
// kernel (bf16, D 64/128, 16-byte aligned q/k/v/out), kernel 0 the
// CUDA-core one (float32 at D 32/64/96/128/256, bf16 at D 32/96/256).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int B, int H,
                                   int Hkv, int Sq, int Sk, int D, int causal,
                                   int window, float scale, int dtype,
                                   int kernel, void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || Sq <= 0 || Sk <= 0 ||
      (Sq + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GO(kind, DD, T, name)                                              \
  {                                                                        \
    static int allowed[64] = {};                                           \
    return (int)launch_##kind<DD>(name, allowed, q, k, v, out, B, H, Hkv,   \
                                  Sq, Sk, causal, window, scale, s);        \
  }
  if (kernel == 1 && dtype == 1) {
    if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16)
      return (int)cudaErrorInvalidValue;
    switch (D) {
      case 64: GO(mma, 64, bf16, flash_attention_mma_bf16_d64)
      case 128: GO(mma, 128, bf16, flash_attention_mma_bf16_d128)
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (kernel == 0 && dtype == 0) {
    switch (D) {
      case 32: GO(cc, 32, float, flash_attention_cc_f32_d32)
      case 64: GO(cc, 64, float, flash_attention_cc_f32_d64)
      case 96: GO(cc, 96, float, flash_attention_cc_f32_d96)
      case 128: GO(cc, 128, float, flash_attention_cc_f32_d128)
      case 256: GO(cc, 256, float, flash_attention_cc_f32_d256)
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (kernel == 0 && dtype == 1) {
    switch (D) {
      case 32: GO(cc, 32, bf16, flash_attention_cc_bf16_d32)
      case 96: GO(cc, 96, bf16, flash_attention_cc_bf16_d96)
      case 256: GO(cc, 256, bf16, flash_attention_cc_bf16_d256)
      default: return (int)cudaErrorInvalidValue;
    }
  }
#undef GO
  return (int)cudaErrorInvalidValue;
}
