// SSD (Mamba-2) intra-chunk scan (K10) for Hopper (sm_90a), on the
// tensor cores.
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
// N 128, Q 256), B 1 and S 1024 the function reads x, dt, B and C once
// and writes y, the states and the decays once: 26 MB, 7.7 us at 3.35
// TB/s.  Its products -- C.B^T over each chunk's lower triangle once per
// (b, z), since B and C are shared by the heads, then per head the
// triangle's products with dt*x and the N x P boundary state -- are 1.65
// GFLOP, 3.3 us at 495 TFLOP/s TF32.  The splits below run more products
// than that on the card, but the function's bound is what it needs, not
// what this kernel spends.
//
// Why the products are split: the plain version is float32 and K10 is
// held to it within 1e-5 relative.  One TF32 product (10 mantissa bits)
// misses that by ~30x.  So each f32 operand is cut into parts whose
// products with the other operand are exact in f32:
//   * bf16 x, B and C: C.B^T runs on mma.sync.m16n8k16 bf16 with f32
//     sums (bf16 products are exact); x is a bf16 operand as it stands,
//     and the f32 operand A of y = W' x and of the state is cut into
//     three bf16 parts (8 + 8 + 8 bits): three bf16 products per 16 keys
//     (mma.sync issues an m16n8k16 bf16 as fast as an m16n8k8 tf32, so
//     this is 3 instructions where two TF32 parts take 4);
//   * f32 x, B and C: every product is 3xTF32 on m16n8k8, a_hi b_hi +
//     a_lo b_hi + a_hi b_lo with v_hi = tf32(v), v_lo = tf32(v - v_hi)
//     (the lo*lo term is below f32's rounding).
// The CPU tests emulate both and hold them within 1e-6 of the plain
// version (tests/test_torch_ssd.py).
//
// What the design does about both (mma.sync, as K9 and K2 use it):
//   * launch 1, ssd_cb_*: one CTA per 64 x 64 tile of the lower triangle
//     of C.B^T per (b, z); 4 warps of 16 rows each; it writes the tile to
//     an f32 workspace (the wrapper's torch.empty, QP^2 floats a chunk,
//     QP = Q rounded up to 64: 256 KB at Q 256, so it stays in L2) in
//     the order of launch 2's A fragments, so a lane reads its values of
//     a block with 16-byte loads;
//   * launch 2, ssd_chunk_*: per (b, z, h) ceil(Q/64) CTAs of 64 output
//     rows (the heaviest first) and ceil(N/64) CTAs of 64 state rows, so
//     a one-chunk prompt at 48 heads still launches 288 CTAs on 132 SMs.
//     It goes out as a programmatic dependent launch: its prologue and
//     its state CTAs overlap launch 1, and its output CTAs wait for
//     launch 1 (griddepcontrol.wait) before they read the workspace.
//     Each CTA takes dt's cumsum over the chunk as a block scan (products
//     rounded to f32 as the plain version's, sums kept in f64, so each
//     difference cum_i - cum_j is rounded once, before its exp),
//     then builds its A fragments in registers: W'_ij = (C.B^T)_ij
//     exp(cum_i - cum_j) dt_j (dt folded into the columns, so the B
//     operand is the raw x) for the output rows, B_jn exp(cum_{Q-1} -
//     cum_j) dt_j for the state rows.  Below the diagonal tile exp(cum_i
//     - cum_j) is a row factor times a column factor, exp(cum_i - cum_i0)
//     exp(cum_i0 - cum_j): both exponents are <= 0 (A < 0, dt >= 0), so
//     no exp per element there, no overflow and no cancellation.  On the
//     diagonal tile exp is taken per element, only where j <= i (above
//     the diagonal the exponent is positive and may overflow), and key
//     steps above a warp's rows are skipped;
//   * x (and a state CTA's B) is staged a 64-key tile at a time by
//     16-byte cp.async, two stages deep, as it lies in memory (rows of 72
//     elements, so fragment loads and ldmatrix meet no bank twice), with
//     the C.B^T tile beside it; rows past Q and columns past P are
//     zero-filled by the copies, and the inner loops run whole tiles
//     without a branch, so loads and products interleave;
//   * each warp's 16 x 64 result goes out through its own rows of shared
//     memory, as whole rows of 16-byte stores.
//   wgmma and a TMA ring are later work.
//
// C interface (loaded with ctypes): ssd_chunk_fwd returns the cudaError_t
// of the launches; it allocates nothing and launches on the stream it is
// given.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "smem_limit.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int TILE = 64;       // rows and keys per tile
constexpr int THREADS = 128;   // 4 warps of 16 rows
constexpr int XS = TILE + 8;   // row stride (elements) of staged x and B
constexpr int MAX_N = 128;     // state width
constexpr int MAX_P = 64;      // head width (the accumulators' 8 n-blocks)
constexpr int MAX_Q = 1024;    // longest chunk

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);
}

// v rounded to TF32 (nearest, ties away), as an f32 with 13 zero low bits
__device__ __forceinline__ float tf32(float v) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(v));
  return __uint_as_float(u & 0xffffe000u);
}
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  const float h = tf32(v);
  hi = __float_as_uint(h);
  lo = __float_as_uint(tf32(v - h));
}

// Fragments (PTX ISA; g = lane / 4, t = lane % 4).  m16n8k8 tf32: A
// (g, t), (g+8, t), (g, t+4), (g+8, t+4); B (k t, n g), (k t+4, n g).
// m16n8k16 bf16: A pairs at (g, 2t), (g+8, 2t), (g, 2t+8), (g+8, 2t+8);
// B pairs at (k 2t, n g), (k 2t+8, n g).  Both: D (g, 2t), (g, 2t+1),
// (g+8, 2t), (g+8, 2t+1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The workspace of one chunk is QP x QP floats, 16 rows (QP floats x
// 16) at a time; within 16 rows, keys go in blocks in the order of the
// A fragments that read them (g = lane / 4, t = lane % 4):
//   * tf32 (f32 x): blocks of 8 keys, 128 floats; lane g*4 + t holds at
//     4 lane + r its value r: row g + 8 (r & 1), key t + 4 (r >> 1);
//   * bf16 x: blocks of 16 keys, 256 floats; lane g*4 + t holds at 8 lane
//     + 2 r + e the element e of its pair r: row g + 8 (r & 1), key 2t +
//     8 (r >> 1) + e.
__device__ __forceinline__ int ws_slot(int rr, int cc) {   // tf32 order
  return ((rr & 7) * 4 + (cc & 3)) * 4 + (rr >> 3) + 2 * (cc >> 2);
}

// 8-key steps of key tile j0 whose keys a warp of rows r0 .. r0+15 of the
// row tile i0 uses: none past Q, none wholly above the diagonal.  Both
// launches take it from here, so launch 2 reads what launch 1 wrote.
__device__ __forceinline__ int key_steps(int i0, int j0, int warp, int Q) {
  const int n = min(TILE / 8, (Q - j0 + 7) / 8);
  return i0 == j0 ? min(n, 2 * warp + 2) : n;
}

// bf16 pairs: (lo, hi) rounded into one register, lo in the low half;
// a pair's halves back as f32
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t u;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(u) : "f"(hi), "f"(lo));
  return u;
}
__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}
// the pair (v0, v1) as three bf16 parts, exact to f32's rounding: p[0]
// carries the leading 8 bits, p[1] the next 8 of what is left, p[2] the rest
__device__ __forceinline__ void split3(float v0, float v1, uint32_t& p0,
                                       uint32_t& p1, uint32_t& p2) {
  p0 = pack_bf16(v0, v1);
  v0 -= bf16_lo(p0);
  v1 -= bf16_hi(p0);
  p1 = pack_bf16(v0, v1);
  v0 -= bf16_lo(p1);
  v1 -= bf16_hi(p1);
  p2 = pack_bf16(v0, v1);
}

// ldmatrix.x4.trans: lanes 8q .. 8q+7 give the rows of 8 x 16-byte
// matrix q; each lane gets the two 16-bit elements of column lane / 4 at
// rows 2 (lane % 4) and the next, of every matrix
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// 16-byte copies global -> shared (cp.async, zero-filled where `in` is
// false: nothing is read then), and their groups
__device__ __forceinline__ void cp16(void* dst, const void* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows 0 .. TILE-1 of a row-major matrix (row r at src + r ld) into dst
// (row stride `stride`), columns 0 .. cols-1: zero at rows >= rows and
// columns >= width.  `vec`: by 16-byte cp.async (width a multiple of 16
// bytes, every row 16-byte aligned), else by plain loads and stores.
template <typename T>
__device__ __forceinline__ void copy_tile(T* dst, int stride, int cols,
                                          const T* src, long long ld,
                                          int rows, int width, bool vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int per_row = cols / V;
    for (int e = threadIdx.x; e < TILE * per_row; e += THREADS) {
      const int r = e / per_row, col = (e - r * per_row) * V;
      const bool in = r < rows && col < width;
      cp16(dst + r * stride + col, in ? src + r * ld + col : src, in);
    }
  } else {
    for (int e = threadIdx.x; e < TILE * cols; e += THREADS) {
      const int r = e / cols, col = e - r * cols;
      dst[r * stride + col] = r < rows && col < width ? src[r * ld + col]
                                                      : from_f32<T>(0.f);
    }
  }
}

// ----------------------------------------------------------------------
// launch 1: C.B^T over the lower triangle, once per (b, z)
// ----------------------------------------------------------------------

template <typename T>
__host__ __device__ constexpr int cb_depth() {   // mma K
  return sizeof(T) == 4 ? 8 : 16;
}
// a staged C or B row: N rounded up to the mma depth, plus 16 bytes (an
// odd multiple of 16 bytes in all, so fragment loads meet no bank twice)
template <typename T>
__host__ __device__ int cb_stride(int N) {
  return (N + cb_depth<T>() - 1) / cb_depth<T>() * cb_depth<T>() +
         16 / (int)sizeof(T);
}

template <typename T>
__device__ __forceinline__ void cb_body(const T* __restrict__ bm,
                                        const T* __restrict__ cm,
                                        float* __restrict__ ws, int N, int Q,
                                        bool vec) {
  constexpr int KD = cb_depth<T>();
  const int nk = (N + KD - 1) / KD, stride = cb_stride<T>(N);
  const int QP = (Q + TILE - 1) / TILE * TILE;
  // launch 2 may start now: its output CTAs wait for this grid's end
  // (griddepcontrol.wait) before they read the workspace
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  int ti = 0;                          // tile (ti, tj), tj <= ti
  while ((ti + 1) * (ti + 2) / 2 <= (int)blockIdx.x) ++ti;
  const int tj = blockIdx.x - ti * (ti + 1) / 2;
  const int i0 = ti * TILE, j0 = tj * TILE;
  const long long row0 = (long long)blockIdx.y * Q;   // (b, z)'s first row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cs = reinterpret_cast<T*>(smem_raw);  // C rows i0 .., then B rows j0 ..
  T* bs = cs + TILE * stride;
  copy_tile(cs, stride, nk * KD, cm + (row0 + i0) * N, N, Q - i0, N, vec);
  copy_tile(bs, stride, nk * KD, bm + (row0 + j0) * N, N, Q - j0, N, vec);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, r0 = 16 * warp;
  if (i0 + r0 >= Q) return;
  const int nbs = key_steps(i0, j0, warp, Q);
  float acc[TILE / 8][4] = {};
  for (int k = 0; k < nk; ++k) {
    if constexpr (sizeof(T) == 4) {
      const float* c0 = cs + (r0 + g) * stride + k * 8 + t;
      uint32_t ah[4], al[4];
      split(c0[0], ah[0], al[0]);
      split(c0[8 * stride], ah[1], al[1]);
      split(c0[4], ah[2], al[2]);
      split(c0[8 * stride + 4], ah[3], al[3]);
#pragma unroll
      for (int nb = 0; nb < TILE / 8; ++nb) {
        if (nb >= nbs) break;
        const float* b0 = bs + (nb * 8 + g) * stride + k * 8 + t;
        uint32_t bh0, bl0, bh1, bl1;
        split(b0[0], bh0, bl0);
        split(b0[4], bh1, bl1);
        mma_tf32(acc[nb], al, bh0, bh1);
        mma_tf32(acc[nb], ah, bl0, bl1);
        mma_tf32(acc[nb], ah, bh0, bh1);
      }
    } else {
      const int sw = stride / 2;        // 32-bit words a row
      const uint32_t* cw = reinterpret_cast<const uint32_t*>(cs) +
                           (r0 + g) * sw + k * 8 + t;
      const uint32_t a[4] = {cw[0], cw[8 * sw], cw[4], cw[8 * sw + 4]};
#pragma unroll
      for (int nb = 0; nb < TILE / 8; ++nb) {
        if (nb >= nbs) break;
        const uint32_t* bw = reinterpret_cast<const uint32_t*>(bs) +
                             (nb * 8 + g) * sw + k * 8 + t;
        mma_bf16(acc[nb], a, bw[0], bw[4]);
      }
    }
  }
  // this warp's 16 rows, from key j0 on
  float* out = ws + (long long)blockIdx.y * QP * QP +
               (long long)(i0 + r0) * QP + j0 * 16;
#pragma unroll
  for (int nb = 0; nb < TILE / 8; ++nb) {
    if (nb >= nbs) break;
    if constexpr (sizeof(T) == 4) {
      float* blk = out + nb * 128;
      blk[ws_slot(g, 2 * t)] = acc[nb][0];
      blk[ws_slot(g, 2 * t + 1)] = acc[nb][1];
      blk[ws_slot(g + 8, 2 * t)] = acc[nb][2];
      blk[ws_slot(g + 8, 2 * t + 1)] = acc[nb][3];
    } else {   // pairs r = 2 (nb & 1) and the next: 4 values in a row
      *reinterpret_cast<float4*>(out + (nb / 2) * 256 + lane * 8 +
                                 4 * (nb & 1)) =
          make_float4(acc[nb][0], acc[nb][1], acc[nb][2], acc[nb][3]);
    }
  }
}

// ----------------------------------------------------------------------
// launch 2: per (b, z, h), the output rows and the boundary state
// ----------------------------------------------------------------------

// two stages of a C.B^T tile (output CTAs) or of a B tile (state CTAs);
// after the last tile, the 64 x OS floats of the output staging
template <typename T>
__host__ __device__ constexpr int pair_bytes() {
  return 2 * TILE * TILE * 4 > 2 * TILE * XS * (int)sizeof(T)
             ? 2 * TILE * TILE * 4 : 2 * TILE * XS * (int)sizeof(T);
}
template <typename T>
size_t chunk_smem(int Q) {
  const int QP = (Q + TILE - 1) / TILE * TILE;
  // cum (f64), dt and the column factors (f32); two stages of the x tile
  // (T) and two of the C.B^T or the B tile
  return sizeof(float) * 4 * (size_t)QP +
         sizeof(T) * 2 * (size_t)TILE * XS + pair_bytes<T>();
}

// f32 x: acc (16 x 64) += A (16 x 8, TF32 hi/lo) . x rows k0 .. k0+7 of a
// staged tile, 3xTF32: A_lo x_hi + A_hi x_lo + A_hi x_hi.  All 8 column
// blocks, without a branch (columns past P are staged as zeros), so the
// loads and products of the blocks interleave.
__device__ __forceinline__ void products(float (&acc)[MAX_P / 8][4],
                                         const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4],
                                         const float* xs, int k0, int g,
                                         int t) {
#pragma unroll
  for (int nb = 0; nb < MAX_P / 8; ++nb) {
    const int o = (k0 + t) * XS + nb * 8 + g;
    uint32_t bh0, bl0, bh1, bl1;
    split(xs[o], bh0, bl0);
    split(xs[o + 4 * XS], bh1, bl1);
    mma_tf32(acc[nb], al, bh0, bh1);
    mma_tf32(acc[nb], ah, bl0, bl1);
    mma_tf32(acc[nb], ah, bh0, bh1);
  }
}

// bf16 x: acc (16 x 64) += A (16 x 16, three bf16 parts) . x rows k0 ..
// k0+15 of a staged tile; x's fragments by ldmatrix.trans, two column
// blocks a load
__device__ __forceinline__ void products(float (&acc)[MAX_P / 8][4],
                                         const uint32_t (&ap)[3][4],
                                         const bf16* xs, int k0, int lane) {
  const int q = lane >> 3, rr = lane & 7;
#pragma unroll
  for (int nb = 0; nb < MAX_P / 8; nb += 2) {
    uint32_t b[4];
    ldsm_x4_trans(b, xs + (k0 + rr + 8 * (q & 1)) * XS + nb * 8 +
                         8 * (q >> 1));
#pragma unroll
    for (int part = 2; part >= 0; --part) {
      mma_bf16(acc[nb], ap[part], b[0], b[1]);
      mma_bf16(acc[nb + 1], ap[part], b[2], b[3]);
    }
  }
}

// One key step of an output CTA's rows r0 .. r0+15 (8 keys for f32 x, 16
// for bf16) at step kk of a staged tile: the A fragment from the C.B^T
// tile (gs: this warp's 16 rows) through `weight(cb, row offset, key
// offset)`, then its products with x.
template <typename T, typename Weight>
__device__ __forceinline__ void row_step(float (&acc)[MAX_P / 8][4],
                                         const float* gs, const T* xs,
                                         int kk, int lane, Weight weight) {
  const int g = lane >> 2, t = lane & 3;
  if constexpr (sizeof(T) == 4) {
    const float4 c4 = *reinterpret_cast<const float4*>(gs + kk * 128 +
                                                       lane * 4);
    const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
    uint32_t ah[4], al[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split(weight(cv[r], 8 * (r & 1), kk * 8 + t + 4 * (r >> 1)), ah[r],
            al[r]);
    products(acc, ah, al, xs, kk * 8, g, t);
  } else {
    const float4* c4 = reinterpret_cast<const float4*>(gs + kk * 256 +
                                                       lane * 8);
    const float4 u = c4[0], v = c4[1];
    const float cv[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
    uint32_t ap[3][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int ko = kk * 16 + 2 * t + 8 * (r >> 1);
      split3(weight(cv[2 * r], 8 * (r & 1), ko),
             weight(cv[2 * r + 1], 8 * (r & 1), ko + 1), ap[0][r], ap[1][r],
             ap[2][r]);
    }
    products(acc, ap, xs, kk * 16, lane);
  }
}

// One key step of a state CTA's rows nw .. nw+15 (this warp's, within
// the tile's 64) at step kk of a staged tile: A = B_jn fac_j.
__device__ __forceinline__ void state_step(float (&acc)[MAX_P / 8][4],
                                           const float* bs, const float* xs,
                                           const float* fac, int kk, int nw,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t ah[4], al[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = kk * 8 + t + 4 * (r >> 1);
    split(bs[j * XS + nw + g + 8 * (r & 1)] * fac[j], ah[r], al[r]);
  }
  products(acc, ah, al, xs, kk * 8, g, t);
}
__device__ __forceinline__ void state_step(float (&acc)[MAX_P / 8][4],
                                           const bf16* bs, const bf16* xs,
                                           const float* fac, int kk, int nw,
                                           int lane) {
  const int q = lane >> 3, rr = lane & 7, t = lane & 3;
  // A's pairs straight from the B tile (rows j, columns n): matrices
  // (keys +8 for q >= 2, rows n +8 for q odd) are pairs a0 .. a3
  uint32_t braw[4];
  ldsm_x4_trans(braw, bs + (kk * 16 + rr + 8 * (q >> 1)) * XS + nw +
                          8 * (q & 1));
  const float2 f0 = *reinterpret_cast<const float2*>(fac + kk * 16 + 2 * t);
  const float2 f8 =
      *reinterpret_cast<const float2*>(fac + kk * 16 + 2 * t + 8);
  uint32_t ap[3][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float2 f = r < 2 ? f0 : f8;
    split3(bf16_lo(braw[r]) * f.x, bf16_hi(braw[r]) * f.y, ap[0][r],
           ap[1][r], ap[2][r]);
  }
  products(acc, ap, xs, kk * 16, lane);
}

// A warp's 16 x 64 accumulators (rows g, g+8 and columns 2t, 2t+1 of
// each 8-column block) out to rows 0 .. rows-1 at row(r), P floats each,
// through the warp's own 16 rows of shared memory (`ot`, rows of 72
// floats), so the stores are whole 16-byte chunks of whole rows.
constexpr int OS = 72;   // row stride of the output staging
template <typename Row>
__device__ __forceinline__ void store_rows(const float (&acc)[MAX_P / 8][4],
                                           float* ot, int rows, int P,
                                           int lane, Row row) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nb = 0; nb < MAX_P / 8; ++nb) {
    *reinterpret_cast<float2*>(ot + g * OS + nb * 8 + 2 * t) =
        make_float2(acc[nb][0], acc[nb][1]);
    *reinterpret_cast<float2*>(ot + (g + 8) * OS + nb * 8 + 2 * t) =
        make_float2(acc[nb][2], acc[nb][3]);
  }
  __syncwarp();
  if (P % 4 == 0) {
#pragma unroll
    for (int it = 0; it < 8; ++it) {
      const int r = 2 * it + (lane >> 4), c = (lane & 15) * 4;
      if (r < rows && c < P)
        *reinterpret_cast<float4*>(row(r) + c) =
            *reinterpret_cast<const float4*>(ot + r * OS + c);
    }
  } else {
    for (int e = lane; e < 16 * MAX_P; e += 32) {
      const int r = e / MAX_P, c = e % MAX_P;
      if (r < rows && c < P) row(r)[c] = ot[r * OS + c];
    }
  }
}

template <typename T>
__device__ __forceinline__ void chunk_body(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ a, const T* __restrict__ bm,
    const float* __restrict__ ws, float* __restrict__ y,
    float* __restrict__ states, float* __restrict__ decay, int H, int P,
    int N, int Q, bool vec) {
  constexpr int KS = sizeof(T) == 4 ? 8 : 16;   // keys a step
  static_assert(TILE * OS * 4 <= pair_bytes<T>(), "staging outgrows stages");
  const int RB = (Q + TILE - 1) / TILE, QP = RB * TILE;
  const int part = blockIdx.x, h = blockIdx.y, chunk = blockIdx.z;
  const long long row0 = (long long)chunk * Q;         // (b, z)'s first row
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4;
  extern __shared__ __align__(16) float smem[];
  double* cum = reinterpret_cast<double*>(smem);   // QP
  float* dts = smem + 2 * QP;         // QP
  float* fac = dts + QP;              // QP: column factors
  T* xr = reinterpret_cast<T*>(fac + QP);   // 2 stages of TILE x XS
  // 2 stages of C.B^T (output CTAs: TILE x TILE f32 in fragment order)
  // or of B (state CTAs: TILE x XS)
  float* gr = reinterpret_cast<float*>(xr + 2 * TILE * XS);
  T* br = reinterpret_cast<T*>(gr);
  __shared__ double warp_sum[THREADS / 32];
  const bool rows_part = part < RB;
  const int i0 = (RB - 1 - part) * TILE;    // an output CTA's first row
  const int n0 = (part - RB) * TILE;        // a state CTA's first row
  // key tile kt of x, and of B for a state CTA, into stage kt & 1
  auto stage = [&](int kt) {
    const int j0 = kt * TILE, st = (kt & 1) * TILE * XS;
    copy_tile(xr + st, XS, TILE, x + ((row0 + j0) * H + h) * P,
              (long long)H * P, Q - j0, P, vec);
    if (!rows_part)
      copy_tile(br + st, XS, TILE, bm + (row0 + j0) * N + n0, N, Q - j0,
                N - n0, vec);
  };
  // an output CTA's C.B^T tile (rows i0 .., keys of tile kt) into stage
  // kt & 1: four runs of TILE x 16 floats, one per 16 rows
  auto stage_cb = [&](int kt) {
    float* dst = gr + (kt & 1) * TILE * TILE;
    const float* src = ws + (long long)chunk * QP * QP + (long long)i0 * QP +
                       kt * TILE * 16;
    constexpr int RUN = TILE * 16 / 4;          // 16-byte copies a run
    for (int e = tid; e < 4 * RUN; e += THREADS) {
      const int run = e / RUN, o = (e % RUN) * 4;
      cp16(dst + run * RUN * 4 + o, src + (long long)run * QP * 16 + o, true);
    }
  };
  stage(0);

  const float A = a[h];
  for (int i = tid; i < QP; i += THREADS)
    dts[i] = i < Q ? dt[(row0 + i) * H + h] : 0.f;
  __syncthreads();
  // inclusive cumsum of dt*A: each product rounded to f32 (as the plain
  // version's), E consecutive positions a thread, summed in f64 across
  // the warp and then the warps, and kept in f64: a difference cum_i -
  // cum_j is rounded to f32 once, before its exp (values rounded one by
  // one would put an ulp of |cum| -- 3e-5 at |cum| 270 -- into the
  // exponent of every near-diagonal weight); past Q dt is 0, so cum
  // stays cum_{Q-1}
  const int E = (QP + THREADS - 1) / THREADS;
  double run = 0.0;
  for (int e = 0; e < E; ++e) {
    const int i = tid * E + e;
    if (i < QP) run += (double)__fmul_rn(dts[i], A);
  }
  double incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  double base = incl - run;
  for (int w = 0; w < warp; ++w) base += warp_sum[w];
  for (int e = 0; e < E; ++e) {
    const int i = tid * E + e;
    if (i < QP) {
      base += (double)__fmul_rn(dts[i], A);
      cum[i] = base;
    }
  }
  __syncthreads();
  if (part == 0 && tid == 0)
    decay[(long long)chunk * H + h] = expf((float)cum[Q - 1]);

  float acc[MAX_P / 8][4] = {};
  if (rows_part) {
    // output rows i0 .. i0+63, this warp's r0 .. r0+15
    const int r0 = i0 + 16 * warp;
    const bool live = r0 < Q;
    const double cum_r[2] = {cum[r0 + g], cum[r0 + g + 8]};
    const float row_f[2] = {expf((float)(cum_r[0] - cum[i0])),
                            expf((float)(cum_r[1] - cum[i0]))};
    for (int j = tid; j < i0; j += THREADS)
      fac[j] = expf((float)(cum[i0] - cum[j])) * dts[j];
    // C.B^T is read only once launch 1 is done; all before overlaps it
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    stage_cb(0);
    cp_commit();
    for (int kt = 0; kt <= i0 / TILE; ++kt) {
      const int j0 = kt * TILE;
      if (j0 < i0) {
        stage(kt + 1);
        stage_cb(kt + 1);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();                  // stage kt & 1 has landed; fac
      const T* xs = xr + (kt & 1) * TILE * XS;
      const float* gs = gr + (kt & 1) * TILE * TILE + warp * TILE * 16;
      if (live && j0 < i0) {               // a whole tile: no step skipped
#pragma unroll
        for (int kk = 0; kk < TILE / KS; ++kk)
          row_step(acc, gs, xs, kk, lane, [&](float cb, int ro, int ko) {
            return r0 + g + ro < Q ? cb * row_f[ro >> 3] * fac[j0 + ko] : 0.f;
          });
      } else if (live) {                   // the diagonal tile
        const int nks = (key_steps(i0, j0, warp, Q) * 8 + KS - 1) / KS;
#pragma unroll
        for (int kk = 0; kk < TILE / KS; ++kk) {
          if (kk >= nks) break;
          row_step(acc, gs, xs, kk, lane, [&](float cb, int ro, int ko) {
            const int i = r0 + g + ro, j = j0 + ko;
            return j <= i && i < Q
                ? cb * expf((float)(cum_r[ro >> 3] - cum[j])) * dts[j]
                : 0.f;
          });
        }
      }
      __syncthreads();                  // stage kt & 1 is free again
    }
    if (!live) return;                  // the stages are free: stage out
    store_rows(acc, gr + warp * 16 * OS, min(16, Q - r0), P, lane,
               [&](int r) { return y + ((row0 + r0 + r) * H + h) * P; });
  } else {
    // the boundary state: rows n0 .. n0+63, this warp's nr .. nr+15
    const int nr = n0 + 16 * warp;
    const bool live = nr < N;
    const double cum_last = cum[Q - 1];
    for (int j = tid; j < QP; j += THREADS)
      fac[j] = j < Q ? expf((float)(cum_last - cum[j])) * dts[j] : 0.f;
    cp_commit();
    for (int kt = 0; kt < RB; ++kt) {       // keys past Q: zeros, fac 0
      if (kt + 1 < RB) {
        stage(kt + 1);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();                  // stage kt & 1 has landed; fac
      const int st = (kt & 1) * TILE * XS;
      if (live) {
#pragma unroll
        for (int kk = 0; kk < TILE / KS; ++kk)
          state_step(acc, br + st, xr + st, fac + kt * TILE, kk, 16 * warp,
                     lane);
      }
      __syncthreads();                  // stage kt & 1 is free again
    }
    if (!live) return;                  // the stages are free: stage out
    float* st = states + ((long long)chunk * H + h) * N * P;
    store_rows(acc, gr + warp * 16 * OS, min(16, N - nr), P, lane,
               [&](int r) { return st + (long long)(nr + r) * P; });
  }
}

#define SSD_KERNELS(tag, T)                                                 \
  __global__ void __launch_bounds__(THREADS, 4) ssd_cb_##tag(               \
      const T* bm, const T* cm, float* ws, int N, int Q, int vec) {         \
    cb_body<T>(bm, cm, ws, N, Q, vec);                                      \
  }                                                                         \
  __global__ void __launch_bounds__(THREADS, 4) ssd_chunk_##tag(            \
      const T* x, const float* dt, const float* a, const T* bm,             \
      const float* ws, float* y, float* states, float* decay, int H, int P, \
      int N, int Q, int vec) {                                              \
    chunk_body<T>(x, dt, a, bm, ws, y, states, decay, H, P, N, Q, vec);     \
  }
SSD_KERNELS(f32, float)
SSD_KERNELS(bf16, bf16)
#undef SSD_KERNELS

template <typename T>
int launch(void (*cb)(const T*, const T*, float*, int, int, int),
           void (*body)(const T*, const float*, const float*, const T*,
                        const float*, float*, float*, float*, int, int, int,
                        int, int),
           int* allowed, const void* x, const void* dt, const void* a,
           const void* b, const void* c, void* y, void* states, void* decay,
           void* ws, int B, int S, int H, int P, int N, int Q,
           cudaStream_t stream) {
  const int RB = (Q + TILE - 1) / TILE, NB = (N + TILE - 1) / TILE;
  const int chunks = B * (S / Q);
  const int cb_bytes = 2 * TILE * cb_stride<T>(N) * (int)sizeof(T);
  const int body_bytes = (int)chunk_smem<T>(Q);
  cudaError_t err = allow_smem(cb, cb_bytes, allowed);
  if (err == cudaSuccess) err = allow_smem(body, body_bytes, allowed + 64);
  if (err != cudaSuccess) return (int)err;
  // 16-byte copies where every staged row is whole 16-byte chunks
  constexpr int V = 16 / sizeof(T);
  const int vec = P % V == 0 && N % V == 0 &&
                  ((uintptr_t)x | (uintptr_t)b | (uintptr_t)c) % 16 == 0;
  const T* bm = static_cast<const T*>(b);
  float* wsf = static_cast<float*>(ws);
  cb<<<dim3(RB * (RB + 1) / 2, chunks), THREADS, cb_bytes, stream>>>(
      bm, static_cast<const T*>(c), wsf, N, Q, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // programmatic dependent launch: launch 2's prologue (dt, the cumsum,
  // the first x tile) and its state CTAs overlap launch 1
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(RB + NB, H, chunks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = body_bytes;
  cfg.stream = stream;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(
      &cfg, body, static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), bm, static_cast<const float*>(wsf),
      static_cast<float*>(y), static_cast<float*>(states),
      static_cast<float*>(decay), H, P, N, Q, (int)vec);
}

}  // namespace

// ws: ws_floats floats of scratch, at least B (S/Q) QP^2 (QP: Q rounded
// up to 64).  dtype 0: x/b/c float32; 1: bfloat16.
extern "C" int ssd_chunk_fwd(const void* x, const void* dt, const void* a,
                             const void* b, const void* c, void* y,
                             void* states, void* decay, void* ws,
                             long long ws_floats, int B, int S, int H, int P,
                             int N, int Q, int dtype, void* stream) {
  if (B < 1 || H < 1 || Q < 1 || Q > MAX_Q || S < Q || S % Q != 0 ||
      P < 1 || P > MAX_P || N < 1 || N > MAX_N || H > 65535 ||
      (long long)B * (S / Q) > 65535)
    return (int)cudaErrorInvalidValue;
  const long long qp = (Q + TILE - 1) / TILE * TILE;
  if (ws_floats < (long long)B * (S / Q) * qp * qp)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    static int allowed[128] = {};
    return launch<float>(ssd_cb_f32, ssd_chunk_f32, allowed, x, dt, a, b, c,
                         y, states, decay, ws, B, S, H, P, N, Q, s);
  }
  if (dtype == 1) {
    static int allowed[128] = {};
    return launch<bf16>(ssd_cb_bf16, ssd_chunk_bf16, allowed, x, dt, a, b, c,
                        y, states, decay, ws, B, S, H, P, N, Q, s);
  }
  return (int)cudaErrorInvalidValue;
}
