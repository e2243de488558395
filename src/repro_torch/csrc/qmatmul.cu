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
// What bounds it on the H100: at the qwen2.5-1.5b MLP shapes (K x N =
// 1536 x 8960 or 8960 x 1536) the planes are 3.4 to 15 MB.  At M = 8
// the bytes bind; at M = 128 the product (3.5 GFLOP, three times that
// with f32 x in three bf16 parts) is near the knee, and x is read from
// the L2 once per column tile.  Both variants run on the tensor cores:
//   * dequant_dot on the bf16 pipe (HMMA, mma.sync m16n8k16, f32
//     accumulators).  The weights go in as exact integers: int8 values
//     (q8_0, q6_k) or the 4- and 2-bit codes (q4_k, q2_k) are unpacked
//     once per CTA into a bf16 tile in shared memory (an integer below
//     2^8 is exact in bf16; the unpack is a byte permute into a float
//     2^23 + u, one subtract, and the top halves of two floats as a bf16
//     pair) and reach the products through ldmatrix.trans.  Each
//     sub-block (32 k for q8_0 and q4_k, 16 for q6_k and q2_k) sums into
//     a fresh accumulator fragment, and its epilogue applies the
//     effective scale per (sub-block, column) in f32, with the
//     reference's algebra: eff = sub * super, an eff of 0 read as 1 (for
//     q8_0 eff is the block's scale).  The mins of q4_k and q2_k leave
//     as eff_m * (the sum of x over the sub-block), a rank-1 term per
//     sub-block.  So the product is sum_sub eff_d (x . q) - eff_m sum x
//     where the reference rounds each q eff_d - eff_m: equal up to f32
//     rounding (rel 1e-5 held on the card).  f32 x does not fit one bf16
//     pass: a first launch splits it once into three bf16 parts (the
//     leading 8 bits, the next 8, the rest: their sum is x to f32's
//     rounding) and sums it per sub-block; the products take the three
//     parts into one accumulator (into one each, added before the
//     epilogue, in the 16-row tiles, whose mma chains are short).  bf16
//     x goes in as it is.
//   * dot_i8 on the int8 pipe (IMMA, mma.sync m16n8k32 s8.s8.s32), not
//     __dp4a: on the H100 the tensor cores' int8 rate (1,979 TOPS) is
//     several times the CUDA cores' dp4a rate, and k32 is exactly one
//     q8_0 block, so each mma gives a block's exact int32 dot.  A first
//     launch quantizes x once (per row and 32-block: amax / 127 and x /
//     scale by IEEE division, rintf, clamped to +-127, the plain
//     version's bits).  Both mma operands are K-major and the q8_0 plane
//     is N-contiguous: each lane reads four 32-bit words (four columns)
//     of four consecutive k rows and transposes the 4 x 4 bytes with
//     eight byte permutes, so it holds the k-quads of four columns -- the
//     B fragments of four mmas whose columns interleave (column 4g + c of
//     mma c).  The tile is stored with its 16-byte chunks swizzled by
//     row so those reads meet no bank twice.  The epilogue multiplies
//     the int32 part (converted exactly: |part| < 2^22) by x's scale,
//     then by w's, then adds, each rounded, as the reference orders it.
// Shared by both:
//   * one CTA of 8 warps holds all M rows up to 128 (16-row tiles for
//     M <= 16, 256 columns wide; 128 x 128 beyond), so each weight byte
//     is read once; beyond 128 rows, each 128-row band is tiles of its
//     own;
//   * the (tile, K step) iterations of all tiles are cut into equal
//     runs, one CTA each, one per SM (stream-K, as K9's weight stream
//     does), so every SM streams the same bytes whatever the number of
//     tiles; a run that holds only a piece of a tile stores it to an f32
//     workspace, and a third launch (qmatmul_fold, many CTAs a tile)
//     adds the pieces in run order -- no float atomics, the same bits on
//     every launch.  Tiles and pieces leave as 16-byte stores;
//   * a ring of 4 stages filled by 16-byte cp.async (zero past every
//     edge); dequant_dot unpacks stage i + 1 while it multiplies stage i
//     (one barrier a stage);
//   * the three launches (x first: split, summed or quantized; the
//     products; the fold) are programmatic dependent launches: the
//     products' CTAs start their weight copies before they wait for x;
//   * rows that are not whole 16-byte chunks (N not a multiple of 16, or
//     a plane not 16-byte aligned) go to the _plain kernels, which stage
//     by byte copies: each kernel carries one of the two copy paths, so
//     its loop stays small (with both, a kernel's code was mostly
//     address arithmetic, and slower).
//
// C interface (loaded with ctypes): qmatmul_fwd returns the cudaError_t
// of the launches; it allocates nothing (x's parts, sums or int8 copy
// and the split-K workspace come from the caller) and launches on the
// stream it is given.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "smem_limit.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;      // 8 warps, every launch
constexpr int kStages = 4;         // cp.async ring depth

// format codes: 0 q8_0, 1 q6_k, 2 q4_k, 3 q2_k.  kSub: the k of one
// scale (for q8_0 the block itself); int8 values where kBits == 8.
template <int F> struct Fmt;
template <> struct Fmt<0> {
  static constexpr int kBlock = 32, kSub = 32, kBits = 8, kPer = 1;
  static constexpr bool kHasSub = false, kAsym = false;
};
template <> struct Fmt<1> {
  static constexpr int kBlock = 256, kSub = 16, kBits = 8, kPer = 1;
  static constexpr bool kHasSub = true, kAsym = false;
};
template <> struct Fmt<2> {
  static constexpr int kBlock = 256, kSub = 32, kBits = 4, kPer = 2;
  static constexpr bool kHasSub = true, kAsym = true;
};
template <> struct Fmt<3> {
  static constexpr int kBlock = 256, kSub = 16, kBits = 2, kPer = 4;
  static constexpr bool kHasSub = true, kAsym = true;
};

// A CTA's tile: its 8 warps as WM x WN, each MT 16-row by NT 8-column
// mma tiles; BK k a stage.  (16 warps of half the tile each ran slower
// on the H100.)
template <int WM_, int MT_, int NT_, int BK_>
struct Tile {
  static constexpr int WM = WM_, MT = MT_, NT = NT_, BK = BK_;
  static constexpr int WN = kThreads / 32 / WM;
  static constexpr int BM = 16 * MT * WM, BN = 8 * NT * WN;
};
using DqSmall = Tile<1, 1, 4, 64>;    // M <= 16: 16 x 256
using DqLarge = Tile<4, 2, 8, 32>;    // 128 x 128
using I8Small = Tile<1, 1, 4, 64>;    // 16 x 256
using I8Large = Tile<4, 2, 8, 64>;    // 128 x 128

__device__ __forceinline__ float one_if_zero(float v) {
  return v == 0.0f ? 1.0f : v;
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// ---------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------

// 16-byte copy global -> shared, zero-filled where `in` is false
// (nothing is read then)
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
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// ldmatrix: lanes 8q .. 8q+7 give the rows of 8 x 16-byte matrix q;
// without .trans a lane gets the two 16-bit elements of row lane / 4 at
// columns 2 (lane % 4) and the next, with .trans those of column lane / 4
// at rows 2 (lane % 4) and the next
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Fragments (PTX ISA; g = lane / 4, t = lane % 4).  m16n8k16 bf16: A
// pairs at (g, 2t), (g+8, 2t), (g, 2t+8), (g+8, 2t+8); B pairs at (k 2t,
// n g), (k 2t+8, n g).  m16n8k32 s8: A quads at (g, 4t), (g+8, 4t), (g,
// 4t+16), (g+8, 4t+16); B quads at (k 4t, n g), (k 4t+16, n g).  Both:
// D (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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
// the pair (v0, v1) as three bf16 parts, exact to f32's rounding: p0
// carries the leading 8 bits, p1 the next 8 of what is left, p2 the rest
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

// bytes i and i + 1 of `bytes`, each an integer u below 2^8, as the bf16
// pair (u - bias + 2^23): the byte permute builds the float 2^23 + u,
// the subtract is exact, and a float with at most 8 significant bits is
// its top half as a bf16
__device__ __forceinline__ uint32_t bf16_pair(uint32_t bytes, int i,
                                              float bias) {
  const float f0 =
      __uint_as_float(__byte_perm(bytes, 0x4B000000u, 0x7540 + i)) - bias;
  const float f1 =
      __uint_as_float(__byte_perm(bytes, 0x4B000000u, 0x7541 + i)) - bias;
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
}

// an int32 below 2^22 in magnitude as f32, exactly, on the FP32 pipe
__device__ __forceinline__ float i2f_exact(int v) {
  return __uint_as_float((uint32_t)(v + 0x4B400000)) - 12582912.0f;
}

// ---------------------------------------------------------------------
// staging, stream-K, pieces
// ---------------------------------------------------------------------

// The 16-byte chunk c of row r of a dot_i8 weight stage sits at chunk
// c ^ (2 ((r / 4) % 4)): four rows 4 apart hold a lane group's words in
// eight distinct chunks.
__device__ __forceinline__ int swizzle(int r, int c) {
  return c ^ (((r >> 2) & 3) << 1);
}

// ROWS x BYTES of a row-major byte matrix (row r at src + r ld) into dst
// (row stride dld), zero at rows >= vrows and bytes >= vbytes; SW: the
// dot_i8 weight swizzle.  V: by 16-byte cp.async (every row whole
// 16-byte chunks on 16-byte-aligned bases), else byte by byte (the
// _plain kernels: a kernel carries one of the two, so its loop stays
// small).
template <int ROWS, int BYTES, bool SW, bool V>
__device__ __forceinline__ void copy_block(unsigned char* dst, int dld,
                                           const unsigned char* src,
                                           int64_t ld, int vrows,
                                           int vbytes) {
  constexpr int CH = BYTES / 16, TOTAL = ROWS * CH;
  static_assert((CH & (CH - 1)) == 0, "chunks a row: a power of 2");
  if constexpr (V) {
#pragma unroll
    for (int j = 0; j < (TOTAL + kThreads - 1) / kThreads; ++j) {
      const int e = threadIdx.x + j * kThreads;
      if (TOTAL % kThreads == 0 || e < TOTAL) {
        const int r = e / CH, c = e % CH;
        const bool in = r < vrows && c * 16 < vbytes;
        const int pc = SW ? swizzle(r, c) : c;
        cp16(dst + r * dld + pc * 16, in ? src + r * ld + c * 16 : src, in);
      }
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * BYTES; e += kThreads) {
      const int r = e / BYTES, b = e - r * BYTES;
      const int pc = SW ? swizzle(r, b >> 4) : b >> 4;
      dst[r * dld + pc * 16 + (b & 15)] =
          r < vrows && b < vbytes ? src[r * ld + b] : (unsigned char)0;
    }
  }
}

// The run c (of `runs`) takes the iterations it = c * I / runs ..
// (c + 1) * I / runs - 1 of the I = tiles * nkb, tile-major (tile =
// m tile * n_tiles + n tile; K step it % nkb).
__device__ __forceinline__ int64_t slice_start(int64_t c, int64_t iters,
                                               int64_t runs) {
  return c * iters / runs;
}
// the run that holds iteration it
__device__ __forceinline__ int64_t slice_of(int64_t it, int64_t iters,
                                            int64_t runs) {
  return ((it + 1) * runs + iters - 1) / iters - 1;
}


// Four floats of row r at columns c .. c+3 of p (row stride ld): one
// 16-byte store where they all lie in [cols) and ld is a multiple of 4,
// else those in [cols) one by one.
__device__ __forceinline__ void store4(float* p, int64_t ld, int r, int c,
                                       int rows, int cols, float4 v) {
  if (r >= rows) return;
  float* o = p + r * ld + c;
  if ((ld & 3) == 0 && c + 4 <= cols) {
    *reinterpret_cast<float4*>(o) = v;
  } else {
    if (c < cols) o[0] = v.x;
    if (c + 1 < cols) o[1] = v.y;
    if (c + 2 < cols) o[2] = v.z;
    if (c + 3 < cols) o[3] = v.w;
  }
}

// A warp's accumulators as MT * NT quads: four consecutive columns c of
// row r each.  kI8Cols: dot_i8's column order (mma c of a 32-column
// group holds its columns 4g + c, so a lane holds columns 8t .. 8t+7 of
// rows g and g+8); else the fragments' own, where lanes t and t ^ 1
// swap halves so the even one holds row g and the odd one row g + 8.
template <class C, bool kI8Cols>
__device__ __forceinline__ void quads(const float (&acc)[C::MT][C::NT][4],
                                      float4 (&v)[C::MT * C::NT],
                                      int (&r)[C::MT * C::NT],
                                      int (&c)[C::MT * C::NT], int wm,
                                      int wn) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if constexpr (kI8Cols) {
#pragma unroll
    for (int i = 0; i < C::MT; ++i)
#pragma unroll
      for (int gq = 0; gq < C::NT / 4; ++gq)
#pragma unroll
        for (int q = 0; q < 4; ++q) {          // (row g or g + 8, half)
          const int p = (i * (C::NT / 4) + gq) * 4 + q, e = q;
          r[p] = wm + 16 * i + g + 8 * (q >> 1);
          c[p] = wn + 32 * gq + 8 * t + 4 * (q & 1);
          v[p] = make_float4(acc[i][4 * gq][e], acc[i][4 * gq + 1][e],
                             acc[i][4 * gq + 2][e], acc[i][4 * gq + 3][e]);
        }
  } else {
    const bool odd = t & 1;
#pragma unroll
    for (int i = 0; i < C::MT; ++i)
#pragma unroll
      for (int j = 0; j < C::NT; ++j) {
        const int p = i * C::NT + j;
        const float(&a)[4] = acc[i][j];
        const float r0 = __shfl_xor_sync(0xffffffffu, odd ? a[0] : a[2], 1);
        const float r1 = __shfl_xor_sync(0xffffffffu, odd ? a[1] : a[3], 1);
        v[p] = odd ? make_float4(r0, r1, a[2], a[3])
                   : make_float4(a[0], a[1], r0, r1);
        r[p] = wm + 16 * i + g + (odd ? 8 : 0);
        c[p] = wn + 8 * j + 2 * (t & ~1);
      }
  }
}

// The piece of `tile` that ends at iteration it (of the run's it0 ..),
// acc, then acc zeroed: to out if the run holds the whole tile, else to
// the run's slot run + tile of ws (distinct for each (run, tile) a run
// touches, since runs take the steps in order), which the fold launch
// adds up.
template <class C, bool kI8Cols>
__device__ __forceinline__ void end_piece(float (&acc)[C::MT][C::NT][4],
                                          float* out, float* ws,
                                          int64_t it0, int64_t it,
                                          int64_t run, int nkb, int tile,
                                          int m0, int n0, int M, int N,
                                          int wm, int wn) {
  constexpr int NQ = C::MT * C::NT;
  const bool whole = it0 <= (int64_t)tile * nkb && (it + 1) % nkb == 0;
  const int rows = min(M - m0, C::BM), cols = min(N - n0, C::BN);
  float4 v[NQ];
  int r[NQ], c[NQ];
  quads<C, kI8Cols>(acc, v, r, c, wm, wn);
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  float* p = whole ? out + (int64_t)m0 * N + n0
                   : ws + (run + tile) * (M < C::BM ? M : C::BM) * C::BN;
  const int64_t ld = whole ? N : C::BN;
#pragma unroll
  for (int q = 0; q < NQ; ++q) store4(p, ld, r[q], c[q], rows, cols, v[q]);
}

// The fold launch: out at the tiles no run holds whole, the pieces of
// the runs that hold a part of the tile added in run order (the same bits
// on every launch; no float atomics).  One CTA per (tile, FOLD_ROWS
// rows), a float4 a thread, FOLD_Q pieces' loads in flight at once.
constexpr int FOLD_Q = 8;

__global__ void __launch_bounds__(kThreads)
qmatmul_fold(const float* __restrict__ ws, float* __restrict__ out, int M,
             int N, int BM, int BN, int nkb, int n_tiles, long long iters,
             int runs) {
  griddep_wait();                            // every piece stored
  const int tile = blockIdx.x;
  const int64_t first = slice_of((int64_t)tile * nkb, iters, runs);
  const int64_t last = slice_of((int64_t)tile * nkb + nkb - 1, iters, runs);
  if (first == last) return;                 // written whole by its run
  const int m0 = (tile / n_tiles) * BM, n0 = (tile % n_tiles) * BN;
  const int rows = min(M - m0, BM), cols = min(N - n0, BN);
  const int c4 = BN / 4;
  const int r = blockIdx.y * (kThreads / c4) + threadIdx.x / c4;
  const int c = (threadIdx.x % c4) * 4;
  if (r >= rows || c >= cols) return;
  const int64_t slot = (int64_t)(M < BM ? M : BM) * BN;
  const float* p = ws + (first + tile) * slot + r * BN + c;
  float4 s = __ldcg(reinterpret_cast<const float4*>(p));
  for (int64_t q0 = 1; q0 <= last - first; q0 += FOLD_Q) {
    float4 v[FOLD_Q];
#pragma unroll
    for (int u = 0; u < FOLD_Q; ++u)
      if (q0 + u <= last - first)
        v[u] = __ldcg(reinterpret_cast<const float4*>(p + (q0 + u) * slot));
#pragma unroll
    for (int u = 0; u < FOLD_Q; ++u)
      if (q0 + u <= last - first) {
        s.x += v[u].x;
        s.y += v[u].y;
        s.z += v[u].z;
        s.w += v[u].w;
      }
  }
  store4(out + (int64_t)m0 * N + n0, N, r, c, rows, cols, s);
}

// ---------------------------------------------------------------------
// x first: split into bf16 parts and summed per sub-block, or quantized
// ---------------------------------------------------------------------

// One thread per 8 consecutive k of a row r < Mp (rows M .. Mp - 1 are
// zeros): the thread's (r, k8), false past the last.  The products'
// launch may start once every CTA of this one has.
__device__ __forceinline__ bool prep_slot(int K, int Mp, int& r, int& k8) {
  griddep_launch();
  const int K8 = K / 8;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = idx < (int64_t)Mp * K8;
  r = live ? (int)(idx / K8) : 0;
  k8 = live ? (int)(idx % K8) : 0;
  return live;
}

// f32 x: the three bf16 parts to xp ([3][M][K]); sub > 0: the
// sum of x over each sub-block to xsum ([K/sub][Mp]).
template <typename T>
__device__ __forceinline__ void prep_dequant_body(const T* __restrict__ x,
                                                  bf16* __restrict__ xp,
                                                  float* __restrict__ xsum,
                                                  int M, int K, int Mp,
                                                  int sub) {
  int r, k8;
  const bool live = prep_slot(K, Mp, r, k8), row = live && r < M;
  float v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    v[e] = row ? to_f32(x[(int64_t)r * K + 8 * k8 + e]) : 0.0f;
  if constexpr (sizeof(T) == 4) {
    if (row) {
      uint32_t p0[4], p1[4], p2[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split3(v[2 * e], v[2 * e + 1], p0[e], p1[e], p2[e]);
      uint4* dst = reinterpret_cast<uint4*>(xp + (int64_t)r * K + 8 * k8);
      const int64_t part = (int64_t)M * K / 8;         // in uint4
      dst[0] = make_uint4(p0[0], p0[1], p0[2], p0[3]);
      dst[part] = make_uint4(p1[0], p1[1], p1[2], p1[3]);
      dst[2 * part] = make_uint4(p2[0], p2[1], p2[2], p2[3]);
    }
  }
  if (sub > 0) {
    // a sub-block is 2 (sub 16) or 4 (sub 32) neighbouring lanes
    float s = ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5]) + (v[6] + v[7]));
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if (sub == 32) s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (live && k8 % (sub / 8) == 0)
      xsum[(int64_t)(8 * k8 / sub) * Mp + r] = s;
  }
}

// dot_i8's x: per (row, 32-block) the scale amax / 127 (1 where 0) to
// xs ([K/32][Mp]) and x / scale rounded half to even, clamped to +-127,
// to xq ([M][K]); a block is 4 neighbouring lanes.
template <typename T>
__device__ __forceinline__ void prep_quant_body(const T* __restrict__ x,
                                                int8_t* __restrict__ xq,
                                                float* __restrict__ xs,
                                                int M, int K, int Mp) {
  int r, k8;
  const bool live = prep_slot(K, Mp, r, k8), row = live && r < M;
  float v[8];
  float amax = 0.0f;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    v[e] = row ? to_f32(x[(int64_t)r * K + 8 * k8 + e]) : 0.0f;
    amax = fmaxf(amax, fabsf(v[e]));
  }
  amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
  amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 2));
  const float scale = one_if_zero(__fdiv_rn(amax, 127.0f));
  uint32_t q[2] = {0u, 0u};
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float f = fminf(fmaxf(rintf(__fdiv_rn(v[e], scale)), -127.0f),
                          127.0f);
    q[e >> 2] |= ((uint32_t)(int)f & 0xffu) << (8 * (e & 3));
  }
  if (row)
    *reinterpret_cast<uint2*>(xq + (int64_t)r * K + 8 * k8) =
        make_uint2(q[0], q[1]);
  if (live && (k8 & 3) == 0) xs[(int64_t)(k8 / 4) * Mp + r] = scale;
}

__global__ void __launch_bounds__(kThreads)
qmatmul_prep_split_f32(const float* x, bf16* xp, float* xsum, int M, int K,
                       int Mp, int sub) {
  prep_dequant_body<float>(x, xp, xsum, M, K, Mp, sub);
}
__global__ void __launch_bounds__(kThreads)
qmatmul_prep_sum_bf16(const bf16* x, bf16* xp, float* xsum, int M, int K,
                      int Mp, int sub) {
  prep_dequant_body<bf16>(x, xp, xsum, M, K, Mp, sub);
}
__global__ void __launch_bounds__(kThreads)
qmatmul_prep_quant_f32(const float* x, int8_t* xq, float* xs, int M, int K,
                       int Mp) {
  prep_quant_body<float>(x, xq, xs, M, K, Mp);
}
__global__ void __launch_bounds__(kThreads)
qmatmul_prep_quant_bf16(const bf16* x, int8_t* xq, float* xs, int M, int K,
                        int Mp) {
  prep_quant_body<bf16>(x, xq, xs, M, K, Mp);
}

// ---------------------------------------------------------------------
// dequant_dot
// ---------------------------------------------------------------------

// A stage in the ring: x (P bf16 parts of BM rows, row stride XS), x's
// sums per sub-block ([NSUB][BM], q4_k/q2_k), then the planes' rows of
// the stage as they lie (values, sub scales, sub mins, super scales,
// super mins).  After the ring: the bf16 weight tile (BK rows of WS) and
// the effective scales ([NSUB][BN], then the mins' for q4_k/q2_k), two
// of each.  Row strides of 16 bytes times an odd number, so ldmatrix's
// eight rows meet no bank twice.
template <int F, typename T, class C>
struct Dq {
  using Fm = Fmt<F>;
  static constexpr int P = sizeof(T) == 4 ? 3 : 1;
  static constexpr int NSUB = C::BK / Fm::kSub;
  static constexpr int SUPR = C::BK > Fm::kBlock ? C::BK / Fm::kBlock : 1;
  static constexpr int XS = C::BK + 8, WS = C::BN + 8;
  static constexpr int X_OFF = 0;
  static constexpr int XSUM_OFF = X_OFF + P * C::BM * XS * 2;
  static constexpr int V_OFF = XSUM_OFF + (Fm::kAsym ? NSUB * C::BM * 4 : 0);
  static constexpr int SUBS_OFF = V_OFF + C::BK / Fm::kPer * C::BN;
  static constexpr int SUBM_OFF = SUBS_OFF + (Fm::kHasSub ? NSUB * C::BN : 0);
  static constexpr int SUPS_OFF = SUBM_OFF + (Fm::kAsym ? NSUB * C::BN : 0);
  static constexpr int SUPM_OFF = SUPS_OFF + SUPR * C::BN * 4;
  static constexpr int STAGE = SUPM_OFF + (Fm::kAsym ? SUPR * C::BN * 4 : 0);
  static constexpr int W_ELEMS = C::BK * WS;
  static constexpr int NE = NSUB * C::BN;           // scales a buffer
  static constexpr int EFF = Fm::kAsym ? 2 * NE : NE;
  static constexpr int SMEM = kStages * STAGE + 2 * W_ELEMS * 2 + 2 * EFF * 4;
  static_assert(STAGE % 16 == 0 && XSUM_OFF % 16 == 0 && V_OFF % 16 == 0 &&
                    SUBS_OFF % 16 == 0 && SUBM_OFF % 16 == 0 &&
                    SUPS_OFF % 16 == 0 && SUPM_OFF % 16 == 0,
                "16-byte stage regions");
  static_assert(SMEM <= 232448, "one CTA per SM");
};

// Stage st's planes -> the bf16 weight tile W ([BK][WS], exact
// integers) and the effective scales eff ([NSUB][BN]: eff_d, then for
// q4_k/q2_k eff_m).  A unit is one byte row of 8 columns: its kPer
// rows of k leave as 16-byte stores.
template <int F, typename T, class C>
__device__ __forceinline__ void unpack(const unsigned char* st, bf16* W,
                                       float* eff) {
  using L = Dq<F, T, C>;
  using Fm = Fmt<F>;
  constexpr int U8 = C::BN / 8;
  constexpr int UNITS = C::BK / Fm::kPer * U8;
  const unsigned char* vals = st + L::V_OFF;
#pragma unroll
  for (int u0 = 0; u0 < (UNITS + kThreads - 1) / kThreads; ++u0) {
    const int u = threadIdx.x + u0 * kThreads;
    if (UNITS % kThreads && u >= UNITS) break;
    const int kb = u / U8, c8 = u % U8;
    const uint2 w = *reinterpret_cast<const uint2*>(vals + kb * C::BN + c8 * 8);
#pragma unroll
    for (int j = 0; j < Fm::kPer; ++j) {
      uint32_t lo, hi;
      float bias;
      if constexpr (Fm::kBits == 8) {          // int8: u = v + 128
        lo = w.x ^ 0x80808080u;
        hi = w.y ^ 0x80808080u;
        bias = 8388736.0f;                     // 2^23 + 128
      } else {                                 // the codes of row j
        constexpr uint32_t mask = Fm::kBits == 4 ? 0x0F0F0F0Fu : 0x03030303u;
        lo = (w.x >> (Fm::kBits * j)) & mask;
        hi = (w.y >> (Fm::kBits * j)) & mask;
        bias = 8388608.0f;                     // 2^23
      }
      const uint4 o = make_uint4(bf16_pair(lo, 0, bias), bf16_pair(lo, 2, bias),
                                 bf16_pair(hi, 0, bias), bf16_pair(hi, 2, bias));
      *reinterpret_cast<uint4*>(W + (kb * Fm::kPer + j) * L::WS + c8 * 8) = o;
    }
  }
  const float* sups = reinterpret_cast<const float*>(st + L::SUPS_OFF);
#pragma unroll
  for (int e0 = 0; e0 < (L::NE + kThreads - 1) / kThreads; ++e0) {
    const int e = threadIdx.x + e0 * kThreads;
    if (L::NE % kThreads && e >= L::NE) break;
    if constexpr (F == 0) {
      eff[e] = sups[e];                        // the block's scale
    } else {
      const int c = e % C::BN;                 // one super row a stage
      const int8_t* subs = reinterpret_cast<const int8_t*>(st + L::SUBS_OFF);
      eff[e] = one_if_zero(__fmul_rn((float)subs[e], sups[c]));
      if constexpr (Fm::kAsym) {
        const int8_t* subm = reinterpret_cast<const int8_t*>(st + L::SUBM_OFF);
        const float* supm = reinterpret_cast<const float*>(st + L::SUPM_OFF);
        eff[L::NE + e] = __fmul_rn((float)subm[e], supm[c]);
      }
    }
  }
}

// Sub-block sb's epilogue: acc += eff_d d per column, and for q4_k/q2_k
// acc -= eff_m * (x summed over the sub-block) per row and column.
template <int F, class C>
__device__ __forceinline__ void dq_epilogue(float (&acc)[C::MT][C::NT][4],
                                            const float (&d)[C::MT][C::NT][4],
                                            const float* effd,
                                            const float* effm,
                                            const float* xsum, int wm,
                                            int wn) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < C::NT; ++j) {
    const float2 e = *reinterpret_cast<const float2*>(effd + wn + 8 * j + 2 * t);
#pragma unroll
    for (int i = 0; i < C::MT; ++i) {
      acc[i][j][0] = fmaf(e.x, d[i][j][0], acc[i][j][0]);
      acc[i][j][1] = fmaf(e.y, d[i][j][1], acc[i][j][1]);
      acc[i][j][2] = fmaf(e.x, d[i][j][2], acc[i][j][2]);
      acc[i][j][3] = fmaf(e.y, d[i][j][3], acc[i][j][3]);
    }
    if constexpr (Fmt<F>::kAsym) {
      const float2 m =
          *reinterpret_cast<const float2*>(effm + wn + 8 * j + 2 * t);
#pragma unroll
      for (int i = 0; i < C::MT; ++i) {
        const float x0 = xsum[wm + 16 * i + g], x1 = xsum[wm + 16 * i + g + 8];
        acc[i][j][0] = fmaf(-m.x, x0, acc[i][j][0]);
        acc[i][j][1] = fmaf(-m.y, x0, acc[i][j][1]);
        acc[i][j][2] = fmaf(-m.x, x1, acc[i][j][2]);
        acc[i][j][3] = fmaf(-m.y, x1, acc[i][j][3]);
      }
    }
  }
}

// The warp's products of one stage: per sub-block a fresh fragment of
// sums over its k (B through ldmatrix.trans from the integer tile, A
// through ldmatrix from each bf16 part of x), then its epilogue.
template <int F, typename T, class C>
__device__ __forceinline__ void dq_products(float (&acc)[C::MT][C::NT][4],
                                            const unsigned char* st,
                                            const bf16* W, const float* eff,
                                            int wm, int wn) {
  using L = Dq<F, T, C>;
  using Fm = Fmt<F>;
  const int lane = threadIdx.x & 31, q = lane >> 3, rr = lane & 7;
  const bf16* X = reinterpret_cast<const bf16*>(st + L::X_OFF);
  const float* xsum = reinterpret_cast<const float*>(st + L::XSUM_OFF);
  // a warp with few mma tiles (M <= 16) sums each part of x in its own
  // fragment, so the dependent mma chains are short
  constexpr int PA = C::MT * C::NT <= 4 ? L::P : 1;
#pragma unroll
  for (int sb = 0; sb < L::NSUB; ++sb) {
    float d[C::MT][C::NT][4], dp[PA][C::MT][C::NT][4];
#pragma unroll
    for (int pa = 0; pa < PA; ++pa)
#pragma unroll
      for (int i = 0; i < C::MT; ++i)
#pragma unroll
        for (int j = 0; j < C::NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[pa][i][j][e] = 0.0f;
#pragma unroll
    for (int h = 0; h < Fm::kSub / 16; ++h) {
      const int kk = sb * Fm::kSub + 16 * h;
      uint32_t b[C::NT][2];
#pragma unroll
      for (int jj = 0; jj < C::NT / 2; ++jj) {
        uint32_t r[4];
        ldsm_x4_trans(r, W + (kk + rr + 8 * (q & 1)) * L::WS + wn + 16 * jj +
                             8 * (q >> 1));
        b[2 * jj][0] = r[0];
        b[2 * jj][1] = r[1];
        b[2 * jj + 1][0] = r[2];
        b[2 * jj + 1][1] = r[3];
      }
#pragma unroll
      for (int p = 0; p < L::P; ++p) {
        uint32_t a[C::MT][4];
#pragma unroll
        for (int i = 0; i < C::MT; ++i)
          ldsm_x4(a[i], X + (p * C::BM + wm + 16 * i + rr + 8 * (q & 1)) * L::XS +
                            kk + 8 * (q >> 1));
#pragma unroll
        for (int i = 0; i < C::MT; ++i)
#pragma unroll
          for (int j = 0; j < C::NT; ++j)
            mma_bf16(dp[p % PA][i][j], a[i], b[j][0], b[j][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < C::MT; ++i)
#pragma unroll
      for (int j = 0; j < C::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          d[i][j][e] = dp[0][i][j][e];
#pragma unroll
          for (int pa = 1; pa < PA; ++pa) d[i][j][e] += dp[pa][i][j][e];
        }
    dq_epilogue<F, C>(acc, d, eff + sb * C::BN, eff + L::NE + sb * C::BN,
                      xsum + sb * C::BM, wm, wn);
  }
}

// One run of the stream (see the note at the top).  xsrc: x's bf16
// parts ([P][M][K]); xsum: x's sums per sub-block ([K/sub][Mp]).
template <int F, typename T, class C, bool V>
__device__ __forceinline__ void dequant_body(
    const unsigned char* __restrict__ xsrc,
    const unsigned char* __restrict__ vals,
    const unsigned char* __restrict__ subs,
    const unsigned char* __restrict__ subm,
    const unsigned char* __restrict__ sups,
    const unsigned char* __restrict__ supm, const float* __restrict__ xsum,
    float* __restrict__ out, float* __restrict__ ws,
    int M, int K, int N, int Mp, int nkb,
    int n_tiles, int64_t iters) {
  using L = Dq<F, T, C>;
  using Fm = Fmt<F>;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  bf16* Wt = reinterpret_cast<bf16*>(smem + kStages * L::STAGE);
  float* eff = reinterpret_cast<float*>(Wt + 2 * L::W_ELEMS);

  const int64_t run = blockIdx.x;
  const int64_t it0 = slice_start(run, iters, gridDim.x);
  const int n = (int)(slice_start(run + 1, iters, gridDim.x) - it0);
  const int warp = threadIdx.x >> 5;
  const int wm = (warp / C::WN) * 16 * C::MT, wn = (warp % C::WN) * 8 * C::NT;
  const int64_t N4 = (int64_t)N * 4;

  // iteration i of the run: its tile, the tile's origin, its first k
  const int tile0 = (int)(it0 / nkb), step0 = (int)(it0 % nkb);
  auto at = [&](int i, int& tile, int& m0, int& n0, int& k0) {
    const int ks = step0 + i;
    tile = tile0 + ks / nkb;
    k0 = (ks % nkb) * C::BK;
    m0 = (tile / n_tiles) * C::BM;
    n0 = (tile % n_tiles) * C::BN;
  };
  auto load_w = [&](int i) {
    if (i >= n) return;
    int tile, m0, n0, k0;
    at(i, tile, m0, n0, k0);
    unsigned char* st = ring + (i % kStages) * L::STAGE;
    copy_block<C::BK / Fm::kPer, C::BN, false, V>(
        st + L::V_OFF, C::BN, vals + (int64_t)(k0 / Fm::kPer) * N + n0, N,
        (K - k0) / Fm::kPer, N - n0);
    if constexpr (Fm::kHasSub)
      copy_block<L::NSUB, C::BN, false, V>(
          st + L::SUBS_OFF, C::BN, subs + (int64_t)(k0 / Fm::kSub) * N + n0,
          N, (K - k0) / Fm::kSub, N - n0);
    if constexpr (Fm::kAsym)
      copy_block<L::NSUB, C::BN, false, V>(
          st + L::SUBM_OFF, C::BN, subm + (int64_t)(k0 / Fm::kSub) * N + n0,
          N, (K - k0) / Fm::kSub, N - n0);
    const int sup_rows = (K - k0 + Fm::kBlock - 1) / Fm::kBlock;
    copy_block<L::SUPR, C::BN * 4, false, V>(
        st + L::SUPS_OFF, C::BN * 4, sups + (k0 / Fm::kBlock) * N4 + n0 * 4,
        N4, sup_rows, (N - n0) * 4);
    if constexpr (Fm::kAsym)
      copy_block<L::SUPR, C::BN * 4, false, V>(
          st + L::SUPM_OFF, C::BN * 4, supm + (k0 / Fm::kBlock) * N4 + n0 * 4,
          N4, sup_rows, (N - n0) * 4);
  };
  auto load_x = [&](int i) {
    if (i >= n) return;
    int tile, m0, n0, k0;
    at(i, tile, m0, n0, k0);
    unsigned char* st = ring + (i % kStages) * L::STAGE;
#pragma unroll
    for (int p = 0; p < L::P; ++p)
      copy_block<C::BM, C::BK * 2, false, V>(
          st + L::X_OFF + p * C::BM * L::XS * 2, L::XS * 2,
          xsrc + ((int64_t)p * M * K + (int64_t)m0 * K + k0) * 2,
          (int64_t)K * 2, M - m0, (K - k0) * 2);
    if constexpr (Fm::kAsym)
      copy_block<L::NSUB, C::BM * 4, false, true>(
          st + L::XSUM_OFF, C::BM * 4,
          reinterpret_cast<const unsigned char*>(
              xsum + (int64_t)(k0 / Fm::kSub) * Mp + m0),
          (int64_t)Mp * 4, (K - k0) / Fm::kSub, (Mp - m0) * 4);
  };

  // the weights' first stages go out before x is ready (the first
  // launch may still be writing it)
#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) load_w(s);
  griddep_wait();
#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) {
    load_x(s);
    cp_commit();
  }
  cp_wait<kStages - 2>();
  __syncthreads();
  if (n > 0) unpack<F, T, C>(ring, Wt, eff);

  float acc[C::MT][C::NT][4];
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  for (int i = 0; i < n; ++i) {
    // stage i + 1 has landed; every warp is done with the products of
    // stage i - 1 and the unpack of stage i
    cp_wait<kStages - 3>();
    __syncthreads();
    load_w(i + kStages - 1);
    load_x(i + kStages - 1);
    cp_commit();
    if (i + 1 < n)
      unpack<F, T, C>(ring + ((i + 1) % kStages) * L::STAGE,
                      Wt + ((i + 1) & 1) * L::W_ELEMS, eff + ((i + 1) & 1) * L::EFF);
    int tile, m0, n0, k0;
    at(i, tile, m0, n0, k0);
    if (wm < M - m0)
      dq_products<F, T, C>(acc, ring + (i % kStages) * L::STAGE,
                           Wt + (i & 1) * L::W_ELEMS, eff + (i & 1) * L::EFF,
                           wm, wn);
    if (k0 + C::BK >= nkb * C::BK || i + 1 == n)
      end_piece<C, false>(acc, out, ws, it0, it0 + i, run, nkb, tile, m0,
                          n0, M, N, wm, wn);
  }
}

// ---------------------------------------------------------------------
// dot_i8 (q8_0)
// ---------------------------------------------------------------------

// A stage: x's int8 rows (BM x BK, row stride XQS), x's scales
// ([NB][BM]), the int8 weight rows (BK x BN, chunks swizzled), w's
// scales ([NB][BN]).
template <class C>
struct I8 {
  static constexpr int NB = C::BK / 32;
  static constexpr int XQS = C::BK + 16;
  static constexpr int XQ_OFF = 0;
  static constexpr int XS_OFF = XQ_OFF + C::BM * XQS;
  static constexpr int WQ_OFF = XS_OFF + NB * C::BM * 4;
  static constexpr int WSC_OFF = WQ_OFF + C::BK * C::BN;
  static constexpr int STAGE = WSC_OFF + NB * C::BN * 4;
  static constexpr int SMEM = kStages * STAGE;
  static_assert(C::BN >= 128 && C::NT % 4 == 0, "swizzle, column groups");
  static_assert(STAGE % 16 == 0 && XS_OFF % 16 == 0 && WQ_OFF % 16 == 0 &&
                    WSC_OFF % 16 == 0, "16-byte stage regions");
  static_assert(SMEM <= 232448, "one CTA per SM");
};

// rows k .. k+3 of one 4-column word, as 4 words of those 4 k (byte j =
// row k + j) of each column
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4],
                                           uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t t1 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
  o[0] = __byte_perm(t0, t2, 0x5410);
  o[1] = __byte_perm(t0, t2, 0x7632);
  o[2] = __byte_perm(t1, t3, 0x5410);
  o[3] = __byte_perm(t1, t3, 0x7632);
}

// Block qb's epilogue: acc += (part * x_scale) * w_scale, each rounded;
// the lane's columns of group gq are 8t .. 8t+7 (mma c: 8t + c and
// 8t + 4 + c).
template <class C>
__device__ __forceinline__ void i8_epilogue(float (&acc)[C::MT][C::NT][4],
                                            const int (&d)[C::MT][C::NT][4],
                                            const float* wsc,
                                            const float* xs, int wm, int wn) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int gq = 0; gq < C::NT / 4; ++gq) {
    const float4 lo =
        *reinterpret_cast<const float4*>(wsc + wn + 32 * gq + 8 * t);
    const float4 hi =
        *reinterpret_cast<const float4*>(wsc + wn + 32 * gq + 8 * t + 4);
    const float wv[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int i = 0; i < C::MT; ++i) {
      const float xv[2] = {xs[wm + 16 * i + g], xs[wm + 16 * i + g + 8]};
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& a = acc[i][4 * gq + c][e];
          a = __fadd_rn(a, __fmul_rn(__fmul_rn(i2f_exact(d[i][4 * gq + c][e]),
                                               xv[e >> 1]),
                                     wv[4 * (e & 1) + c]));
        }
    }
  }
}

// The warp's products of one stage: per 32-block the exact int32 dots
// on the int8 tensor cores, then the epilogue.
template <class C>
__device__ __forceinline__ void i8_products(float (&acc)[C::MT][C::NT][4],
                                            const unsigned char* st, int wm,
                                            int wn) {
  using L = I8<C>;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int q = lane >> 3, rr = lane & 7;
  const unsigned char* X = st + L::XQ_OFF;
  const float* xs = reinterpret_cast<const float*>(st + L::XS_OFF);
  const unsigned char* Wq = st + L::WQ_OFF;
  const float* wsc = reinterpret_cast<const float*>(st + L::WSC_OFF);
#pragma unroll
  for (int qb = 0; qb < L::NB; ++qb) {
    uint32_t b[C::NT][2];
#pragma unroll
    for (int gq = 0; gq < C::NT / 4; ++gq) {
      const int cw = (wn + 32 * gq) / 4 + g;     // the lane's word column
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r0 = 32 * qb + 16 * h + 4 * t;
        uint32_t w[4], o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = r0 + j;
          w[j] = *reinterpret_cast<const uint32_t*>(
              Wq + r * C::BN + swizzle(r, cw >> 2) * 16 + (cw & 3) * 4);
        }
        transpose4(w, o);
#pragma unroll
        for (int c = 0; c < 4; ++c) b[4 * gq + c][h] = o[c];
      }
    }
    int d[C::MT][C::NT][4];
#pragma unroll
    for (int i = 0; i < C::MT; ++i)
#pragma unroll
      for (int j = 0; j < C::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[i][j][e] = 0;
#pragma unroll
    for (int i = 0; i < C::MT; ++i) {
      uint32_t a[4];
      ldsm_x4(a, X + (wm + 16 * i + rr + 8 * (q & 1)) * L::XQS + 32 * qb +
                     16 * (q >> 1));
#pragma unroll
      for (int j = 0; j < C::NT; ++j) mma_s8(d[i][j], a, b[j][0], b[j][1]);
    }
    i8_epilogue<C>(acc, d, wsc + qb * C::BN, xs + qb * C::BM, wm, wn);
  }
}

// One run of the stream.  xq: x quantized ([M][K] int8); xs: its scales
// ([K/32][Mp]); wq, wsc: the q8_0 planes.
template <class C, bool V>
__device__ __forceinline__ void dot_i8_body(
    const unsigned char* __restrict__ xq, const float* __restrict__ xs,
    const unsigned char* __restrict__ wq,
    const unsigned char* __restrict__ wsc, float* __restrict__ out,
    float* __restrict__ ws, int M, int K, int N,
    int Mp, int nkb, int n_tiles, int64_t iters) {
  using L = I8<C>;
  extern __shared__ __align__(16) unsigned char smem[];

  const int64_t run = blockIdx.x;
  const int64_t it0 = slice_start(run, iters, gridDim.x);
  const int n = (int)(slice_start(run + 1, iters, gridDim.x) - it0);
  const int warp = threadIdx.x >> 5;
  const int wm = (warp / C::WN) * 16 * C::MT, wn = (warp % C::WN) * 8 * C::NT;
  const int64_t N4 = (int64_t)N * 4;

  const int tile0 = (int)(it0 / nkb), step0 = (int)(it0 % nkb);
  auto at = [&](int i, int& tile, int& m0, int& n0, int& k0) {
    const int ks = step0 + i;
    tile = tile0 + ks / nkb;
    k0 = (ks % nkb) * C::BK;
    m0 = (tile / n_tiles) * C::BM;
    n0 = (tile % n_tiles) * C::BN;
  };
  auto load_w = [&](int i) {
    if (i >= n) return;
    int tile, m0, n0, k0;
    at(i, tile, m0, n0, k0);
    unsigned char* st = smem + (i % kStages) * L::STAGE;
    copy_block<C::BK, C::BN, true, V>(st + L::WQ_OFF, C::BN,
                                   wq + (int64_t)k0 * N + n0, N, K - k0,
                                   N - n0);
    copy_block<L::NB, C::BN * 4, false, V>(st + L::WSC_OFF, C::BN * 4,
                                        wsc + (k0 / 32) * N4 + n0 * 4, N4,
                                        (K - k0) / 32, (N - n0) * 4);
  };
  auto load_x = [&](int i) {
    if (i >= n) return;
    int tile, m0, n0, k0;
    at(i, tile, m0, n0, k0);
    unsigned char* st = smem + (i % kStages) * L::STAGE;
    copy_block<C::BM, C::BK, false, true>(st + L::XQ_OFF, L::XQS,
                                    xq + (int64_t)m0 * K + k0, K, M - m0,
                                    K - k0);
    copy_block<L::NB, C::BM * 4, false, true>(
        st + L::XS_OFF, C::BM * 4,
        reinterpret_cast<const unsigned char*>(xs + (int64_t)(k0 / 32) * Mp +
                                               m0),
        (int64_t)Mp * 4, (K - k0) / 32, (Mp - m0) * 4);
  };

#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) load_w(s);
  griddep_wait();
#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) {
    load_x(s);
    cp_commit();
  }
  float acc[C::MT][C::NT][4];
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  for (int i = 0; i < n; ++i) {
    // stage i has landed; every warp is done with stage i - 1, whose
    // slot the next copies take
    cp_wait<kStages - 2>();
    __syncthreads();
    load_w(i + kStages - 1);
    load_x(i + kStages - 1);
    cp_commit();
    int tile, m0, n0, k0;
    at(i, tile, m0, n0, k0);
    if (wm < M - m0)
      i8_products<C>(acc, smem + (i % kStages) * L::STAGE, wm, wn);
    if (k0 + C::BK >= nkb * C::BK || i + 1 == n)
      end_piece<C, true>(acc, out, ws, it0, it0 + i, run, nkb, tile, m0, n0,
                         M, N, wm, wn);
  }
}

// ---------------------------------------------------------------------
// kernels and launch
// ---------------------------------------------------------------------

#define DQ_ARGS                                                             \
  const unsigned char *x, const unsigned char *vals,                        \
      const unsigned char *subs, const unsigned char *subm,                 \
      const unsigned char *sups, const unsigned char *supm,                 \
      const float *xsum, float *out, float *ws, int M, int K,                \
      int N, int Mp, int nkb, int n_tiles, long long iters
#define DQ_KERNEL(name, F, T, C, V)                                         \
  __global__ void __launch_bounds__(kThreads, 1) name(DQ_ARGS) {         \
    dequant_body<F, T, C, V>(x, vals, subs, subm, sups, supm, xsum, out,    \
                             ws, M, K, N, Mp, nkb, n_tiles,                 \
                             iters);                                        \
  }
// every format, x dtype and tile, by 16-byte copies and (_plain) by
// byte copies
#define DQ_KERNELS(fmt, F, dt, T)                                           \
  DQ_KERNEL(qmatmul_dequant_dot_##fmt##_##dt##_m16, F, T, DqSmall, true)    \
  DQ_KERNEL(qmatmul_dequant_dot_##fmt##_##dt##_m128, F, T, DqLarge, true)   \
  DQ_KERNEL(qmatmul_dequant_dot_##fmt##_##dt##_m16_plain, F, T, DqSmall,    \
            false)                                                          \
  DQ_KERNEL(qmatmul_dequant_dot_##fmt##_##dt##_m128_plain, F, T, DqLarge,   \
            false)
DQ_KERNELS(q8_0, 0, f32, float)
DQ_KERNELS(q8_0, 0, bf16, bf16)
DQ_KERNELS(q6_k, 1, f32, float)
DQ_KERNELS(q6_k, 1, bf16, bf16)
DQ_KERNELS(q4_k, 2, f32, float)
DQ_KERNELS(q4_k, 2, bf16, bf16)
DQ_KERNELS(q2_k, 3, f32, float)
DQ_KERNELS(q2_k, 3, bf16, bf16)
#undef DQ_KERNELS
#undef DQ_KERNEL

#define I8_ARGS                                                            \
  const unsigned char *xq, const float *xs, const unsigned char *wq,       \
      const unsigned char *wsc, float *out, float *ws, int M, int K, int N, \
      int Mp, int nkb, int n_tiles, long long iters
#define I8_KERNEL(name, C, V)                                              \
  __global__ void __launch_bounds__(kThreads, 1) name(I8_ARGS) {        \
    dot_i8_body<C, V>(xq, xs, wq, wsc, out, ws, M, K, N, Mp,               \
                      nkb, n_tiles, iters);                                \
  }
I8_KERNEL(qmatmul_dot_i8_m16, I8Small, true)
I8_KERNEL(qmatmul_dot_i8_m128, I8Large, true)
I8_KERNEL(qmatmul_dot_i8_m16_plain, I8Small, false)
I8_KERNEL(qmatmul_dot_i8_m128_plain, I8Large, false)
#undef I8_KERNEL

using DqFn = void (*)(DQ_ARGS);
using I8Fn = void (*)(I8_ARGS);
#undef DQ_ARGS
#undef I8_ARGS

struct DqEntry {
  DqFn fn;
  int smem;
};
// [fmt][x dtype][large][16-byte copies]
template <int F, typename T>
constexpr DqEntry dq_entry(DqFn fn, bool large) {
  return {fn, large ? Dq<F, T, DqLarge>::SMEM : Dq<F, T, DqSmall>::SMEM};
}
#define DQ_ENTRIES(fmt, F, dt, T)                                           \
  {{dq_entry<F, T>(qmatmul_dequant_dot_##fmt##_##dt##_m16_plain, false),    \
    dq_entry<F, T>(qmatmul_dequant_dot_##fmt##_##dt##_m16, false)},         \
   {dq_entry<F, T>(qmatmul_dequant_dot_##fmt##_##dt##_m128_plain, true),    \
    dq_entry<F, T>(qmatmul_dequant_dot_##fmt##_##dt##_m128, true)}}
const DqEntry kDq[4][2][2][2] = {
    {DQ_ENTRIES(q8_0, 0, f32, float), DQ_ENTRIES(q8_0, 0, bf16, bf16)},
    {DQ_ENTRIES(q6_k, 1, f32, float), DQ_ENTRIES(q6_k, 1, bf16, bf16)},
    {DQ_ENTRIES(q4_k, 2, f32, float), DQ_ENTRIES(q4_k, 2, bf16, bf16)},
    {DQ_ENTRIES(q2_k, 3, f32, float), DQ_ENTRIES(q2_k, 3, bf16, bf16)}};
#undef DQ_ENTRIES
const I8Fn kI8[2][2] = {{qmatmul_dot_i8_m16_plain, qmatmul_dot_i8_m16},
                        {qmatmul_dot_i8_m128_plain, qmatmul_dot_i8_m128}};
// the dynamic shared-memory limit set so far, per kernel and device
int kDqAllowed[4][2][2][2][64] = {};
int kI8Allowed[2][2][64] = {};

constexpr int kSub[4] = {32, 16, 32, 16};
constexpr bool kAsym[4] = {false, false, true, true};

// The products' launch: one CTA a run; a programmatic dependent launch
// of the first launch when `pdl`.
template <typename Fn, typename... Args>
cudaError_t launch_runs(Fn fn, int smem, int* allowed, int runs, bool pdl,
                        cudaStream_t s, Args... args) {
  cudaError_t err = allow_smem(fn, smem, allowed);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(runs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, fn, args...);
}

}  // namespace

// fmt: 0 q8_0, 1 q6_k, 2 q4_k, 3 q2_k; variant: 0 dequant_dot, 1 dot_i8
// (q8_0 only); x_dtype: 0 float32, 1 bfloat16.  Planes a format lacks
// are passed as null.  Scratch from the caller (Mp = M rounded up to 4):
//   xbuf  dequant_dot f32 x: bf16 [3][M][K]; dot_i8: int8 [M][K];
//   xsum  dequant_dot q4_k/q2_k: f32 [K/sub][Mp]; dot_i8: f32 [K/32][Mp];
//   ws    ws_floats >= (runs + tiles - 1) * min(M, BM) * BN f32.
// runs: CTAs of the products' launch (1 .. tiles * K steps); vec: every
// plane row whole 16-byte chunks on 16-byte-aligned bases (and x's, for
// bf16 dequant_dot).  Launches: x first (split, summed or quantized;
// none for bf16 x with q8_0/q6_k), the products, the fold; the second
// and third as programmatic dependents of the one before.
extern "C" int qmatmul_fwd(const void* x, const void* values,
                           const void* sub_s, const void* sub_m,
                           const void* sup_s, const void* sup_m, void* out,
                           void* xbuf, void* xsum, void* ws,
                           long long ws_floats, int M, int K, int N, int fmt,
                           int variant, int x_dtype, int runs, int vec,
                           void* stream) {
  if (M < 1 || K < 1 || N < 1 || fmt < 0 || fmt > 3 || variant < 0 ||
      variant > 1 || x_dtype < 0 || x_dtype > 1 || K % 32 ||
      (fmt != 0 && K % 256) || (variant == 1 && fmt != 0))
    return (int)cudaErrorInvalidValue;
  const bool large = M > 16;
  const int BM = large ? 128 : 16, BN = large ? 128 : 256;
  const int BK = variant == 1 ? 64 : (large ? DqLarge::BK : DqSmall::BK);
  const int nkb = (K + BK - 1) / BK, n_tiles = (N + BN - 1) / BN;
  const int64_t tiles = (int64_t)((M + BM - 1) / BM) * n_tiles;
  const int64_t iters = tiles * nkb;
  const int64_t slot_rows = M < BM ? M : BM;
  if (runs < 1 || runs > iters || runs > 65535 || tiles > 65535 ||
      ws_floats < (runs + tiles - 1) * slot_rows * BN)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Mp = (M + 3) & ~3;
  const int prep_blocks =
      (int)(((int64_t)Mp * (K / 8) + kThreads - 1) / kThreads);
  const unsigned char* v = static_cast<const unsigned char*>(values);
  float* o = static_cast<float*>(out);
  float* w = static_cast<float*>(ws);
  float* xs = static_cast<float*>(xsum);
  cudaError_t err;
  if (variant == 1) {
    if (x_dtype == 0)
      qmatmul_prep_quant_f32<<<prep_blocks, kThreads, 0, s>>>(
          static_cast<const float*>(x), static_cast<int8_t*>(xbuf), xs, M, K,
          Mp);
    else
      qmatmul_prep_quant_bf16<<<prep_blocks, kThreads, 0, s>>>(
          static_cast<const bf16*>(x), static_cast<int8_t*>(xbuf), xs, M, K,
          Mp);
    err = cudaGetLastError();
    if (err == cudaSuccess)
      err = launch_runs(
          kI8[large][vec != 0], large ? I8<I8Large>::SMEM : I8<I8Small>::SMEM,
          kI8Allowed[large][vec != 0], runs, true, s,
          static_cast<const unsigned char*>(xbuf),
          static_cast<const float*>(xs), v,
          static_cast<const unsigned char*>(sup_s), o, w, M, K, N, Mp, nkb,
          n_tiles, (long long)iters);
  } else {
    const int sub = kAsym[fmt] ? kSub[fmt] : 0;
    bool pdl = false;
    const void* xsrc = x;
    if (x_dtype == 0) {
      qmatmul_prep_split_f32<<<prep_blocks, kThreads, 0, s>>>(
          static_cast<const float*>(x), static_cast<bf16*>(xbuf), xs, M, K,
          Mp, sub);
      pdl = true;
      xsrc = xbuf;
    } else if (sub) {
      qmatmul_prep_sum_bf16<<<prep_blocks, kThreads, 0, s>>>(
          static_cast<const bf16*>(x), nullptr, xs, M, K, Mp, sub);
      pdl = true;
    }
    err = cudaGetLastError();
    const DqEntry& e = kDq[fmt][x_dtype][large][vec != 0];
    if (err == cudaSuccess)
      err = launch_runs(
          e.fn, e.smem, kDqAllowed[fmt][x_dtype][large][vec != 0], runs, pdl,
          s,
          static_cast<const unsigned char*>(xsrc), v,
          static_cast<const unsigned char*>(sub_s),
          static_cast<const unsigned char*>(sub_m),
          static_cast<const unsigned char*>(sup_s),
          static_cast<const unsigned char*>(sup_m),
          static_cast<const float*>(xs), o, w, M, K, N, Mp, nkb, n_tiles,
          (long long)iters);
  }
  if (err != cudaSuccess) return (int)err;
  // every run whole tiles: nothing to add
  if (iters % runs == 0 && (iters / runs) % nkb == 0) return 0;
  const int per = kThreads / (BN / 4);   // rows a fold CTA
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)tiles, (unsigned)((slot_rows + per - 1) / per));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, qmatmul_fold,
                                 static_cast<const float*>(w), o, M, N, BM,
                                 BN, nkb, n_tiles, (long long)iters, runs);
}
