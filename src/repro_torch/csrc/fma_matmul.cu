// Path-selectable matmul for Hopper (sm_90a): K9, (M,K) @ (K,N) with
// float32 or bfloat16 inputs and float32 accumulators and output.
//
// Replaces fma_matmul_pallas in src/repro/kernels/fma_matmul/kernel.py:
// grid (M/bm, N/bn, K/bk), K innermost, an f32 VMEM accumulator carried
// across the K steps, and two variants of the tile product:
//   * mxu:     jnp.dot on the 128x128 systolic array (the matrix unit);
//   * mul_add: a broadcast multiply and a reduce-add on the VPU, no
//     matrix unit -- the TPU reading of the paper's -fmad=false.
// Here the variants keep their meaning (core/compute_path.py: mxu ->
// Path.TENSOR, mul_add -> Path.MUL_ADD):
//   * mxu runs on the tensor cores: TF32 for f32 inputs (each element
//     rounded to TF32 with cvt.rna, as WMMA's __float_to_tf32 does), bf16
//     products for bf16 inputs, f32 accumulators;
//   * mul_add runs on the CUDA cores: every multiply-accumulate is
//     __fmul_rn then __fadd_rn into an f32 accumulator, which nvcc never
//     contracts -- no tensor core and no FFMA in the kernel.
//   There is no fused (FFMA) arm: the reference has none.
//
// What bounds mxu on the H100: at the qwen2.5-1.5b MLP shapes (M = 128
// tokens, K x N = 1536 x 8960 or 8960 x 1536) the product does 2*M*K*N
// = 3.5 GFLOP (7.1 us at 495 TF32) over 60.4 MB in f32 (18.0 us at
// 3.35 TB/s): bytes bind.  So the mxu kernel (fma_matmul_mxu_f32/_bf16,
// "the weight stream") is built for the memory side:
//   * one CTA covers 128 rows of x, so each weight byte is read once for
//     M <= 128 (beyond that, each 128-row band is tiles of its own);
//     tiles are 256 columns wide, so x is read from the L2 once per 256
//     columns of w;
//   * the (128 x 256 tile, one K block) steps of all tiles are cut into
//     equal runs, one CTA per SM (split-K in the stream-K manner), so
//     every SM streams the same weight bytes whatever the number of
//     tiles; a run that holds only a piece of a tile writes it to an f32
//     workspace, and a second small kernel (fma_matmul_splitk_reduce)
//     adds the pieces in run order -- no atomics, the same bits on every
//     launch;
//   * a ring of 3 stages (48 KB each) in dynamic shared memory, filled by
//     TMA: one thread issues a stage as 2D tensor-map boxes of 128-byte
//     rows (w in 8 boxes of 128 bytes x one K block, x in one box of 128
//     rows), completing on the stage's mbarrier, with the 128-byte
//     swizzle so the fragment loads hit 32 banks; zeros past every edge
//     come from TMA itself.  The weight goes with an L2 evict-first
//     policy, x with evict-last.  The maps are encoded on the host per
//     call (cuTensorMapEncodeTiled, found with cudaGetDriverEntryPoint);
//   * the tensor cores through mma.sync: m16n8k8 .tf32 for f32 (x rounded
//     to TF32 once per stage in shared memory, w as its fragments are
//     loaded), m16n8k16 .bf16 for bf16 (ldmatrix, .trans for w).  wgmma's
//     TF32 form cannot read the (K, N) row-major weight, which is
//     MN-major for B, without a transpose.  8 warps as 2 x 4, each
//     64 x 64 of the tile in registers; the result leaves from registers
//     as 16-byte stores (neighbouring lanes swap halves so each holds
//     four columns).
// What bounds mul_add on the H100: the same product is 1.76 G
// multiply-accumulates, each a separate FMUL and FADD -- two issued
// instructions where FFMA needs one -- so the CUDA cores' issue rate
// binds (half the 66.9 TFLOP/s FP32 peak: 105 us), against 18.0 us of
// bytes in f32 and 9.7 us in bf16.  So the mul_add stream kernel
// (fma_matmul_mul_add_f32/_bf16) spends almost every issue slot on FMUL
// and FADD and keeps every SM equally busy:
//   * the weight stream's feed, plan and reduce as they are (the body
//     is one template over the arm): 128 x 256 tiles, the K blocks of all
//     tiles cut into one equal run per SM, the TMA ring, the workspace
//     for pieces of tiles and fma_matmul_splitk_reduce.  K is 32 a stage
//     in both types: at mxu's 64 for bf16, the MLP shapes would cut into
//     runs of 6 or 7 stages, the longest 10% over the mean (at 32, 12 or
//     13: 2%).  The boxes are unswizzled (x whole, w 256 columns wide):
//     every read below is a broadcast or a quarter-warp on one 128-byte
//     row, which hits 32 banks as it is;
//   * 512 threads, 16 warps of 8 rows x 256 columns; each thread holds
//     8 rows x 8 columns (4 at c and 4 at c + 128) of accumulators in
//     registers.  Per K step a thread issues 64 __fmul_rn and 64
//     __fadd_rn against two 16-byte loads of w (its 8 columns) and, once
//     per 4 K steps, eight 16-byte loads of x (4 K of each of its rows,
//     the same address in every lane): ~97% of the loop is FMUL/FADD,
//     and 4 warps per scheduler hide the loads' latency;
//   * bf16 inputs are converted once per stage: after a stage lands,
//     the CTA writes it as f32 (the same layout, bit-exact) into one of
//     two buffers, and the product reads those -- the inner loop is the
//     f32 one.
// The weight stream needs rows that are whole 16-byte chunks on
// 16-byte-aligned bases (K and N multiples of 4 in f32, of 8 in bf16).
// Other shapes go to each arm's staged kernel: one CTA per 64x64 tile,
// K staged through shared memory 32 deep element by element
// (zero-filled past the edges, so any M, K, N works) -- WMMA for mxu
// (fma_matmul_mxu_wmma_f32/_bf16), 256 threads of 4x4 register blocks
// of FMUL and FADD for mul_add (fma_matmul_mul_add_staged_f32/_bf16).
//
// C interface (loaded with ctypes): fma_matmul_fwd returns the
// cudaError_t of the launches; it allocates nothing (the split-K
// workspace comes from the caller) and launches on the stream it is
// given.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}

// WMMA shape and shared-memory padding per input type (the leading
// dimension of a fragment load must be a multiple of 16 bytes).
template <typename T> struct Mma;
template <> struct Mma<float> {
  static constexpr int kK = 8;
  static constexpr int kPad = 4;
  using Elem = wmma::precision::tf32;
};
template <> struct Mma<__nv_bfloat16> {
  static constexpr int kK = 16;
  static constexpr int kPad = 8;
  using Elem = __nv_bfloat16;
};

// Stage the (BM x BK) tile of x and the (BK x BN) tile of w at (m0, k0,
// n0) into shared memory as S, zero past the matrix edges.
template <typename T, typename S, int LDA, int LDB, int NT>
__device__ __forceinline__ void stage(const T* __restrict__ x,
                                      const T* __restrict__ w, S* As, S* Bs,
                                      int M, int K, int N, int m0, int k0,
                                      int n0) {
  for (int e = threadIdx.x; e < BM * BK; e += NT) {
    int r = e / BK, c = e % BK;
    int gr = m0 + r, gc = k0 + c;
    T v = (gr < M && gc < K) ? x[(int64_t)gr * K + gc] : zero<T>();
    if constexpr (sizeof(S) == sizeof(T)) {
      As[r * LDA + c] = v;
    } else {
      As[r * LDA + c] = to_f32(v);
    }
  }
  for (int e = threadIdx.x; e < BK * BN; e += NT) {
    int r = e / BN, c = e % BN;
    int gr = k0 + r, gc = n0 + c;
    T v = (gr < K && gc < N) ? w[(int64_t)gr * N + gc] : zero<T>();
    if constexpr (sizeof(S) == sizeof(T)) {
      Bs[r * LDB + c] = v;
    } else {
      Bs[r * LDB + c] = to_f32(v);
    }
  }
}

// ---------------------------------------------------------------------
// mxu, rows that are not whole 16-byte chunks: WMMA
// ---------------------------------------------------------------------

constexpr int kMxuThreads = 128;

template <typename T>
__device__ __forceinline__ void wmma_body(const T* __restrict__ x,
                                         const T* __restrict__ w,
                                         float* __restrict__ out, int M,
                                         int K, int N) {
  constexpr int LDA = BK + Mma<T>::kPad;
  constexpr int LDB = BN + Mma<T>::kPad;
  constexpr int LDC = BN + 4;
  constexpr int MK = Mma<T>::kK;
  using Elem = typename Mma<T>::Elem;
  // raw bytes: fragment loads need 32-byte aligned rows
  __shared__ __align__(32) unsigned char a_bytes[BM * LDA * sizeof(T)];
  __shared__ __align__(32) unsigned char b_bytes[BK * LDB * sizeof(T)];
  __shared__ __align__(32) float Cs[BM * LDC];
  T* As = reinterpret_cast<T*>(a_bytes);
  T* Bs = reinterpret_cast<T*>(b_bytes);

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, MK, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    stage<T, T, LDA, LDB, kMxuThreads>(x, w, As, Bs, M, K, N, m0, k0, n0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += MK) {
      wmma::fragment<wmma::matrix_a, 16, 16, MK, Elem, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, MK, Elem, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(a[i], As + (wm + 16 * i) * LDA + kk, LDA);
        wmma::load_matrix_sync(b[i], Bs + kk * LDB + wn + 16 * i, LDB);
        if constexpr (sizeof(T) == 4) {
#pragma unroll
          for (int t = 0; t < a[i].num_elements; ++t)
            a[i].x[t] = wmma::__float_to_tf32(a[i].x[t]);
#pragma unroll
          for (int t = 0; t < b[i].num_elements; ++t)
            b[i].x[t] = wmma::__float_to_tf32(b[i].x[t]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + 16 * i) * LDC + wn + 16 * j,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int e = threadIdx.x; e < BM * BN; e += kMxuThreads) {
    int r = e / BN, c = e % BN;
    if (m0 + r < M && n0 + c < N)
      out[(int64_t)(m0 + r) * N + n0 + c] = Cs[r * LDC + c];
  }
}

__global__ void __launch_bounds__(kMxuThreads)
fma_matmul_mxu_wmma_f32(const float* x, const float* w, float* out, int M,
                        int K, int N) {
  wmma_body<float>(x, w, out, M, K, N);
}

__global__ void __launch_bounds__(kMxuThreads)
fma_matmul_mxu_wmma_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                         float* out, int M, int K, int N) {
  wmma_body<__nv_bfloat16>(x, w, out, M, K, N);
}

// ---------------------------------------------------------------------
// the weight stream (TMA ring, split-K), and mxu's product (mma.sync)
// ---------------------------------------------------------------------

constexpr int kStreamThreads = 256;   // mxu: 8 warps, 2 along M x 4 along N
constexpr int kWarps = kStreamThreads / 32;
constexpr int SBM = 128;              // rows of x per CTA
constexpr int SBN = 256;              // columns of w per CTA
constexpr int WARPS_M = 2;            // warps along M
constexpr int WM = SBM / WARPS_M;     // rows per warp
constexpr int WN = SBN * WARPS_M / kWarps;  // columns per warp
constexpr int MI = WM / 16;           // 16 x 8 mma blocks per warp column
constexpr int NJ = WN / 8;            // 16 x 8 mma blocks per warp row
constexpr int kStages = 3;            // ring depth in shared memory

// mxu per input type: K per stage, kBK (128 bytes: one row of an x box),
// the weight's box width kBoxN (128 bytes: kBoxN columns by kBK rows)
// and the mma shape: m16n8k8 (tf32) or m16n8k16 (bf16).  Every box is
// stored with TMA's 128-byte swizzle: 16-byte chunk c of its 128-byte
// row r sits at chunk c ^ (r % 8), so 8 rows read at one chunk hit 32
// different banks.
template <typename T> struct Stream;
template <> struct Stream<float> {
  static constexpr int kBK = 32;
  static constexpr int kBoxN = 32;
  static constexpr int kMmaK = 8;
};
template <> struct Stream<__nv_bfloat16> {
  static constexpr int kBK = 64;
  static constexpr int kBoxN = 64;
  static constexpr int kMmaK = 16;
};

// A stage of an arm: the w boxes (SBN / kBoxN of them, kBK rows each),
// then the x box (SBM rows of kBK); each box starts 1024-byte aligned,
// as the swizzle wants.
template <class Arm>
__host__ __device__ constexpr int stage_elems() {
  return Arm::kBK * (SBN + SBM);
}
// The ring, the arm's f32 copies of stages, one mbarrier per stage, and
// room to align the ring to 1024.
template <typename T, class Arm>
__host__ __device__ constexpr int stream_smem_bytes() {
  return kStages * (stage_elems<Arm>() * (int)sizeof(T) + 8) +
         Arm::kConvBytes + 1024;
}

// f32 rounded to TF32 (round to nearest, ties away), as the tensor
// cores take it.
__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(v));
  return u;
}

// x of a stage rounded to TF32 in place once it has landed (f32: the
// A fragments then need no conversion; each element is read by four
// warps), then ordered before the TMA that will next write the slot.
// bf16: nothing.
template <typename T>
__device__ __forceinline__ void round_x(T* As) {
  if constexpr (sizeof(T) == 4) {
    constexpr int NV = SBM * Stream<float>::kBK / 4;
#pragma unroll
    for (int i = 0; i < NV / kStreamThreads; ++i) {
      float4* p = reinterpret_cast<float4*>(As) + threadIdx.x +
                  i * kStreamThreads;
      float4 v = *p;
      v.x = __uint_as_float(to_tf32(v.x));
      v.y = __uint_as_float(to_tf32(v.y));
      v.z = __uint_as_float(to_tf32(v.z));
      v.w = __uint_as_float(to_tf32(v.w));
      *p = v;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// The one arrival of a phase, which also arms it for `bytes` of copies.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
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
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}
// L2 policies: the weight streams past once, x is read by every
// column tile.
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}
__device__ __forceinline__ uint64_t evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}
// TMA: the box of a tensor map at (column n, row k) into shared memory,
// completing on bar; past the matrix's edges it is 0.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int n, int k, uint64_t* bar,
                                         uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(n), "r"(k),
      "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void mma_16x8(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2], float) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma_16x8(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2],
                                         __nv_bfloat16) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ldmatrix: lanes 8q .. 8q + 7 give the rows of 8 x 16-byte matrix q;
// each lane gets word (lane / 4, lane % 4) of every matrix (.trans: the
// two 16-bit elements of column lane / 4 at rows 2 (lane % 4) and the
// next).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// The fragments of one mma step at depth kk of the stage, for the
// warp's 64 x WN block at (wm, wn); g = lane / 4, t = lane % 4 (the PTX
// ISA's groupID and threadID_in_group), q = lane / 8 and rr = lane % 8
// pick the row a lane gives ldmatrix.  A comes through ldmatrix.x4, one
// per 16 rows: its four 8 x 16-byte matrices are the fragment's four
// registers (rows +8 for q odd, K +16 bytes for q >= 2), which for f32
// holds the tf32 layout too (a 16-byte row is 4 floats); each row's
// chunk sits where the swizzle put it.
__device__ __forceinline__ void load_frags(const float* As, const float* Bs,
                                           int kk, int wm, int wn, int g,
                                           int t, int q, int rr,
                                           uint32_t (&a)[MI][4],
                                           uint32_t (&b)[NJ][2]) {
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int r = wm + 16 * i + rr + 8 * (q & 1), c = kk / 4 + (q >> 1);
    ldmatrix_x4(a[i], As + r * 32 + ((c ^ (r & 7)) << 2));
  }
  // B's tf32 pairs run along K, down a column of the (K, N) tile: no
  // ldmatrix form reads 32-bit elements transposed, so one load each,
  // from the swizzled box of column n (rows k and k + 4; kk % 8 == 0)
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int n = wn + 8 * j + g;
    const float* p = Bs + (n / 32) * (32 * 32) + (kk + t) * 32 + (n & 3);
    b[j][0] = to_tf32(p[(((n & 31) >> 2) ^ t) * 4]);
    b[j][1] = to_tf32(p[4 * 32 + (((n & 31) >> 2) ^ (t + 4)) * 4]);
  }
}
__device__ __forceinline__ void load_frags(const __nv_bfloat16* As,
                                           const __nv_bfloat16* Bs, int kk,
                                           int wm, int wn, int g, int t,
                                           int q, int rr,
                                           uint32_t (&a)[MI][4],
                                           uint32_t (&b)[NJ][2]) {
  constexpr int BK = Stream<__nv_bfloat16>::kBK;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int r = wm + 16 * i + rr + 8 * (q & 1), c = kk / 8 + (q >> 1);
    ldmatrix_x4(a[i], As + r * 64 + ((c ^ (r & 7)) << 3));
  }
  // B through ldmatrix.x4.trans, two n8 blocks a call: matrices (K rows
  // +8 for q odd, columns +8 for q >= 2) are b0, b1 of block 2j and of
  // block 2j + 1; a row's 16-byte chunk sits where the swizzle put it
#pragma unroll
  for (int j = 0; j < NJ / 2; ++j) {
    uint32_t r[4];
    const int k = kk + rr + 8 * (q & 1), n = wn + 16 * j + 8 * (q >> 1);
    ldmatrix_x4_trans(r, Bs + (n / 64) * (BK * 64) + k * 64 +
                             ((((n & 63) >> 3) ^ (k & 7)) << 3));
    b[2 * j][0] = r[0];
    b[2 * j][1] = r[1];
    b[2 * j + 1][0] = r[2];
    b[2 * j + 1][1] = r[3];
  }
}

// Store a warp's 64 x WN block of acc at rows [r_lim) and columns
// [c_lim) of p (row stride ld), then zero acc.  A lane holds rows g and
// g + 8 at columns 2t, 2t + 1 of each 16 x 8 block; lanes t and t ^ 1
// swap halves so the even one stores row g and the odd one row g + 8,
// four columns each, in one 16-byte store.
__device__ __forceinline__ void store_block(float (&acc)[MI][NJ][4],
                                            float* p, int64_t ld, int wm,
                                            int wn, int g, int t, int r_lim,
                                            int c_lim) {
  const bool odd = t & 1;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float(&c)[4] = acc[i][j];
      const float r0 = __shfl_xor_sync(0xffffffffu, odd ? c[0] : c[2], 1);
      const float r1 = __shfl_xor_sync(0xffffffffu, odd ? c[1] : c[3], 1);
      const float4 v = odd ? make_float4(r0, r1, c[2], c[3])
                           : make_float4(c[0], c[1], r0, r1);
      const int row = wm + 16 * i + g + (odd ? 8 : 0);
      const int col = wn + 8 * j + 2 * (t & ~1);
      if (row < r_lim && col < c_lim)
        *reinterpret_cast<float4*>(p + row * ld + col) = v;
      c[0] = c[1] = c[2] = c[3] = 0.0f;
    }
}

// An arm of the weight stream: its geometry (threads, K per stage, the
// weight's box width, whether the boxes are swizzled, bytes of f32
// copies of stages), the type of a thread's accumulators, and the hooks
// the stream body calls on each stage st (w's boxes, then x's): prepare
// (before the stage's barrier), product and store.  The accumulators
// are the body's own local array, as in a plain kernel: held in a
// member array of an arm object instead, they slowed the mxu kernel
// on the H100 (ptxas scheduled its loop worse).
//
// mxu: the tensor cores through mma.sync, 8 warps as 2 x 4, each 64 x 64
// of the tile in registers.
template <typename T>
struct MxuArm {
  static constexpr int kThreads = kStreamThreads;
  static constexpr int kBK = Stream<T>::kBK, kBoxN = Stream<T>::kBoxN;
  static constexpr bool kSwizzle = true;
  static constexpr int kConvBytes = 0;
  using Acc = float[MI][NJ][4];

  // the warp's block: rows wm .. wm + 63, columns wn .. wn + WN - 1
  static __device__ __forceinline__ int wm() {
    return (threadIdx.x / 32 / (kWarps / WARPS_M)) * WM;
  }
  static __device__ __forceinline__ int wn() {
    return (threadIdx.x / 32 % (kWarps / WARPS_M)) * WN;
  }
  static __device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  }
  static __device__ __forceinline__ void prepare(T* st, float*, int) {
    round_x<T>(st + kBK * SBN);
  }
  // a warp whose 64 rows are all past the tile's rows (M <= 64) has no
  // products
  static __device__ __forceinline__ bool has_rows(int rows) {
    return wm() < rows;
  }
  static __device__ __forceinline__ void product(Acc& acc, const T* st,
                                                 const float*, int) {
    const int lane = threadIdx.x % 32;
    const T* Bs = st;
    const T* As = st + kBK * SBN;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += Stream<T>::kMmaK) {
      uint32_t a[MI][4], b[NJ][2];
      load_frags(As, Bs, kk, wm(), wn(), lane / 4, lane % 4, lane / 8,
                 lane % 8, a, b);
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma_16x8(acc[i][j], a[i], b[j], T());
    }
  }
  static __device__ __forceinline__ void store(Acc& acc, float* p,
                                               int64_t ld, int r_lim,
                                               int c_lim) {
    const int lane = threadIdx.x % 32;
    store_block(acc, p, ld, wm(), wn(), lane / 4, lane % 4, r_lim, c_lim);
  }
};

// mul_add: FMUL and FADD on the CUDA cores (see the note at the top).
// Warp v holds rows 8v .. 8v + 7 of the tile; lane l columns 4l .. 4l + 3
// and 128 + 4l .. 128 + 4l + 3.  The stage's boxes are unswizzled: w is
// (kBK, SBN) row-major, x (SBM, kBK).
constexpr int kMulAddThreads = 512;
constexpr int kRows = SBM / (kMulAddThreads / 32);   // rows per thread
constexpr int kCols = 8;                             // columns per thread

template <typename T>
struct MulAddArm {
  static constexpr int kThreads = kMulAddThreads;
  static constexpr int kBK = 32, kBoxN = SBN;
  static constexpr bool kSwizzle = false;
  // bf16: two f32 copies of a stage (the one in use and the next)
  static constexpr int kConvBytes =
      sizeof(T) == 4 ? 0 : 2 * kBK * (SBN + SBM) * (int)sizeof(float);
  using Acc = float[kRows][kCols];

  // the thread's block: rows r0() .. r0() + kRows - 1, columns c0() ..
  // c0() + 3 and c0() + 128 .. c0() + 131
  static __device__ __forceinline__ int r0() {
    return (threadIdx.x / 32) * kRows;
  }
  static __device__ __forceinline__ int c0() {
    return (threadIdx.x % 32) * 4;
  }
  static __device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[r][j] = 0.0f;
  }
  // stage i as f32: the ring slot itself, or (bf16) its copy
  static __device__ __forceinline__ const float* f32_stage(const T* st,
                                                           const float* conv,
                                                           int i) {
    if constexpr (sizeof(T) == 4)
      return reinterpret_cast<const float*>(st);
    else
      return conv + (i & 1) * kBK * (SBN + SBM);
  }
  // bf16: the landed stage converted to f32 once, 8 elements a thread
  // at a time (exact: a bf16 is the top half of its f32); the copy
  // it overwrites was last read in stage i - 2, before the barrier of
  // stage i - 1
  static __device__ __forceinline__ void prepare(T* st, float* conv, int i) {
    if constexpr (sizeof(T) == 2) {
      constexpr int kChunks = kBK * (SBN + SBM) / 8;
      static_assert(kChunks % kThreads == 0, "conversion block");
      float4* dst = reinterpret_cast<float4*>(conv + (i & 1) * kBK *
                                                         (SBN + SBM));
#pragma unroll
      for (int u = 0; u < kChunks / kThreads; ++u) {
        const int e = threadIdx.x + u * kThreads;
        const uint4 v = reinterpret_cast<const uint4*>(st)[e];
        dst[2 * e] = make_float4(
            __uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
            __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
        dst[2 * e + 1] = make_float4(
            __uint_as_float(v.z << 16), __uint_as_float(v.z & 0xffff0000u),
            __uint_as_float(v.w << 16), __uint_as_float(v.w & 0xffff0000u));
      }
    }
  }
  static __device__ __forceinline__ bool has_rows(int rows) {
    return r0() < rows;
  }
  // 4 K steps a round: each row's 4 K in one 16-byte load (the same
  // address across the warp), then per K step the thread's 8 columns of
  // w in two, and 64 separate multiplies and adds
  static __device__ __forceinline__ void product(Acc& acc, const T* st,
                                                 const float* conv, int i) {
    const float* W = f32_stage(st, conv, i) + c0();
    const float* X = f32_stage(st, conv, i) + kBK * SBN + r0() * kBK;
#pragma unroll 2
    for (int kq = 0; kq < kBK; kq += 4) {
      float a[kRows][4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 v = *reinterpret_cast<const float4*>(X + r * kBK + kq);
        a[r][0] = v.x, a[r][1] = v.y, a[r][2] = v.z, a[r][3] = v.w;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* wk = W + (kq + kk) * SBN;
        const float4 lo = *reinterpret_cast<const float4*>(wk);
        const float4 hi = *reinterpret_cast<const float4*>(wk + SBN / 2);
        const float b[kCols] = {lo.x, lo.y, lo.z, lo.w,
                                hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int j = 0; j < kCols; ++j)
            acc[r][j] = __fadd_rn(acc[r][j], __fmul_rn(a[r][kk], b[j]));
      }
    }
  }
  // rows [r_lim) and columns [c_lim) of the thread's block to p (row
  // stride ld) as 16-byte stores, then acc zeroed
  static __device__ __forceinline__ void store(Acc& acc, float* p,
                                               int64_t ld, int r_lim,
                                               int c_lim) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0() + r, col = c0() + h * (SBN / 2);
        if (row < r_lim && col < c_lim)
          *reinterpret_cast<float4*>(p + row * ld + col) =
              make_float4(acc[r][4 * h], acc[r][4 * h + 1],
                          acc[r][4 * h + 2], acc[r][4 * h + 3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][4 * h + e] = 0.0f;
      }
  }
};

static_assert(kRows * (kMulAddThreads / 32) == SBM, "mul_add rows");
static_assert(kCols * 32 == SBN, "mul_add columns");
static_assert(stage_elems<MxuArm<float>>() * 4 % 1024 == 0, "alignment");
static_assert(stage_elems<MxuArm<__nv_bfloat16>>() * 2 % 1024 == 0, "");
static_assert(stage_elems<MulAddArm<float>>() * 4 % 1024 == 0, "");
static_assert(stage_elems<MulAddArm<__nv_bfloat16>>() * 2 % 1024 == 0, "");
static_assert(stream_smem_bytes<float, MxuArm<float>>() <= 232448,
              "one CTA per SM");
static_assert(stream_smem_bytes<__nv_bfloat16, MxuArm<__nv_bfloat16>>() <=
                  232448, "one CTA per SM");
static_assert(stream_smem_bytes<float, MulAddArm<float>>() <= 232448,
              "one CTA per SM");
static_assert(stream_smem_bytes<__nv_bfloat16,
                                MulAddArm<__nv_bfloat16>>() <= 232448,
              "one CTA per SM");

// The CTA of slice c (of gridDim.x) takes the K blocks it = c * I / G
// .. (c + 1) * I / G - 1 of the I = tiles * nkb blocks, tile-major
// (tile t = m tile * n_tiles + n tile), so every CTA streams the same
// weight bytes within one K block.
__device__ __forceinline__ int64_t slice_start(int64_t c, int64_t iters,
                                               int64_t slices) {
  return c * iters / slices;
}
// The slice that holds K block it.
__device__ __forceinline__ int64_t slice_of(int64_t it, int64_t iters,
                                            int64_t slices) {
  return ((it + 1) * slices + iters - 1) / iters - 1;
}

// One slice of the iterations above.  Each piece of a tile it holds
// goes to out if the slice holds the whole tile, else to partial slot
// c + t of ws (a slot is rows x SBN floats, rows = min(M, SBM)):
// slot c + t is distinct for each (slice, tile) a slice touches, since
// slices take the blocks in order.  The ring runs across tile
// boundaries: the next tile's stages are in flight while a piece is
// stored.  The arm supplies the product.
template <typename T, class Arm>
__device__ __forceinline__ void stream_body(const T* __restrict__ x,
                                            const T* __restrict__ w,
                                            float* __restrict__ out,
                                            float* __restrict__ ws,
                                            const CUtensorMap* xmap,
                                            const CUtensorMap* wmap, int M,
                                            int K, int N, int nkb,
                                            int n_tiles, int64_t iters) {
  constexpr int BK = Arm::kBK, BOX = Arm::kBoxN;
  constexpr int STAGE = stage_elems<Arm>(), WSTAGE = BK * SBN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  float* conv = reinterpret_cast<float*>(smem + kStages * STAGE);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(conv) + Arm::kConvBytes);

  const int64_t c = blockIdx.x, slices = gridDim.x;
  const int64_t it0 = slice_start(c, iters, slices);
  const int n = (int)(slice_start(c + 1, iters, slices) - it0);
  const int slot_rows = M < SBM ? M : SBM;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const uint64_t keep = evict_last(), once = evict_first();
  // stage i, all by TMA from thread 0: w's boxes, then x's
  auto load = [&](int i) {
    if (threadIdx.x != 0) return;
    const int64_t it = it0 + i;
    const int tile = (int)(it / nkb), k0 = (int)(it % nkb) * BK;
    const int n0 = (tile % n_tiles) * SBN;
    T* st = smem + (i % kStages) * STAGE;
    uint64_t* bar = &bars[i % kStages];
    mbar_expect(bar, STAGE * (int)sizeof(T));
#pragma unroll
    for (int b = 0; b < SBN / BOX; ++b)
      tma_load(st + b * BK * BOX, wmap, n0 + b * BOX, k0, bar, once);
    tma_load(st + WSTAGE, xmap, k0, (tile / n_tiles) * SBM, bar, keep);
  };

  typename Arm::Acc acc;
  Arm::zero(acc);
  for (int i = 0; i < kStages - 1 && i < n; ++i) load(i);
  for (int i = 0; i < n; ++i) {
    // stage i has landed; every warp is done with stage i - 1, whose
    // slot the next copies take
    T* st = smem + (i % kStages) * STAGE;
    mbar_wait(&bars[i % kStages], (i / kStages) & 1);
    Arm::prepare(st, conv, i);
    __syncthreads();
    if (i + kStages - 1 < n) load(i + kStages - 1);
    const int64_t it = it0 + i;
    if (Arm::has_rows(M - (int)(it / nkb / n_tiles) * SBM))
      Arm::product(acc, st, conv, i);
    if ((it + 1) % nkb == 0 || i + 1 == n) {      // the piece ends here
      const int tile = (int)(it / nkb);
      const int m0 = (tile / n_tiles) * SBM, n0 = (tile % n_tiles) * SBN;
      const bool whole = it0 <= (int64_t)tile * nkb && (it + 1) % nkb == 0;
      float* p = whole ? out + (int64_t)m0 * N + n0
                       : ws + (c + tile) * slot_rows * SBN;
      Arm::store(acc, p, whole ? N : SBN, M - m0, N - n0);
    }
  }
}

#define STREAM_KERNEL(name, T, Arm)                                        \
  __global__ void __launch_bounds__(Arm::kThreads, 1)                     \
      name(const T* x, const T* w, float* out, float* ws,                 \
           const __grid_constant__ CUtensorMap xmap,                       \
           const __grid_constant__ CUtensorMap wmap, int M, int K, int N,  \
           int nkb, int n_tiles, int64_t iters) {                          \
    stream_body<T, Arm>(x, w, out, ws, &xmap, &wmap, M, K, N, nkb,         \
                        n_tiles, iters);                                   \
  }
STREAM_KERNEL(fma_matmul_mxu_f32, float, MxuArm<float>)
STREAM_KERNEL(fma_matmul_mxu_bf16, __nv_bfloat16, MxuArm<__nv_bfloat16>)
STREAM_KERNEL(fma_matmul_mul_add_f32, float, MulAddArm<float>)
STREAM_KERNEL(fma_matmul_mul_add_bf16, __nv_bfloat16,
              MulAddArm<__nv_bfloat16>)
#undef STREAM_KERNEL

// out at the tiles no slice holds whole: the partials of the slices
// that hold a piece of the tile, added in slice order (the same bits on
// every launch).  One CTA per (tile, 16 rows), four columns a thread.
constexpr int kReduceRows = 1024 / SBN;   // one float4 a thread
static_assert(kReduceRows * SBN / 4 == 256, "reduce block");

__global__ void __launch_bounds__(256)
fma_matmul_splitk_reduce(const float* __restrict__ ws,
                         float* __restrict__ out, int M, int N, int nkb,
                         int n_tiles, int64_t iters, int64_t slices) {
  const int tile = blockIdx.x;
  const int64_t first = slice_of((int64_t)tile * nkb, iters, slices);
  const int64_t last = slice_of((int64_t)tile * nkb + nkb - 1, iters,
                                slices);
  if (first == last) return;            // written whole by its slice
  const int slot_rows = M < SBM ? M : SBM;
  const int m0 = (tile / n_tiles) * SBM, n0 = (tile % n_tiles) * SBN;
  {
    const int e = threadIdx.x;
    const int row = blockIdx.y * kReduceRows + e / (SBN / 4);
    const int col = (e % (SBN / 4)) * 4;
    if (m0 + row >= M || n0 + col >= N) return;
    const float* p = ws + (first + tile) * slot_rows * SBN + row * SBN + col;
    float4 s = *reinterpret_cast<const float4*>(p);
    for (int64_t c = first + 1; c <= last; ++c) {
      p += (int64_t)slot_rows * SBN;    // slot c + tile
      const float4 v = *reinterpret_cast<const float4*>(p);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    *reinterpret_cast<float4*>(out + (int64_t)(m0 + row) * N + n0 + col) =
        s;
  }
}

// cuTensorMapEncodeTiled, found through the runtime's entry-point
// lookup, so that the library links no libcuda.
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

// The tensor map of a row-major (rows, cols) matrix at p, read in boxes
// of box_cols x box_rows, with the 128-byte swizzle or none.
template <typename T>
bool tensor_map(CUtensorMap* map, const void* p, int cols, int rows,
                int box_cols, int box_rows, bool swizzle) {
  const EncodeTiled encode = encode_tiled();
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t stride[1] = {(cuuint64_t)cols * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return encode != nullptr &&
         encode(map,
                sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                2, const_cast<void*>(p), dims, stride, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle ? CU_TENSOR_MAP_SWIZZLE_128B
                        : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, class Arm, typename F>
int launch_stream(F kernel, const void* x, const void* w, float* out,
                  float* ws, int M, int K, int N, int slices,
                  cudaStream_t s) {
  constexpr int V = 16 / (int)sizeof(T);
  constexpr int smem = stream_smem_bytes<T, Arm>();
  const int nkb = (K + Arm::kBK - 1) / Arm::kBK;
  const int n_tiles = (N + SBN - 1) / SBN;
  const int64_t iters = (int64_t)((M + SBM - 1) / SBM) * n_tiles * nkb;
  if (K % V || N % V || slices < 1 || slices > iters ||
      ((uintptr_t)x | (uintptr_t)w | (uintptr_t)out | (uintptr_t)ws) % 16)
    return (int)cudaErrorInvalidValue;
  // the attributes once per device (this function is one per arm)
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    ready[dev] = true;
  }
  // x and w as TMA sees them: (M, K) in boxes of kBK x SBM, (K, N) in
  // boxes of kBoxN x kBK, swizzled as the arm reads them, zeros past the
  // edges
  CUtensorMap xmap, wmap;
  if (!tensor_map<T>(&xmap, x, K, M, Arm::kBK, SBM, Arm::kSwizzle) ||
      !tensor_map<T>(&wmap, w, N, K, Arm::kBoxN, Arm::kBK, Arm::kSwizzle))
    return (int)cudaErrorInvalidValue;
  kernel<<<slices, Arm::kThreads, smem, s>>>((const T*)x, (const T*)w, out,
                                             ws, xmap, wmap, M, K, N, nkb,
                                             n_tiles, iters);
  e = cudaGetLastError();
  // every slice whole tiles: nothing to add
  if (e != cudaSuccess || (iters % slices == 0 && (iters / slices) % nkb == 0))
    return (int)e;
  const int slot_rows = M < SBM ? M : SBM;
  dim3 grid((unsigned)(iters / nkb),
            (slot_rows + kReduceRows - 1) / kReduceRows);
  fma_matmul_splitk_reduce<<<grid, 256, 0, s>>>(ws, out, M, N, nkb, n_tiles,
                                                iters, slices);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// mul_add, rows that are not whole 16-byte chunks: staged 64 x 64 tiles
// ---------------------------------------------------------------------

constexpr int kStagedThreads = 256;

template <typename T>
__device__ __forceinline__ void mul_add_staged_body(const T* __restrict__ x,
                                                    const T* __restrict__ w,
                                                    float* __restrict__ out,
                                                    int M, int K, int N) {
  constexpr int LDA = BK + 1;
  constexpr int LDB = BN;
  __shared__ float As[BM * LDA];
  __shared__ float Bs[BK * LDB];

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    stage<T, float, LDA, LDB, kStagedThreads>(x, w, As, Bs, M, K, N, m0, k0,
                                              n0);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[(ty + 16 * i) * LDA + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk * LDB + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(a[i], b[j]));
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int r = m0 + ty + 16 * i, c = n0 + tx + 16 * j;
      if (r < M && c < N) out[(int64_t)r * N + c] = acc[i][j];
    }
}

__global__ void __launch_bounds__(kStagedThreads)
fma_matmul_mul_add_staged_f32(const float* x, const float* w, float* out,
                              int M, int K, int N) {
  mul_add_staged_body<float>(x, w, out, M, K, N);
}

__global__ void __launch_bounds__(kStagedThreads)
fma_matmul_mul_add_staged_bf16(const __nv_bfloat16* x,
                               const __nv_bfloat16* w, float* out, int M,
                               int K, int N) {
  mul_add_staged_body<__nv_bfloat16>(x, w, out, M, K, N);
}

}  // namespace

// variant: 0 mxu (the weight stream), 1 mul_add (the weight stream), 2
// mxu on WMMA, 3 mul_add staged; dtype: 0 float32, 1 bfloat16 (x and
// w).  ws and slices serve the weight streams alone: the K blocks of all
// tiles are cut into `slices` equal runs, one CTA each; the pieces of
// tiles no run holds whole go to ws (slices + tiles - 1 slots of min(M,
// 128) x 256 floats) and are then added into out.
extern "C" int fma_matmul_fwd(const void* x, const void* w, void* out,
                              void* ws, int M, int K, int N, int variant,
                              int dtype, int slices, void* stream) {
  if (M < 1 || K < 1 || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  float* o = (float*)out;
  float* wsf = (float*)ws;
  if (dtype == 0) {
    const float* xf = (const float*)x;
    const float* wf = (const float*)w;
    if (variant == 0)
      return launch_stream<float, MxuArm<float>>(fma_matmul_mxu_f32, x, w, o,
                                                 wsf, M, K, N, slices, s);
    else if (variant == 1)
      return launch_stream<float, MulAddArm<float>>(
          fma_matmul_mul_add_f32, x, w, o, wsf, M, K, N, slices, s);
    else if (variant == 2)
      fma_matmul_mxu_wmma_f32<<<grid, kMxuThreads, 0, s>>>(xf, wf, o, M, K,
                                                           N);
    else if (variant == 3)
      fma_matmul_mul_add_staged_f32<<<grid, kStagedThreads, 0, s>>>(
          xf, wf, o, M, K, N);
    else
      return (int)cudaErrorInvalidValue;
  } else if (dtype == 1) {
    using bf16 = __nv_bfloat16;
    const bf16* xb = (const bf16*)x;
    const bf16* wb = (const bf16*)w;
    if (variant == 0)
      return launch_stream<bf16, MxuArm<bf16>>(fma_matmul_mxu_bf16, x, w, o,
                                               wsf, M, K, N, slices, s);
    else if (variant == 1)
      return launch_stream<bf16, MulAddArm<bf16>>(
          fma_matmul_mul_add_bf16, x, w, o, wsf, M, K, N, slices, s);
    else if (variant == 2)
      fma_matmul_mxu_wmma_bf16<<<grid, kMxuThreads, 0, s>>>(xb, wb, o, M, K,
                                                            N);
    else if (variant == 3)
      fma_matmul_mul_add_staged_bf16<<<grid, kStagedThreads, 0, s>>>(
          xb, wb, o, M, K, N);
    else
      return (int)cudaErrorInvalidValue;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
