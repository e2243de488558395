// Paged decode attention for Hopper (sm_90a): K1 over pools in q's
// dtype and K4 over int8 pools with f32 scale pools, one template.
//
// Replaces, in src/repro/kernels/decode_attention/kernel.py:
//   * decode_attention_paged_pallas (K1): pl.pallas_call, grid (B, H,
//     T), one page per grid step, the page index translated through a
//     scalar-prefetched block table and clamped to the lane's last live
//     page, f32 online softmax in VMEM;
//   * decode_attention_paged_q8_pallas (K4): the same grid over int8
//     pages and (ps/qblock, 1) f32 scale pages fetched through the same
//     block-table entry, dequantized after the VMEM load.
//
// What bounds them, and the design: decode_split.cuh, the split-KV body
// this file shares with the dense kernels (K3, K5).  A lane's T pages
// are one logical cache of S = T ps positions, cut into chunks of CH
// positions (grid (B * Hkv, ceil(T ps / CH))), the last CTA of each
// (lane, kv head) folding the chunks in order.  Only where a row lives
// differs (PagedRows): row pos of (b, kvh) is row pos % ps of page
// bt[b, pos / ps], and its scale row (pos % ps) / qblock of the same
// page's scale rows.  A CTA reads the table entries of its chunk's live
// rows once, before its copies; a chunk may straddle pages, and any page
// size works, since the walk goes by position.  So on the same logical
// cache K1 gives the bits of K3 over gather_pages(pools, bt), and K4
// those of K5 at the same qblock.
//
// Semantics: the length is clamped to [0, T ps]; only positions below it
// are read, so table slots past the live length (the serve points them
// at its scratch page) are never read, and a lane of length 0 writes 0.
// A sliding-window lane's rotated table works too: once every slot is
// live the softmax does not depend on the order of its keys.  qblock = 1
// is the model's per-(token, head) scale pool (P, Hkv, ps, 1); the
// reference kernel's own is qblock = 16 for 16-token pages.
//
// C interface (loaded with ctypes): decode_attention_paged_fwd returns
// the cudaError_t of the launch; it allocates nothing and launches on
// the stream it is given.

#include "decode_split.cuh"

namespace {

#define PAGED_KERNEL(name, T, KV)                                           \
  __global__ void __launch_bounds__(THREADS, 2)                             \
      name(const T* q, const KV* k, const float* ks, const KV* v,           \
           const float* vs, const int32_t* lens, const int32_t* bt,         \
           T* out, float* ws_ml, float* ws_acc, int* counters, int H,       \
           int Hkv, int T_width, int ps, int D, int qblock, int ch,         \
           float scale) {                                                   \
    split_body<T, KV, false>(q, k, ks, v, vs, lens,                         \
                             PagedRows{bt, T_width, ps}, out, ws_ml,        \
                             ws_acc, counters, H, Hkv, T_width * ps, D,     \
                             qblock, ch, scale);                            \
  }
PAGED_KERNEL(decode_paged_f32, float, float)
PAGED_KERNEL(decode_paged_bf16, __nv_bfloat16, __nv_bfloat16)
PAGED_KERNEL(decode_paged_q8_f32, float, int8_t)
PAGED_KERNEL(decode_paged_q8_bf16, __nv_bfloat16, int8_t)
#undef PAGED_KERNEL

template <typename T, typename KV>
using Kernel = void (*)(const T*, const KV*, const float*, const KV*,
                        const float*, const int32_t*, const int32_t*, T*,
                        float*, float*, int*, int, int, int, int, int, int,
                        int, float);

// one launch (at the serve's shapes it needs less shared memory than
// the default 48 KB, so allow_smem never raises the limit)
template <typename T, typename KV>
cudaError_t launch(Kernel<T, KV> kernel, int* allowed, const void* q,
                   const void* k, const float* ks, const void* v,
                   const float* vs, const int32_t* lens, const int32_t* bt,
                   void* out, float* ws_ml, float* ws_acc, int* counters,
                   int B, int H, int Hkv, int T_width, int ps, int D,
                   int qblock, int ch, float scale, cudaStream_t stream) {
  const int smem = (int)smem_bytes<KV>(H / Hkv, D, ch);
  cudaError_t err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  dim3 grid(B * Hkv, (T_width * ps + ch - 1) / ch);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k), ks,
      static_cast<const KV*>(v), vs, lens, bt, static_cast<T*>(out), ws_ml,
      ws_acc, counters, H, Hkv, T_width, ps, D, qblock, ch, scale);
  return cudaGetLastError();
}

#define PICK(T, KV, name)                                                   \
  {                                                                         \
    static int allowed[64] = {};                                            \
    return launch<T, KV>(name, allowed, q, k_pages, ks, v_pages, vs, lens,  \
                         bt, out, ws_ml, ws_acc, counters, B, H, Hkv,       \
                         T_width, ps, D, qblock, ch, scale, s);             \
  }

}  // namespace

// k_scale_pages/v_scale_pages and qblock are read only when kv_int8 is
// 1: the pools are then int8 (P, Hkv, ps, D) and the scale pools f32
// (P, Hkv, ps/qblock, 1); otherwise the pools have q's dtype.
// block_tables is (B, T_width) int32.  ch (32 or 64) is the chunk
// length; ws_ml and ws_acc hold B * Hkv * ceil(T_width ps / ch) *
// (H / Hkv) * 2 and ... * D floats; counters B * Hkv ints, 0 before the
// first launch (each launch leaves them 0).
extern "C" int decode_attention_paged_fwd(
    const void* q, const void* k_pages, const void* k_scale_pages,
    const void* v_pages, const void* v_scale_pages, const void* block_tables,
    const void* kv_lengths, void* out, void* ws_ml_p, void* ws_acc_p,
    void* counters_p, int B, int H, int Hkv, int ps, int D, int T_width,
    int qblock, int ch, float scale, int kv_int8, int dtype, void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > MAX_GROUP || D <= 0 ||
      D > MAX_D || D % 16 != 0 || ps <= 0 || T_width <= 0 ||
      T_width > (1 << 30) / ps || (ch != 32 && ch != 64) ||
      (T_width * ps + ch - 1) / ch > 65535)
    return (int)cudaErrorInvalidValue;
  if (kv_int8 && (qblock <= 0 || ps % qblock != 0 || !k_scale_pages ||
                  !v_scale_pages))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)k_pages | (uintptr_t)v_pages | (uintptr_t)ws_acc_p) % 16)
    return (int)cudaErrorInvalidValue;
  if (!kv_int8) qblock = 1;
  const int32_t* bt = static_cast<const int32_t*>(block_tables);
  const int32_t* lens = static_cast<const int32_t*>(kv_lengths);
  const float* ks = static_cast<const float*>(k_scale_pages);
  const float* vs = static_cast<const float*>(v_scale_pages);
  float* ws_ml = static_cast<float*>(ws_ml_p);
  float* ws_acc = static_cast<float*>(ws_acc_p);
  int* counters = static_cast<int*>(counters_p);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  switch ((dtype << 1) | kv_int8) {
    case 0: PICK(float, float, decode_paged_f32)
    case 1: PICK(float, int8_t, decode_paged_q8_f32)
    case 2: PICK(bf16, bf16, decode_paged_bf16)
    case 3: PICK(bf16, int8_t, decode_paged_q8_bf16)
    default: return (int)cudaErrorInvalidValue;
  }
}
