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
// What bounds them, and the design (split-KV, one launch: a CTA per
// chunk of positions of a (lane, kv head), the last CTA folding the
// chunks in order): decode_split.cuh, the body this file shares with
// the paged kernels (K1, K4).  Here a row's place is arithmetic
// (DenseRows).  K3 and K5 read only positions < min(len, S); K6a and
// K6b read all S and give the same bits; scales of dead positions are
// read only by K6b.
//
// C interface (loaded with ctypes): decode_attention_dense_fwd returns
// the cudaError_t of the launch; it allocates nothing and launches on
// the stream it is given.

#include "decode_split.cuh"

namespace {

#define DENSE_KERNEL(name, T, KV, MASKED)                                   \
  __global__ void __launch_bounds__(THREADS, 2)                             \
      name(const T* q, const KV* k, const float* ks, const KV* v,           \
           const float* vs, const int32_t* lens, T* out, float* ws_ml,      \
           float* ws_acc, int* counters, int H, int Hkv, int S, int D,      \
           int qblock, int ch, float scale) {                               \
    split_body<T, KV, MASKED>(q, k, ks, v, vs, lens, DenseRows{S}, out,     \
                              ws_ml, ws_acc, counters, H, Hkv, S, D,        \
                              qblock, ch, scale);                           \
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
