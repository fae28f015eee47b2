// Flash scaled-dot-product attention (no mask, no bias), for Hopper (sm_90a):
// the two host entries of one device core, flash_sm90_kernel in
// flash_sm90.cuh (warp-specialised, TMA into a ring of stages, wgmma, S, P
// and O in registers; its note says how and why).
//
// * flash_attention, the d-major entry, replaces the Pallas TPU kernel
//   live2diff_tpu/ops/flash_attention.py flash_self_attention_dmajor (body
//   _flash_kernel_dmajor): softmax(scale q k^T) v with an online softmax,
//   fp32 running max / sum / accumulator, bf16 operands with fp32
//   accumulation, p cast to bf16 before the PV product, and the l == 0
//   guard at the end. Unlike the TPU kernel it takes any Sq and Sk, so it
//   serves spatial self-attention (S = 4096, 1024, 256, 64 at 512x512),
//   cross-attention over the 77 text tokens, the DPT's ViT, and the warmup
//   motion attention over 8 frames with the spatial positions folded into
//   the batch. q [B, Sq, H, D], k and v [B, Sk, H, D], out [B, Sq, H, D],
//   bf16 and contiguous (the model's layout, read in place).
// * flash_attention_smajor replaces flash_self_attention (body _flash_kernel,
//   grid (B, H, Sq / block_q, Sk / block_k)): the same function over
//   [B, H, S, D] tensors read through strides (a transposed view of the
//   model's [B, S, H, D] needs no copy), with the Pallas kernel's blocking:
//   the running max, sum and accumulator are updated once per key block of
//   block_k keys, and p is taken against the max of the whole block.
//
// D must be a multiple of 8 (16-byte rows) and at most 160. Each call
// encodes three TMA tensor maps on the host (cuTensorMapEncodeTiled, taken
// through cudaGetDriverEntryPoint, so nothing links against libcuda); the
// time spent encoding is summed for flash_attention_encode_stats.

#include <chrono>

#include "flash_sm90.cuh"

namespace {

using namespace fsm90;

long long g_encode_ns = 0, g_encode_calls = 0;

// a (D, S, H, B) map of bf16 with element strides (s, h, b), boxes of 64
// columns by `rows` rows
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int D, int S, int H, int B,
            long long ss, long long sh, long long sb, int rows) {
  return encode_rows(fn, map, false, ptr, D, S, H, B, ss * 2, sh * 2, sb * 2, rows);
}

// st: the (b, h, s) element strides of q, k, v and out, in that order
template <int KS, bool SMAJOR>
int launch(const void* q, const void* k, const void* v, void* out, const long long* st, int B,
           int H, int Sq, int Sk, int D, int block_k, float scale, cudaStream_t stream) {
  using C = typename Shape<KS, false>::C;
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv;
  const auto t0 = std::chrono::steady_clock::now();
  const bool ok = encode(fn, &tq, q, D, Sq, H, B, st[2], st[1], st[0], BM) &&
                  encode(fn, &tk, k, D, Sk, H, B, st[5], st[4], st[3], C::BN) &&
                  encode(fn, &tv, v, D, Sk, H, B, st[8], st[7], st[6], C::BN);
  g_encode_ns +=
      std::chrono::duration_cast<std::chrono::nanoseconds>(std::chrono::steady_clock::now() - t0)
          .count();
  ++g_encode_calls;
  if (!ok) return (int)cudaErrorInvalidValue;

  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(flash_sm90_kernel<KS, SMAJOR>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const long long n_tiles = (long long)((Sq + BM - 1) / BM) * H * B;
  if (n_tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int grid = (int)(n_tiles < sms ? n_tiles : sms);  // persistent: one CTA a SM
  flash_sm90_kernel<KS, SMAJOR><<<grid, kThreads, C::SMEM, stream>>>(
      tq, tk, tv, (bf16*)out, st[9], st[10], st[11], H, Sq, Sk, D, block_k, (int)n_tiles,
      scale * 1.4426950408889634f, nullptr, nullptr, Sq);
  return (int)cudaGetLastError();
}

template <bool SMAJOR>
int dispatch(const void* q, const void* k, const void* v, void* out, const long long* st, int B,
             int H, int Sq, int Sk, int D, int block_k, float scale, void* stream) {
  // the head widths the wrappers take: D % 8 == 0 up to 160, not 104-112 or 136-144
  if (D % 8 != 0 || D <= 0 || D > 160 || (D + 15) / 16 == 7 || (D + 15) / 16 == 9 || Sq <= 0 ||
      Sk <= 0 || block_k <= 0 || Sk % block_k != 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 12; ++i)
    if (st[i] % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define FLASH_CASE(ks) \
  case ks: return launch<ks, SMAJOR>(q, k, v, out, st, B, H, Sq, Sk, D, block_k, scale, s);
  switch ((D + 15) / 16) {  // the k-steps of Q.K
    FLASH_CASE(1) FLASH_CASE(2) FLASH_CASE(3) FLASH_CASE(4)
    FLASH_CASE(5) FLASH_CASE(6) FLASH_CASE(8) FLASH_CASE(10)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}

}  // namespace

extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out,
                               int B, int H, int Sq, int Sk, int D, float scale,
                               void* stream) {
  const long long hd = (long long)H * D;
  const long long st[12] = {Sq * hd, D, hd, Sk * hd, D, hd, Sk * hd, D, hd, Sq * hd, D, hd};
  return dispatch<false>(q, k, v, out, st, B, H, Sq, Sk, D, Sk, scale, stream);
}

// q, k, v, out [B, H, S, D] bf16 with unit stride along D; strides holds the
// (b, h, s) strides in elements of q, k, v and out, in that order. block_k
// must divide Sk (the caller's pick_block).
extern "C" int flash_attention_smajor(const void* q, const void* k, const void* v, void* out,
                                      const long long* strides, int B, int H, int Sq, int Sk,
                                      int D, int block_k, float scale, void* stream) {
  return dispatch<true>(q, k, v, out, strides, B, H, Sq, Sk, D, block_k, scale, stream);
}

// host ns spent encoding tensor maps, and the number of launches that did,
// since the library was loaded
extern "C" long long flash_attention_encode_stats(long long* calls) {
  *calls = g_encode_calls;
  return g_encode_ns;
}
