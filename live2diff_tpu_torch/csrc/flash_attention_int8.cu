// Flash attention with an int8 Q.K (no mask, no bias), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel live2diff_tpu/ops/flash_attention.py
// flash_self_attention_int8 (body _flash_kernel_dmajor_int8). The function:
// Q and K are quantised to symmetric int8 with one scale per quantisation
// group, s = max(max |x|, 1e-12) / 127 and code = round_half_even(x * (1/s));
// a group is block_q query rows (block_k key rows) of one (b, h), the Pallas
// kernel's tiles. The logits are the exact int32 Q.K times (s_k * s_q) *
// scale; then an fp32 softmax updated once per key group, with p taken
// against the group's max and cast to bf16, and P.V on bf16 operands with
// fp32 accumulation.
//
// Two launches a call, because a group (512 query rows; up to 4096 key rows
// at 40 columns, 320 KB of bf16) is far larger than an attention tile and a
// tile cannot find its group's scale:
// 1. quantise_kernel, the pre-pass: a group of Q or of K is split over up to
//    8 CTAs of a thread-block cluster, each a share of about 2,048 16-byte
//    vectors (8 loads a thread in flight); a cluster takes one group of the
//    larger kind or several of the smaller (at [2, 8, 4096, 40]: 8 CTAs a
//    4096-row K group, 2 a 512-row Q group, 384 CTAs in all). Each CTA
//    reduces max |x| over its share, a group's CTAs meet on the max through
//    distributed shared memory (max is exact, so the order is free), and
//    each writes its rows' codes (from registers, or read again from L2
//    past one batch) as int8 [B, H, S, DP] (the caller's DP: D rounded up to
//    16, for 16-byte TMA strides), and the group's first CTA the scale, fp32
//    [B, H, G]. The same 1/s multiply and __float2int_rn as quantize_groups,
//    so the codes are bit-equal to it.
// 2. flash_sm90_kernel<KS, true, true> (flash_sm90.cuh): the s-major walk of
//    the Hopper core with the key groups as its blocks; Q and K codes by TMA
//    into 128-byte swizzled rows, S by int8 wgmma (s32, exact) over
//    KS = ceil(D / 32) k-steps, each logit float(S) * ((s_k * s_q) * scale)
//    in fp32, p against the group's max from the first sweep. So p is
//    rounded to bf16 from the same fp32 logits and the same max as in the
//    Pallas kernel and the plain version, and the kernel differs from them
//    only in its exponential (ex2.approx) and the order of its fp32 sums.
//
// What bounds it at S = 4096: the exponentials (one per score, 16 a clock
// per SM), as for the bf16 core; the two sweeps' int8 products together
// cost the tensor cores what one bf16 sweep does. The pre-pass reads the
// bytes of Q and K once from memory (a share past one batch again from L2)
// and writes the codes.
//
// Layout: q, k, v, out [B, H, S, D] bf16, read through strides with unit
// stride along D (the model's [B, S, H, D] transposed, without a copy).

#include <cooperative_groups.h>

#include "flash_sm90.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace fsm90;

constexpr int kQuantThreads = 256;
constexpr int kMaxCluster = 8;
constexpr int kBatch = 8;                            // 16-byte loads a thread in flight
constexpr int kCtaVectors = kQuantThreads * kBatch;  // one batch of a CTA

// the caller's scratch: the codes of Q and K, [B, H, S, dp] int8 (dp, the
// row pitch, a multiple of 16 bytes and at least D), and the fp32 scales of
// their groups, [B, H, S / block]
struct Scratch {
  int8_t* q8;
  int8_t* k8;
  float* q_scales;
  float* k_scales;
  int dp;
};

__device__ __forceinline__ void unpack8(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

// how the groups of Q and of K map onto clusters: a group's rows are split
// over `split` CTAs (a power of two), so that a CTA's share is about one
// batch of loads, and a cluster of max(split_q, split_k) CTAs takes one
// group of the larger kind or several of the smaller
struct Plan {
  int cluster, split_q, split_k, clusters_q, clusters_k;
};

Plan plan(int B, int H, int Sq, int Sk, int D, int block_q, int block_k) {
  auto split = [&](int block) {
    int s = 1;
    while (s < kMaxCluster && (long long)s * kCtaVectors < (long long)block * (D / 8)) s *= 2;
    return s;
  };
  Plan p;
  p.split_q = split(block_q);
  p.split_k = split(block_k);
  p.cluster = p.split_q > p.split_k ? p.split_q : p.split_k;
  const long long nq = (long long)B * H * (Sq / block_q), nk = (long long)B * H * (Sk / block_k);
  const int per_q = p.cluster / p.split_q, per_k = p.cluster / p.split_k;
  p.clusters_q = (int)((nq + per_q - 1) / per_q);
  p.clusters_k = (int)((nk + per_k - 1) / per_k);
  return p;
}

// the pre-pass: cluster c < clusters_q takes Q's groups, the others K's, a
// group (b * H + h) * G + g in that order; x's rows are read through the
// (b, h, s) element strides, kBatch 16-byte loads a thread in flight
__global__ void __launch_bounds__(kQuantThreads) quantise_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss, int H, int Sq, int Sk, int D,
    int block_q, int block_k, int nq, int nk, Plan p, Scratch out) {
  __shared__ float warp_max[kQuantThreads / 32];
  __shared__ float cta_max;
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank(), c = blockIdx.x / p.cluster;
  const bool is_q = c < p.clusters_q;
  const int split = is_q ? p.split_q : p.split_k;
  const int G = is_q ? Sq / block_q : Sk / block_k, block = is_q ? block_q : block_k;
  const int gi = (is_q ? c : c - p.clusters_q) * (p.cluster / split) + rank / split;
  const bool live = gi < (is_q ? nq : nk);  // the last cluster of a kind may have spare CTAs
  const int bh = gi / G, g = gi % G, b = bh / H, h = bh % H;
  const bf16* src = is_q ? q + b * q_sb + h * q_sh : k + b * k_sb + h * k_sh;
  const long long ss = is_q ? q_ss : k_ss;
  const int dp = out.dp, vpr = D / 8;  // code row bytes, 16-byte vectors a row
  int8_t* dst = (is_q ? out.q8 : out.k8) + (size_t)bh * (is_q ? Sq : Sk) * dp;

  // this CTA's rows of the group, and their vectors
  const int part = rank % split, per = (block + split - 1) / split;
  const int r0 = g * block + min(part * per, block), r1 = g * block + min((part + 1) * per, block);
  const int n = live ? (r1 - r0) * vpr : 0;
  auto addr = [&](int i) {
    return reinterpret_cast<const uint4*>(src + (r0 + i / vpr) * ss + (i % vpr) * 8);
  };

  uint4 v[kBatch];
  float m = 0.f;
  for (int base = 0; base < n; base += kCtaVectors) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * kQuantThreads + threadIdx.x;
      if (i < n) v[u] = __ldg(addr(i));
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (base + u * kQuantThreads + threadIdx.x < n) {
        float f[8];
        unpack8(v[u], f);
#pragma unroll
        for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(f[j]));
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float mm = warp_max[0];
    for (int w = 1; w < kQuantThreads / 32; ++w) mm = fmaxf(mm, warp_max[w]);
    cta_max = mm;
  }
  cl.sync();  // every CTA's max is written
  // the group's max over its CTAs (max is exact: the order is free)
  float amax = 0.f;
  for (int r = rank - part; r < rank - part + split; ++r)
    amax = fmaxf(amax, *cl.map_shared_rank(&cta_max, r));
  // quantize_groups: s = max(amax, 1e-12) / 127, codes round(x * (1 / s))
  const float s = fmaxf(amax, 1e-12f) / 127.0f;
  const float inv = 1.0f / s;
  if (live && part == 0 && threadIdx.x == 0) (is_q ? out.q_scales : out.k_scales)[gi] = s;

  // the codes, 8 a vector; a share of one batch is still in registers
  for (int base = 0; base < n; base += kCtaVectors) {
    if (n > kCtaVectors) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * kQuantThreads + threadIdx.x;
        if (i < n) v[u] = __ldg(addr(i));
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = base + u * kQuantThreads + threadIdx.x;
      if (i < n) {
        float f[8];
        unpack8(v[u], f);
        uint2 packed;
        signed char* cc = reinterpret_cast<signed char*>(&packed);
#pragma unroll
        for (int j = 0; j < 8; ++j) cc[j] = (signed char)__float2int_rn(f[j] * inv);
        *reinterpret_cast<uint2*>(dst + (size_t)(r0 + i / vpr) * dp + (i % vpr) * 8) = packed;
      }
    }
  }
  if (live && dp > D)  // columns [D, DP): zeros (D % 16 == 8)
    for (int r = r0 + threadIdx.x; r < r1; r += kQuantThreads)
      *reinterpret_cast<uint2*>(dst + (size_t)r * dp + D) = make_uint2(0u, 0u);
  cl.sync();  // no CTA leaves while another may still read its max
}

// st: the (b, h, s) element strides of q and k (the first 6 of the entry's)
int quantise(const void* q, const void* k, const long long* st, int B, int H, int Sq, int Sk,
             int D, int block_q, int block_k, const Scratch& out, cudaStream_t stream) {
  const Plan p = plan(B, H, Sq, Sk, D, block_q, block_k);
  const long long ctas = ((long long)p.clusters_q + p.clusters_k) * p.cluster;
  if (ctas > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)ctas, 1, 1);
  cfg.blockDim = dim3(kQuantThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, quantise_kernel, (const bf16*)q, (const bf16*)k,
                                       st[0], st[1], st[2], st[3], st[4], st[5], H, Sq, Sk, D,
                                       block_q, block_k, B * H * (Sq / block_q),
                                       B * H * (Sk / block_k), p, out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the attention kernel over the codes of `sc`; st as the entry's
template <int KS>
int attend(const void* v, void* out, const Scratch& sc, const long long* st, int B, int H,
           int Sq, int Sk, int D, int block_q, int block_k, float scale, cudaStream_t stream) {
  using C = typename Shape<KS, true>::C;
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const long long dp = sc.dp;
  CUtensorMap tq, tk, tv;
  const bool ok =
      encode_rows(fn, &tq, true, sc.q8, (int)dp, Sq, H, B, dp, dp * Sq, dp * Sq * H, BM) &&
      encode_rows(fn, &tk, true, sc.k8, (int)dp, Sk, H, B, dp, dp * Sk, dp * Sk * H, C::BN) &&
      encode_rows(fn, &tv, false, v, D, Sk, H, B, st[8] * 2, st[7] * 2, st[6] * 2, C::BN);
  if (!ok) return (int)cudaErrorInvalidValue;

  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(flash_sm90_kernel<KS, true, true>,
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
  flash_sm90_kernel<KS, true, true><<<grid, kThreads, C::SMEM, stream>>>(
      tq, tk, tv, (bf16*)out, st[9], st[10], st[11], H, Sq, Sk, D, block_k, (int)n_tiles, scale,
      sc.q_scales, sc.k_scales, block_q);
  return (int)cudaGetLastError();
}

// the shapes both entries take: D % 8 == 0 up to 160, the blocks dividing
// the lengths, a query block of whole 128-row tiles (or all of Sq), 16-byte
// rows
bool valid(const long long* st, int n_strides, int B, int H, int Sq, int Sk, int D, int block_q,
           int block_k) {
  if (D % 8 != 0 || D <= 0 || D > 160 || Sq <= 0 || Sk <= 0 || block_q <= 0 || block_k <= 0 ||
      Sq % block_q != 0 || Sk % block_k != 0 || (block_q % BM != 0 && block_q != Sq) ||
      B <= 0 || H <= 0 || B > 65535 || H > 65535)
    return false;
  for (int i = 0; i < n_strides; ++i)
    if (st[i] % 8 != 0) return false;
  return true;
}

}  // namespace

// q, k, v, out [B, H, S, D] bf16 with unit stride along D; strides holds the
// (b, h, s) strides in elements of q, k, v and out, in that order. block_q
// and block_k divide Sq and Sk, and block_q is a multiple of 128 or Sq.
// q8, k8, q_scales, k_scales: the scratch (see Scratch), 16-byte aligned.
extern "C" int flash_attention_int8(const void* q, const void* k, const void* v, void* out,
                                    void* q8, void* k8, void* q_scales, void* k_scales, int dp,
                                    const long long* strides, int B, int H, int Sq, int Sk,
                                    int D, int block_q, int block_k, float scale,
                                    void* stream) {
  if (!valid(strides, 12, B, H, Sq, Sk, D, block_q, block_k) || dp % 16 != 0 || dp < D)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Scratch sc{(int8_t*)q8, (int8_t*)k8, (float*)q_scales, (float*)k_scales, dp};
  const int rc = quantise(q, k, strides, B, H, Sq, Sk, D, block_q, block_k, sc, st);
  if (rc != (int)cudaSuccess) return rc;
#define INT8_CASE(ks) \
  case ks: return attend<ks>(v, out, sc, strides, B, H, Sq, Sk, D, block_q, block_k, scale, st);
  switch ((D + 31) / 32) {  // the k-steps of Q.K
    INT8_CASE(1) INT8_CASE(2) INT8_CASE(3) INT8_CASE(4) INT8_CASE(5)
    default: return (int)cudaErrorInvalidValue;
  }
#undef INT8_CASE
}

// the pre-pass alone, for checking its codes and scales: arguments as above
// (the first 6 strides are read)
extern "C" int flash_attention_int8_quantize(const void* q, const void* k, void* q8, void* k8,
                                             void* q_scales, void* k_scales, int dp,
                                             const long long* strides, int B, int H, int Sq,
                                             int Sk, int D, int block_q, int block_k,
                                             void* stream) {
  if (!valid(strides, 6, B, H, Sq, Sk, D, block_q, block_k) || dp % 16 != 0 || dp < D)
    return (int)cudaErrorInvalidValue;
  const Scratch sc{(int8_t*)q8, (int8_t*)k8, (float*)q_scales, (float*)k_scales, dp};
  return quantise(q, k, strides, B, H, Sq, Sk, D, block_q, block_k, sc, (cudaStream_t)stream);
}
