// GroupNorm (+ SiLU or ReLU) over [B, T, C] bf16, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel live2diff_tpu/ops/norm.py _group_norm_kernel
// (body _kernel): per-sample fp32 statistics of each group of C / G
// channels over all T rows, the centred (two-pass) variance, y = (x - mean)
// * (rstd * gamma) + beta, then the activation, written in bf16.
//
// The Pallas kernel holds a whole [T, C] sample in VMEM (grid (B,)): at
// [4096, 320] that is 2.6 MB, far beyond an SM's 227 KB of shared memory,
// and B = 2 samples would fill 2 of 132 SMs. What bounds the function is
// bytes: x read (twice: statistics, then normalisation) and y written. So
// the rows are cut into chunks spread over many blocks, in three launches:
//   1. gn_stats_kernel: per (sample, chunk), each group's mean and centred
//      sum of squares M2 over the chunk's rows (two passes over the chunk,
//      the second from L1/L2), in fp32;
//   2. gn_merge_kernel: per (sample, group), the chunks merged with Chan's
//      parallel formula, which like the two-pass form does not cancel when
//      |mean| >> std: a few lanes of a warp each merge a strided share of
//      the chunks, then a shuffle tree merges the lanes (one thread per
//      group took 33 us a call on an H100, bound by the latency of its
//      dependent loads);
//      writes mean and rsqrt(var + eps);
//   3. gn_apply_kernel: per (sample, chunk), the affine and activation.
// Every sum runs in a fixed order: the result does not change from run to
// run. Threads own 16-byte vectors of 8 channels; C must be a multiple of
// 8 and at most 3072, G at most 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxC = 3072;
constexpr int kMaxG = 256;
// the per-(slot, channel) partial sums of gn_stats_kernel: slots * C is at
// most 8 * 256 when C / 8 <= 256 threads, C when wider
constexpr int kRed = kMaxC > 8 * kThreads ? kMaxC : 8 * kThreads;

__device__ __forceinline__ void load8(const bf16* p, float (&f)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ void store8(bf16* p, const float (&f)[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// Thread layout of the stats kernel: V = C / 8 vector columns; when V <=
// 256 the block holds P = 256 / V "slots" of V threads, slot s taking rows
// s, s + P, ...; when V > 256, one slot whose threads take columns t and
// t + 256.
__global__ void __launch_bounds__(kThreads) gn_stats_kernel(
    const bf16* __restrict__ x, float2* __restrict__ stats, int T, int C, int G, int rows) {
  __shared__ float red[kRed];
  __shared__ float gmean[kMaxG];
  const int chunk = blockIdx.x, b = blockIdx.y, nchunks = gridDim.x;
  const int V = C / 8, P = V < kThreads ? kThreads / V : 1, cg = C / G;
  const int tid = threadIdx.x, slot = tid / V;
  const int r0 = chunk * rows, r1 = min(r0 + rows, T);
  const bf16* xb = x + (size_t)b * T * C;
  const float n = (float)((r1 - r0) * cg);

  // pass 1: sums -> each group's mean over the chunk
  if (slot < P) {
    for (int v = tid % V; v < V; v += kThreads) {
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int r = r0 + slot; r < r1; r += P) {
        float f[8];
        load8(xb + (size_t)r * C + v * 8, f);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] += f[j];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) red[slot * C + v * 8 + j] = acc[j];
    }
  }
  __syncthreads();
  for (int g = tid; g < G; g += kThreads) {
    float s = 0.f;
    for (int p = 0; p < P; ++p)
      for (int c = g * cg; c < (g + 1) * cg; ++c) s += red[p * C + c];
    gmean[g] = s / n;
  }
  __syncthreads();

  // pass 2: centred sums of squares
  if (slot < P) {
    for (int v = tid % V; v < V; v += kThreads) {
      float mean8[8], acc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mean8[j] = gmean[(v * 8 + j) / cg];
        acc[j] = 0.f;
      }
      for (int r = r0 + slot; r < r1; r += P) {
        float f[8];
        load8(xb + (size_t)r * C + v * 8, f);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float d = f[j] - mean8[j];
          acc[j] += d * d;
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) red[slot * C + v * 8 + j] = acc[j];
    }
  }
  __syncthreads();
  for (int g = tid; g < G; g += kThreads) {
    float s = 0.f;
    for (int p = 0; p < P; ++p)
      for (int c = g * cg; c < (g + 1) * cg; ++c) s += red[p * C + c];
    stats[((size_t)b * nchunks + chunk) * G + g] = make_float2(gmean[g], s);
  }
}

// Chan's parallel formula: (n, mean, m2) += (nb, mb, m2b)
__device__ __forceinline__ void chan_merge(float& n, float& mean, float& m2, float nb, float mb,
                                           float m2b) {
  if (nb == 0.f) return;
  if (n == 0.f) {
    n = nb;
    mean = mb;
    m2 = m2b;
    return;
  }
  const float nt = n + nb;
  const float delta = mb - mean;
  mean += delta * (nb / nt);
  m2 += m2b + delta * delta * (n * nb / nt);
  n = nt;
}

// per sample: each group's chunks merged by L lanes of one warp (lane l
// takes chunks l, l + L, ... in order), then the L partials merged by
// shuffles in a fixed tree; writes mean and rsqrt(var + eps)
__global__ void __launch_bounds__(kThreads) gn_merge_kernel(
    const float2* __restrict__ stats, float2* __restrict__ mean_rstd, int T, int C, int G,
    int rows, int nchunks, float eps) {
  const int b = blockIdx.x, cg = C / G;
  int lanes = 1;  // a power of two, at most 32, with G * lanes <= 256
  while (lanes < 32 && G * lanes * 2 <= kThreads) lanes *= 2;
  const int g = threadIdx.x / lanes, l = threadIdx.x % lanes;
  float n = 0.f, mean = 0.f, m2 = 0.f;
  if (g < G) {
    for (int i = l; i < nchunks; i += lanes) {
      const float2 s = stats[((size_t)b * nchunks + i) * G + g];
      const float nb = (float)((min((i + 1) * rows, T) - i * rows) * cg);
      chan_merge(n, mean, m2, nb, s.x, s.y);
    }
  }
  for (int o = lanes / 2; o > 0; o >>= 1) {
    const float nb = __shfl_xor_sync(0xffffffffu, n, o);
    const float mb = __shfl_xor_sync(0xffffffffu, mean, o);
    const float m2b = __shfl_xor_sync(0xffffffffu, m2, o);
    // both lanes of a pair end with the same value: lower lane's data first
    if (l & o) {
      float n2 = nb, mean2 = mb, m22 = m2b;
      chan_merge(n2, mean2, m22, n, mean, m2);
      n = n2;
      mean = mean2;
      m2 = m22;
    } else {
      chan_merge(n, mean, m2, nb, mb, m2b);
    }
  }
  if (g < G && l == 0) mean_rstd[(size_t)b * G + g] = make_float2(mean, rsqrtf(m2 / n + eps));
}

// per (sample, chunk): y = (x - mean) * (rstd * gamma) + beta, activation
__global__ void __launch_bounds__(kThreads) gn_apply_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ gamma, const bf16* __restrict__ beta,
    const float2* __restrict__ mean_rstd, bf16* __restrict__ out, int T, int C, int G, int rows,
    int act) {
  __shared__ float ch_mean[kMaxC], ch_scale[kMaxC], ch_shift[kMaxC];
  const int chunk = blockIdx.x, b = blockIdx.y, cg = C / G;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float2 mr = mean_rstd[(size_t)b * G + c / cg];
    ch_mean[c] = mr.x;
    ch_scale[c] = mr.y * __bfloat162float(gamma[c]);
    ch_shift[c] = __bfloat162float(beta[c]);
  }
  __syncthreads();
  const int V = C / 8;
  const int r0 = chunk * rows, r1 = min(r0 + rows, T);
  const size_t base = ((size_t)b * T + r0) * C;
  const int n = (r1 - r0) * V;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const size_t off = base + (size_t)(i / V) * C + (i % V) * 8;
    const int c0 = (i % V) * 8;
    float f[8];
    load8(x + off, f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float y = (f[j] - ch_mean[c0 + j]) * ch_scale[c0 + j] + ch_shift[c0 + j];
      if (act == 1) {
        y = y / (1.f + expf(-y));  // SiLU
      } else if (act == 2) {
        y = fmaxf(y, 0.f);  // ReLU
      }
      f[j] = y;
    }
    store8(out + off, f);
  }
}

}  // namespace

// x, out [B, T, C] bf16 contiguous; gamma, beta [C] bf16; stats is scratch of
// B * ceil(T / rows) * G float2, mean_rstd of B * G float2. act: 0 none,
// 1 SiLU, 2 ReLU.
extern "C" int group_norm(const void* x, const void* gamma, const void* beta, void* out,
                          void* stats, void* mean_rstd, int B, int T, int C, int G, int rows,
                          int act, float eps, void* stream) {
  if (C <= 0 || C % 8 != 0 || C > kMaxC || G <= 0 || G > kMaxG || C % G != 0 || T <= 0 ||
      rows <= 0 || B <= 0 || B > 65535 || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nchunks = (T + rows - 1) / rows;
  const dim3 grid(nchunks, B);
  gn_stats_kernel<<<grid, kThreads, 0, st>>>((const bf16*)x, (float2*)stats, T, C, G, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_merge_kernel<<<B, kThreads, 0, st>>>((const float2*)stats, (float2*)mean_rstd, T, C, G,
                                          rows, nchunks, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_apply_kernel<<<grid, kThreads, 0, st>>>((const bf16*)x, (const bf16*)gamma,
                                             (const bf16*)beta, (const float2*)mean_rstd,
                                             (bf16*)out, T, C, G, rows, act);
  return (int)cudaGetLastError();
}
