// Row LayerNorm over the last axis, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel live2diff_tpu/ops/norm.py _layer_norm_kernel
// (body _ln_kernel): for each row of a [rows, C] bf16 tensor
//
//   mean = sum_c x / C,  var = sum_c (x - mean)^2 / C        (fp32, centred)
//   y    = (x - mean) * rsqrt(var + eps) * gamma + beta      (stored bf16)
//
// On the main path it normalises the DPT ViT tower's tokens: 24 calls per
// depth forward, rows = 577 per frame, C = 768, eps 1e-6.
//
// What bounds it: memory, and at these sizes launch latency (a [577, 768]
// call moves 1.8 MB, 0.53 us at 3.35 TB/s). The design reads each row once:
// one warp per row, each lane holding its share of the row in registers as
// 16-byte vectors of 8 bf16 (three a lane at C = 768). The mean is a warp
// shuffle sum; the centred variance is taken from the registers, so the
// second pass of the statistics costs no second read of memory, as in the
// TPU kernel's VMEM-resident block. Rows need no padding: a warp past the
// last row exits. gamma and beta (C bf16 each) are read through the cache.
// Any C that is a multiple of 8 up to 1024 is taken.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;   // rows per block
constexpr int kMaxVec = 4;  // 16-byte vectors per lane: C <= 32 * 8 * 4
constexpr int kMaxC = 32 * 8 * kMaxVec;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void unpack8(const uint4& raw, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 p = __bfloat1622float2(h[k]);
    f[2 * k] = p.x;
    f[2 * k + 1] = p.y;
  }
}

__global__ void __launch_bounds__(kWarps * 32) layer_norm_kernel(
    const __nv_bfloat16* __restrict__ x,      // [rows, C]
    const __nv_bfloat16* __restrict__ gamma,  // [C]
    const __nv_bfloat16* __restrict__ beta,   // [C]
    __nv_bfloat16* __restrict__ y,            // [rows, C]
    int rows, int C, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;  // the whole warp leaves together
  const int nvec = C / 8;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * C);

  float v[kMaxVec][8];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    const int j = i * 32 + lane;
    if (j < nvec) {
      unpack8(xr[j], v[i]);
#pragma unroll
      for (int k = 0; k < 8; ++k) sum += v[i][k];
    }
  }
  const float inv_c = 1.f / (float)C;
  const float mean = warp_sum(sum) * inv_c;

  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    if (i * 32 + lane < nvec) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        v[i][k] -= mean;
        sq += v[i][k] * v[i][k];
      }
    }
  }
  const float inv = rsqrtf(warp_sum(sq) * inv_c + eps);

  const uint4* gr = reinterpret_cast<const uint4*>(gamma);
  const uint4* br = reinterpret_cast<const uint4*>(beta);
  uint4* yr = reinterpret_cast<uint4*>(y + (size_t)row * C);
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    const int j = i * 32 + lane;
    if (j < nvec) {
      float g[8], b[8];
      unpack8(gr[j], g);
      unpack8(br[j], b);
      uint4 out;
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        o[k] = __floats2bfloat162_rn(v[i][2 * k] * inv * g[2 * k] + b[2 * k],
                                     v[i][2 * k + 1] * inv * g[2 * k + 1] + b[2 * k + 1]);
      yr[j] = out;
    }
  }
}

}  // namespace

extern "C" int layer_norm(const void* x, const void* gamma, const void* beta, void* y,
                          int rows, int C, float eps, void* stream) {
  if (rows < 0 || C <= 0 || C % 8 != 0 || C > kMaxC) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  const int grid = (rows + kWarps - 1) / kWarps;
  layer_norm_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)gamma, (const __nv_bfloat16*)beta,
      (__nv_bfloat16*)y, rows, C, eps);
  return (int)cudaGetLastError();
}
