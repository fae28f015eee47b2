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
// each lane holds its share of the row in registers as 16-byte vectors of 8
// bf16, NV of them, a template argument chosen from C. The mean is a
// shuffle sum; the centred variance is taken from the registers, so the
// second pass of the statistics costs no second read of memory, as in the
// TPU kernel's VMEM-resident block. Two instances of the same body:
// * one warp a row, 8 rows a block, NV = ceil(C / 256) up to 5: every C
//   that is a multiple of 8 up to 1280, the UNet's widest (NV = 3 at the
//   ViT's 768, 5 at 1280);
// * one block (8 warps) a row beyond that, the warps' sums meeting in
//   shared memory: C up to 8 x 1280 = 10240.
// Rows need no padding: a warp (or block) past the last row exits. gamma
// and beta (C bf16 each) are read through the cache.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;   // warps per block
constexpr int kMaxVec = 5;  // 16-byte vectors per lane
constexpr int kMaxWarpC = 32 * 8 * kMaxVec;            // one warp a row: C <= 1280
constexpr int kMaxC = kWarps * kMaxWarpC;               // one block a row: C <= 10240

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

// the sum of v over the threads that share a row: a warp, or (BLOCK) the
// block, whose warps meet in `part` in warp order
template <bool BLOCK>
__device__ __forceinline__ float row_sum(float v, float* part) {
  v = warp_sum(v);
  if (!BLOCK) return v;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  __syncthreads();  // the previous use of part is read
  if (lane == 0) part[warp] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += part[w];
  return t;
}

// NV vectors a lane; BLOCK: one block a row, else one warp a row
template <int NV, bool BLOCK>
__global__ void __launch_bounds__(kWarps * 32) layer_norm_kernel(
    const __nv_bfloat16* __restrict__ x,      // [rows, C]
    const __nv_bfloat16* __restrict__ gamma,  // [C]
    const __nv_bfloat16* __restrict__ beta,   // [C]
    __nv_bfloat16* __restrict__ y,            // [rows, C]
    int rows, int C, float eps) {
  __shared__ float part[kWarps];
  constexpr int kLanes = BLOCK ? kWarps * 32 : 32;  // threads that share a row
  const int lane = BLOCK ? threadIdx.x : threadIdx.x % 32;
  const int row = BLOCK ? blockIdx.x : blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;  // the whole warp (or block) leaves together
  const int nvec = C / 8;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * C);

  float v[NV][8];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = i * kLanes + lane;
    if (j < nvec) {
      unpack8(xr[j], v[i]);
#pragma unroll
      for (int k = 0; k < 8; ++k) sum += v[i][k];
    }
  }
  const float inv_c = 1.f / (float)C;
  const float mean = row_sum<BLOCK>(sum, part) * inv_c;

  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (i * kLanes + lane < nvec) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        v[i][k] -= mean;
        sq += v[i][k] * v[i][k];
      }
    }
  }
  const float inv = rsqrtf(row_sum<BLOCK>(sq, part) * inv_c + eps);

  const uint4* gr = reinterpret_cast<const uint4*>(gamma);
  const uint4* br = reinterpret_cast<const uint4*>(beta);
  uint4* yr = reinterpret_cast<uint4*>(y + (size_t)row * C);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = i * kLanes + lane;
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

template <bool BLOCK>
using Kernel = void (*)(const __nv_bfloat16*, const __nv_bfloat16*, const __nv_bfloat16*,
                        __nv_bfloat16*, int, int, float);

template <bool BLOCK>
Kernel<BLOCK> pick(int nv) {
  switch (nv) {
    case 1: return layer_norm_kernel<1, BLOCK>;
    case 2: return layer_norm_kernel<2, BLOCK>;
    case 3: return layer_norm_kernel<3, BLOCK>;
    case 4: return layer_norm_kernel<4, BLOCK>;
    default: return layer_norm_kernel<5, BLOCK>;
  }
}

}  // namespace

extern "C" int layer_norm(const void* x, const void* gamma, const void* beta, void* y,
                          int rows, int C, float eps, void* stream) {
  if (rows < 0 || C <= 0 || C % 8 != 0 || C > kMaxC) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  const auto* xb = (const __nv_bfloat16*)x;
  const auto* gb = (const __nv_bfloat16*)gamma;
  const auto* bb = (const __nv_bfloat16*)beta;
  auto* yb = (__nv_bfloat16*)y;
  if (C <= kMaxWarpC) {
    const int grid = (rows + kWarps - 1) / kWarps;
    pick<false>((C + 255) / 256)<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
        xb, gb, bb, yb, rows, C, eps);
  } else {
    pick<true>((C + kWarps * 256 - 1) / (kWarps * 256))<<<rows, kWarps * 32, 0,
                                                          (cudaStream_t)stream>>>(
        xb, gb, bb, yb, rows, C, eps);
  }
  return (int)cudaGetLastError();
}
