// Row LayerNorm over the last axis, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel live2diff_tpu/ops/norm.py _layer_norm_kernel
// (body _ln_kernel): for each row of a [rows, C] bf16 tensor
//
//   mean = sum_c x / C,  var = sum_c (x - mean)^2 / C        (fp32, centred)
//   y    = (x - mean) * rsqrt(var + eps) * gamma + beta      (stored bf16)
//
// On the main path it normalises the DPT ViT tower's tokens: 24 calls per
// depth forward, rows = 577 per frame, C = 768, eps 1e-6. With
// ln_kernel_sites="all" it also takes the UNet's LayerNorms, C = 320-1280 at
// up to 32,768 rows.
//
// What bounds it: memory, and at these sizes launch latency (a [577, 768]
// call moves 1.8 MB, 0.53 us at 3.35 TB/s). The design reads each row once
// and keeps no load waiting on a reduction:
// * A group of LANES lanes owns a row, each lane NV 16-byte vectors of 8
//   bf16 held raw in registers (unpacked again for each pass: the centred
//   variance costs no second read). LANES and NV are template arguments
//   picked from C so that the lanes hold equal shares: 320 -> 8 x 5,
//   640 -> 16 x 5, 768 -> 32 x 3, 1280 -> 32 x 5; other multiples of 8 take
//   the instance with the fewest idle vector slots. Beyond C = 1280 a block
//   of 256 lanes owns a row, its warps' sums meeting in shared memory
//   (C <= 10240).
// * Every lane issues its gamma and beta vectors before its first row, and
//   row r + stride's x before row r's reductions (a grid-stride loop): the
//   cold gamma/beta round trip and the next row's DRAM latency overlap the
//   current row's shuffles.
// * The grid covers the card: CTAs of 256 threads, halved (down to one
//   warp) until the row count gives at least one CTA a SM, capped at the
//   CTAs the SMs hold at once, beyond which the loop takes the next rows.
//   The SM count and each instance's occupancy are queried once.
// Sums run in a fixed order (a lane's vectors in turn, then a butterfly), so
// repeated calls are bit-equal. Programmatic dependent launch was not tried.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxVec = 5;                               // 16-byte vectors a lane
constexpr int kBlockLanes = 256;                         // one block a row
constexpr int kMaxThreads = 256;
constexpr int kMaxGroupC = 32 * 8 * kMaxVec;             // a warp a row: C <= 1280
constexpr int kMaxC = kBlockLanes * 8 * kMaxVec;         // a block a row: C <= 10240

__device__ __forceinline__ void unpack8(const uint4& raw, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 p = __bfloat1622float2(h[k]);
    f[2 * k] = p.x;
    f[2 * k + 1] = p.y;
  }
}

// the sum of v over the LANES lanes that share a row: shuffles inside the
// group (LANES <= 32), or the block, whose warps meet in `part` in warp order
template <int LANES>
__device__ __forceinline__ float row_sum(float v, float* part) {
  constexpr int kShuffle = LANES < 32 ? LANES : 32;
#pragma unroll
  for (int o = kShuffle / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (LANES <= 32) return v;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  __syncthreads();  // the previous use of part is read
  if (lane == 0) part[warp] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < LANES / 32; ++w) t += part[w];
  return t;
}

template <int LANES, int NV>
__device__ __forceinline__ void load_row(uint4 (&dst)[NV], const __nv_bfloat16* x, long long row,
                                         int rows, int C, int lane) {
  const int nvec = C / 8;
  if (row >= rows) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * C);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = i * LANES + lane;
    if (j < nvec) dst[i] = __ldg(xr + j);
  }
}

// LANES lanes a row (8, 16, 32, or the 256-thread block), NV vectors a lane;
// two CTAs an SM up to 4 vectors a lane (128 registers), one at 5, which
// spills at 128
template <int LANES, int NV>
__global__ void __launch_bounds__(kMaxThreads, NV < 5 ? 2 : 1) layer_norm_kernel(
    const __nv_bfloat16* __restrict__ x,      // [rows, C]
    const __nv_bfloat16* __restrict__ gamma,  // [C]
    const __nv_bfloat16* __restrict__ beta,   // [C]
    __nv_bfloat16* __restrict__ y,            // [rows, C]
    int rows, int C, float eps) {
  __shared__ float part[kMaxThreads / 32];
  const int lane = threadIdx.x % LANES, slot = threadIdx.x / LANES;
  const int slots = blockDim.x / LANES, nvec = C / 8;
  const long long stride = (long long)gridDim.x * slots;
  // the first slot of this thread's warp (of the block at LANES = 256): the
  // loop runs while it has a row, so every lane that shuffles or meets at
  // __syncthreads stays in it; a slot past the last row computes on zeros
  // and stores nothing
  const int lead = LANES >= 32 ? slot : (threadIdx.x / 32) * (32 / LANES);
  long long row = (long long)blockIdx.x * slots + slot;
  long long lead_row = (long long)blockIdx.x * slots + lead;

  uint4 g[NV], b[NV], xr[NV];
  const uint4* gr = reinterpret_cast<const uint4*>(gamma);
  const uint4* br = reinterpret_cast<const uint4*>(beta);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = i * LANES + lane;
    g[i] = b[i] = xr[i] = make_uint4(0u, 0u, 0u, 0u);
    if (j < nvec) {
      g[i] = __ldg(gr + j);
      b[i] = __ldg(br + j);
    }
  }
  load_row<LANES, NV>(xr, x, row, rows, C, lane);
  const float inv_c = 1.f / (float)C;

  for (; lead_row < rows; row += stride, lead_row += stride) {
    uint4 xn[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) xn[i] = make_uint4(0u, 0u, 0u, 0u);
    load_row<LANES, NV>(xn, x, row + stride, rows, C, lane);  // in flight from here

    float f[8], sum = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (i * LANES + lane < nvec) {
        unpack8(xr[i], f);
#pragma unroll
        for (int k = 0; k < 8; ++k) sum += f[k];
      }
    }
    const float mean = row_sum<LANES>(sum, part) * inv_c;

    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (i * LANES + lane < nvec) {
        unpack8(xr[i], f);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float d = f[k] - mean;
          sq += d * d;
        }
      }
    }
    const float inv = rsqrtf(row_sum<LANES>(sq, part) * inv_c + eps);

    if (row < rows) {
      uint4* yr = reinterpret_cast<uint4*>(y + row * C);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int j = i * LANES + lane;
        if (j < nvec) {
          float gf[8], bf[8];
          unpack8(xr[i], f);
          unpack8(g[i], gf);
          unpack8(b[i], bf);
          uint4 out;
          __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
          for (int k = 0; k < 4; ++k)
            o[k] = __floats2bfloat162_rn((f[2 * k] - mean) * inv * gf[2 * k] + bf[2 * k],
                                         (f[2 * k + 1] - mean) * inv * gf[2 * k + 1] + bf[2 * k + 1]);
          yr[j] = out;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) xr[i] = xn[i];
  }
}

typedef void (*Kernel)(const __nv_bfloat16*, const __nv_bfloat16*, const __nv_bfloat16*,
                       __nv_bfloat16*, int, int, float);

template <int LANES>
Kernel instance(int nv) {
  switch (nv) {
    case 1: return layer_norm_kernel<LANES, 1>;
    case 2: return layer_norm_kernel<LANES, 2>;
    case 3: return layer_norm_kernel<LANES, 3>;
    case 4: return layer_norm_kernel<LANES, 4>;
    default: return layer_norm_kernel<LANES, 5>;
  }
}

// lanes a row and vectors a lane for C: the group (8, 16 or 32 lanes) whose
// lanes hold equal shares, or the fewest idle vector slots (the fewer lanes
// on a tie); beyond 32 x 5 vectors, the block
void pick(int C, int* lanes, int* nv) {
  const int nvec = C / 8;
  if (C > kMaxGroupC) {
    *lanes = kBlockLanes;
    *nv = (nvec + kBlockLanes - 1) / kBlockLanes;
    return;
  }
  int best_idle = 1 << 30;
  for (int l = 8; l <= 32; l *= 2) {
    const int n = (nvec + l - 1) / l;
    if (n > kMaxVec) continue;
    if (l * n - nvec < best_idle) {
      best_idle = l * n - nvec;
      *lanes = l;
      *nv = n;
    }
  }
}

// CTAs of one instance an SM holds at a block size, queried once each
int occupancy(Kernel fn, int threads, int* blocks) {
  struct Entry { Kernel fn; int threads, blocks; };
  static Entry cache[64];
  static int n = 0;
  for (int i = 0; i < n; ++i)
    if (cache[i].fn == fn && cache[i].threads == threads) {
      *blocks = cache[i].blocks;
      return (int)cudaSuccess;
    }
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, threads, 0);
  if (err != cudaSuccess) return (int)err;
  if (*blocks < 1) *blocks = 1;
  if (n < 64) cache[n++] = Entry{fn, threads, *blocks};
  return (int)cudaSuccess;
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" int layer_norm(const void* x, const void* gamma, const void* beta, void* y,
                          int rows, int C, float eps, void* stream) {
  if (rows < 0 || C <= 0 || C % 8 != 0 || C > kMaxC) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  int lanes = 32, nv = 1;
  pick(C, &lanes, &nv);
  Kernel fn = lanes == 8 ? instance<8>(nv) : lanes == 16 ? instance<16>(nv)
              : lanes == 32 ? instance<32>(nv) : instance<kBlockLanes>(nv);
  // the largest block that still gives every SM a CTA (at least one warp)
  int threads = kMaxThreads;
  if (lanes < kBlockLanes)
    while (threads > 32 && ((long long)rows * lanes + threads - 1) / threads < sms) threads /= 2;
  const long long slots = threads / lanes;
  const long long ctas = (rows + slots - 1) / slots;
  int per_sm = 1;
  int rc = occupancy(fn, threads, &per_sm);
  if (rc != (int)cudaSuccess) return rc;
  const long long cap = (long long)sms * per_sm;
  const int grid = (int)(ctas < cap ? ctas : cap);
  fn<<<grid, threads, 0, (cudaStream_t)stream>>>((const __nv_bfloat16*)x,
                                                (const __nv_bfloat16*)gamma,
                                                (const __nv_bfloat16*)beta, (__nv_bfloat16*)y,
                                                rows, C, eps);
  return (int)cudaGetLastError();
}

// one launch of an empty kernel: the floor under this file's calls, which
// sit near launch latency
extern "C" int layer_norm_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
