// Stream window attention over the int8 KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel live2diff_tpu/ops/stream_attention.py
// stream_window_attention_kernel_int8 (body _kernel_int8). Per (denoising
// step s, head h, spatial position p) the new frame's query attends over
// the 16 slots of its temporal window:
//
//   logit[w] = scale * sum_c q[s,p,c] * k8[s,w,c,p] * k_scale[s,w,c] + extra[s,w,h,p]
//   prob     = softmax_w(logit)                                  (fp32)
//   out[s,p,c] = sum_w prob[w] * (v8[s,w,c,p] * v_scale[s,w,c] + pe_v[s,w,c])
//
// for the channels c of head h. `extra` holds the positional-encoding
// logits plus the visibility bias (0 / -inf), computed outside the kernel;
// the sink slots are always visible, so no row is all -inf.
//
// What bounds it: memory. Each frame reads the whole int8 cache once, about
// 1.5 GB over the 40 calls of a 512x512 stream step, and does only ~6 flops
// per byte read. The design reads every cache byte exactly once and keeps
// the softmax state in registers. A block owns 32 consecutive positions of
// one (step, head): the lanes of a warp are the positions, so each slot
// load of a channel is one coalesced access of the positions-minor cache
// layout [steps, 2, window, C, HW], and its 8 warps split the head's
// channels, so even the small levels (HW = 256, 64) put enough threads on
// the card. Partial logits meet in shared memory; the query and output
// tiles pass through shared memory so their global accesses coalesce too.
// The per-(slot, channel) scales and pe_v rows of the head sit in shared
// memory. Every HW is taken, including HW = 64 (the 8x8 latent level).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWindow = 16;
constexpr int kPos = 32;     // positions per block, one per lane
constexpr int kGroups = 8;   // channel groups, one per warp
constexpr int kThreads = kPos * kGroups;

__global__ void __launch_bounds__(kThreads) stream_attention_int8_kernel(
    const __nv_bfloat16* __restrict__ q,  // [S, HW, C]  (q + its PE row)
    const int8_t* __restrict__ cache,     // [S, 2, W, C, HW]
    const float* __restrict__ scales,     // [S, 2, W, C]
    const float* __restrict__ extra,      // [S, W, heads, HW]
    const float* __restrict__ pe_v,       // [S, W, C]
    __nv_bfloat16* __restrict__ out,      // [S, HW, C]
    int C, int HW, int heads, float scale) {
  const int tid = threadIdx.x, lane = tid % 32, g = tid / 32;
  const int p0 = blockIdx.x * kPos, p = p0 + lane;
  const int h = blockIdx.y, s = blockIdx.z;
  const int dh = C / heads, ld = dh + 1;  // odd row pitch: conflict-free columns
  const bool valid = p < HW;

  extern __shared__ float smem[];
  float* ks = smem;                          // [W][dh] K scale x softmax scale
  float* vs = ks + kWindow * dh;             // [W][dh] V scale
  float* pv = vs + kWindow * dh;             // [W][dh] pe_v
  float* part = pv + kWindow * dh;           // [G][W][kPos] partial logits
  float* tile = part + kGroups * kWindow * kPos;  // [kPos][ld] q, then out
  for (int i = tid; i < kWindow * dh; i += kThreads) {
    const int w = i / dh;
    const int c = h * dh + i % dh;
    ks[i] = scales[((size_t)(s * 2 + 0) * kWindow + w) * C + c] * scale;
    vs[i] = scales[((size_t)(s * 2 + 1) * kWindow + w) * C + c];
    pv[i] = pe_v[((size_t)s * kWindow + w) * C + c];
  }
  for (int i = tid; i < kPos * dh; i += kThreads) {  // coalesced along channels
    const int r = i / dh, c = i % dh;
    tile[r * ld + c] = p0 + r < HW
        ? __bfloat162float(q[((size_t)s * HW + p0 + r) * C + h * dh + c]) : 0.f;
  }
  __syncthreads();

  const size_t slot = (size_t)C * HW;  // stride between window slots
  const int8_t* kp = cache + (size_t)s * 2 * kWindow * slot + (size_t)h * dh * HW + p;
  const int8_t* vp = kp + kWindow * slot;

  float logit[kWindow];
#pragma unroll
  for (int w = 0; w < kWindow; ++w) logit[w] = 0.f;
  if (valid) {
    for (int c = g; c < dh; c += kGroups) {
      const float qc = tile[lane * ld + c];
      const int8_t* kc = kp + (size_t)c * HW;
#pragma unroll
      for (int w = 0; w < kWindow; ++w)
        logit[w] += qc * ks[w * dh + c] * (float)kc[w * slot];
    }
  }
#pragma unroll
  for (int w = 0; w < kWindow; ++w) part[(g * kWindow + w) * kPos + lane] = logit[w];
  __syncthreads();

  // every warp forms its position's full logits and softmax
  const float* ep = extra + ((size_t)s * kWindow * heads + h) * HW + p;
  float m = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWindow; ++w) {
    float l = valid ? ep[(size_t)w * heads * HW] : 0.f;
    for (int gg = 0; gg < kGroups; ++gg) l += part[(gg * kWindow + w) * kPos + lane];
    logit[w] = l;
    m = fmaxf(m, l);
  }
  float sum = 0.f;
#pragma unroll
  for (int w = 0; w < kWindow; ++w) {
    logit[w] = expf(logit[w] - m);
    sum += logit[w];
  }
  const float inv = 1.f / sum;

  __syncthreads();  // all reads of the q tile are done: it becomes the out tile
  if (valid) {
    for (int c = g; c < dh; c += kGroups) {
      const int8_t* vc = vp + (size_t)c * HW;
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < kWindow; ++w)
        acc += logit[w] * ((float)vc[w * slot] * vs[w * dh + c] + pv[w * dh + c]);
      tile[lane * ld + c] = acc * inv;
    }
  }
  __syncthreads();
  for (int i = tid; i < kPos * dh; i += kThreads) {
    const int r = i / dh, c = i % dh;
    if (p0 + r < HW)
      out[((size_t)s * HW + p0 + r) * C + h * dh + c] = __float2bfloat16(tile[r * ld + c]);
  }
}

}  // namespace

extern "C" int stream_attention_int8(
    const void* q, const void* cache, const void* scales, const void* extra,
    const void* pe_v, void* out, int steps, int window, int C, int HW,
    int heads, float scale, void* stream) {
  if (window != kWindow || heads <= 0 || C % heads != 0) return (int)cudaErrorInvalidValue;
  const int dh = C / heads;
  const size_t smem = (3 * kWindow * dh + kGroups * kWindow * kPos + kPos * (dh + 1)) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      stream_attention_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((HW + kPos - 1) / kPos, heads, steps);
  stream_attention_int8_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const int8_t*)cache, (const float*)scales,
      (const float*)extra, (const float*)pe_v, (__nv_bfloat16*)out, C, HW, heads, scale);
  return (int)cudaGetLastError();
}
