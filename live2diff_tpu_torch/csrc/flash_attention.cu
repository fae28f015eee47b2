// Flash scaled-dot-product attention (no mask, no bias), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel live2diff_tpu/ops/flash_attention.py
// flash_self_attention_dmajor (body _flash_kernel_dmajor): softmax(scale *
// q k^T) v with an online softmax, fp32 running max / sum / accumulator,
// bf16 operands with fp32 accumulation, p cast to bf16 before the PV
// product, and the l == 0 guard at the end. Unlike the TPU kernel it takes
// any Sq and Sk (ragged key tiles are masked, rows past Sq are not written),
// so it serves spatial self-attention (S = 4096, 1024, 256, 64 at 512x512),
// cross-attention over the 77 text tokens, and the warmup motion attention
// over 8 frames with the spatial positions folded into the batch.
//
// Layout: q [B, Sq, H, D], k and v [B, Sk, H, D], out [B, Sq, H, D], all
// bf16 and contiguous (the model's [..., S, H, D] layout, read in place: no
// transposes). D must be a multiple of 8 (16-byte rows); it is zero-padded
// inside to DP, a multiple of 16 (40 -> 48), the depth of a bf16 MMA.
//
// What bounds it: tensor-core operations at the two large levels (S = 4096,
// D = 40 is ~43 GFLOP a call, ~44 us at 989 TFLOP/s). This first version is
// simple, not fast: one block of 4 warps per (b, h, 64-query tile); each
// warp owns 16 query rows, held as WMMA fragments; K/V tiles of 64 keys are
// staged in shared memory and multiplied with WMMA bf16 16x16x16 fragments.
// Scores and the output accumulator go through shared memory so the
// online-softmax rescaling can address rows. Two lanes own a row of scores
// and walk its keys in an order skewed by the lane, so a warp's shared-
// memory accesses hit 32 distinct banks (in a first version they all hit
// one bank); the accumulator rows are rescaled with the lanes across a
// row. wgmma, TMA and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per tile
constexpr int kThreads = 128;

// rows [row0, row0 + 64) of one (b, h) slice into smem [64][DP];
// rows past S and columns past D are zero
template <int DP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0, int S,
                                          int row_stride, int D) {
  constexpr int cpr = DP / 8;  // 16-byte chunks per smem row
  for (int i = threadIdx.x; i < 64 * cpr; i += kThreads) {
    const int r = i / cpr, c8 = i % cpr;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S && c8 * 8 < D)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * row_stride + c8 * 8);
    *reinterpret_cast<uint4*>(dst + r * DP + c8 * 8) = val;
  }
}

template <int DP>
constexpr size_t smem_bytes() {
  return (size_t)3 * 64 * DP * sizeof(bf16)  // Q, K, V tiles
         + (size_t)BQ * BK * sizeof(float)   // scores
         + (size_t)BQ * BK * sizeof(bf16)    // probabilities
         + (size_t)BQ * DP * sizeof(float)   // output accumulator
         + (size_t)3 * BQ * sizeof(float);   // running max, sum, last rescale
}

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ out, int H, int Sq, int Sk, int D, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BQ * DP;
  bf16* Vs = Ks + BK * DP;
  float* Ss = reinterpret_cast<float*>(Vs + BK * DP);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + BQ * BK);
  float* Os = reinterpret_cast<float*>(Ps + BQ * BK);
  float* Ms = Os + BQ * DP;
  float* Ls = Ms + BQ;
  float* As = Ls + BQ;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row_stride = H * D;
  const bf16* qb = q + ((size_t)b * Sq * H + h) * D;
  const bf16* kb = k + ((size_t)b * Sk * H + h) * D;
  const bf16* vb = v + ((size_t)b * Sk * H + h) * D;

  load_tile<DP>(Qs, qb, qt * BQ, Sq, row_stride, D);
  for (int i = tid; i < BQ * DP; i += kThreads) Os[i] = 0.f;
  if (tid < BQ) {
    Ms[tid] = -INFINITY;
    Ls[tid] = 0.f;
  }

  const int r0 = warp * 16;  // this warp's query rows within the tile
  __syncthreads();
  // this warp's Q rows stay in registers for the whole key loop
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[DP / 16];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) wmma::load_matrix_sync(qa[kk], Qs + r0 * DP + kk * 16, DP);

  for (int k0 = 0; k0 < Sk; k0 += BK) {
    __syncthreads();  // previous tile fully consumed
    load_tile<DP>(Ks, kb, k0, Sk, row_stride, D);
    load_tile<DP>(Vs, vb, k0, Sk, row_stride, D);
    __syncthreads();

    // scores S[r0:r0+16, 0:64] = Q K^T
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
        wmma::load_matrix_sync(bt, Ks + n * 16 * DP + kk * 16, DP);
        wmma::mma_sync(acc, qa[kk], bt, acc);
      }
      wmma::store_matrix_sync(Ss + r0 * BK + n * 16, acc, BK, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax: two lanes per row, 32 keys each, walked in an order
    // skewed by the lane so the warp's 32 accesses hit 32 distinct banks
    {
      const int r = r0 + lane / 2, half = lane % 2;
      float* srow = Ss + r * BK + half * 32;
      const int valid = Sk - k0 - half * 32;  // keys of this half inside Sk
      float mx = -INFINITY;
#pragma unroll 8
      for (int j = 0; j < 32; ++j) {
        const int c = (j + lane) & 31;
        const float x = c < valid ? srow[c] * scale : -INFINITY;
        srow[c] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_prev = Ms[r];
      const float m_new = fmaxf(m_prev, mx);  // finite: key k0 is always valid
      const float alpha = expf(m_prev - m_new);
      bf16* prow = Ps + r * BK + half * 32;
      float sum = 0.f;
#pragma unroll 8
      for (int j = 0; j < 32; ++j) {
        const int c = (j + lane) & 31;
        const float pj = expf(srow[c] - m_new);
        prow[c] = __float2bfloat16(pj);
        sum += pj;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      __syncwarp();  // both lanes of the row have read Ms[r]
      if (half == 0) {
        Ms[r] = m_new;
        Ls[r] = Ls[r] * alpha + sum;
        As[r] = alpha;
      }
    }
    __syncwarp();
    // rescale the accumulator rows, lanes across the row
    for (int rr = 0; rr < 16; ++rr) {
      const float a = As[r0 + rr];
      float* orow = Os + (r0 + rr) * DP;
      for (int d = lane; d < DP; d += 32) orow[d] *= a;
    }
    __syncwarp();

    // O[r0:r0+16, :] += P V
#pragma unroll
    for (int n = 0; n < DP / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
      wmma::load_matrix_sync(o, Os + r0 * DP + n * 16, DP, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, Ps + r0 * BK + kk * 16, BK);
        wmma::load_matrix_sync(bv, Vs + kk * 16 * DP + n * 16, DP);
        wmma::mma_sync(o, a, bv, o);
      }
      wmma::store_matrix_sync(Os + r0 * DP + n * 16, o, DP, wmma::mem_row_major);
    }
  }
  __syncwarp();

  // out = O / l, rows inside Sq and columns inside D only
  for (int i = lane; i < 16 * D; i += 32) {
    const int r = r0 + i / D, d = i % D;
    const int row = qt * BQ + r;
    if (row < Sq) {
      const float l = Ls[r];
      const float inv = l == 0.f ? 1.f : 1.f / l;
      out[((size_t)b * Sq + row) * row_stride + (size_t)h * D + d] =
          __float2bfloat16(Os[r * DP + d] * inv);
    }
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H, int Sq,
           int Sk, int D, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attention_kernel<DP><<<grid, kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, H, Sq, Sk, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out,
                               int B, int H, int Sq, int Sk, int D, float scale,
                               void* stream) {
  if (D % 8 != 0 || Sq <= 0 || Sk <= 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch ((D + 15) / 16) {
    case 1: return launch<16>(q, k, v, out, B, H, Sq, Sk, D, scale, st);
    case 2: return launch<32>(q, k, v, out, B, H, Sq, Sk, D, scale, st);
    case 3: return launch<48>(q, k, v, out, B, H, Sq, Sk, D, scale, st);
    case 4: return launch<64>(q, k, v, out, B, H, Sq, Sk, D, scale, st);
    case 5: return launch<80>(q, k, v, out, B, H, Sq, Sk, D, scale, st);
    case 6: return launch<96>(q, k, v, out, B, H, Sq, Sk, D, scale, st);
    case 8: return launch<128>(q, k, v, out, B, H, Sq, Sk, D, scale, st);
    case 10: return launch<160>(q, k, v, out, B, H, Sq, Sk, D, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
