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

#include "flash_common.cuh"

namespace {

using namespace flash;

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
  const long long row_stride = (long long)H * D;
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
    rescale_rows<DP>(Os, As, r0, lane);
    __syncwarp();
    pv_accumulate<DP>(Os, Ps, Vs, r0);
  }
  __syncwarp();

  store_rows<DP>(out + ((size_t)b * Sq * H + h) * D, row_stride, Os, Ls, r0, lane, qt * BQ, Sq,
                 D);
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

// ---------------------------------------------------------------------------
// s-major entry: replaces live2diff_tpu/ops/flash_attention.py
// flash_self_attention (body _flash_kernel, grid (B, H, Sq / block_q,
// Sk / block_k)). The same function as above over [B, H, S, D] tensors read
// through strides (a transposed view of the model's [B, S, H, D] needs no
// copy), with the Pallas kernel's blocking: the running max, sum and
// accumulator are updated once per key block of block_k keys, and p is
// taken against the max of the whole block. A block of block_k keys (1024)
// does not fit shared memory at once, so each block is walked twice in
// 64-key tiles (block_walk in flash_common.cuh, which the int8 entry runs
// too): the first sweep finds the block's row max (Q.K only), the second
// computes p against it and accumulates P.V. That repeats Q.K, 1.5x the
// tensor-core work of the d-major entry; what bounds it is the same
// (tensor-core operations at S = 4096 and 1024), and it is simple first.
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_attention_smajor_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ out, const long long q_sb, const long long q_sh, const long long q_ss,
    const long long k_sb, const long long k_sh, const long long k_ss, const long long v_sb,
    const long long v_sh, const long long v_ss, const long long o_sb, const long long o_sh,
    const long long o_ss, int Sq, int Sk, int D, int block_k, float scale) {
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
  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + h * k_sh;
  const bf16* vb = v + b * v_sb + h * v_sh;

  load_tile<DP>(Qs, qb, qt * BQ, Sq, q_ss, D);
  for (int i = tid; i < BQ * DP; i += kThreads) Os[i] = 0.f;
  if (tid < BQ) {
    Ms[tid] = -INFINITY;
    Ls[tid] = 0.f;
  }

  const int r0 = warp * 16;
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[DP / 16];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) wmma::load_matrix_sync(qa[kk], Qs + r0 * DP + kk * 16, DP);

  block_walk<DP>(
      vb, v_ss, Sk, D, block_k, Ps, Vs, Os, Ms, Ls, As,
      [&](int k0, int k1) { load_tile<DP>(Ks, kb, k0, k1, k_ss, D); },
      [&]() {  // S[r0:r0+16, 0:64] = Q K^T of the tile in Ks
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
      },
      [&](int r, int c) { return Ss[r * BK + c] * scale; });

  store_rows<DP>(out + b * o_sb + h * o_sh, o_ss, Os, Ls, r0, lane, qt * BQ, Sq, D);
}

template <int DP>
int launch_smajor(const void* q, const void* k, const void* v, void* out,
                  const long long* st, int B, int H, int Sq, int Sk, int D, int block_k,
                  float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_smajor_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attention_smajor_kernel<DP><<<grid, kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], Sq, Sk, D, block_k, scale);
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

// q, k, v, out [B, H, S, D] bf16 with unit stride along D; strides holds the
// (b, h, s) strides in elements of q, k, v and out, in that order. block_k
// must divide Sk (the caller's pick_block).
extern "C" int flash_attention_smajor(const void* q, const void* k, const void* v, void* out,
                                      const long long* strides, int B, int H, int Sq, int Sk,
                                      int D, int block_k, float scale, void* stream) {
  if (D % 8 != 0 || Sq <= 0 || Sk <= 0 || block_k <= 0 || Sk % block_k != 0 || B > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 12; ++i)
    if (strides[i] % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch ((D + 15) / 16) {
    case 1: return launch_smajor<16>(q, k, v, out, strides, B, H, Sq, Sk, D, block_k, scale, st);
    case 2: return launch_smajor<32>(q, k, v, out, strides, B, H, Sq, Sk, D, block_k, scale, st);
    case 3: return launch_smajor<48>(q, k, v, out, strides, B, H, Sq, Sk, D, block_k, scale, st);
    case 4: return launch_smajor<64>(q, k, v, out, strides, B, H, Sq, Sk, D, block_k, scale, st);
    case 5: return launch_smajor<80>(q, k, v, out, strides, B, H, Sq, Sk, D, block_k, scale, st);
    case 6: return launch_smajor<96>(q, k, v, out, strides, B, H, Sq, Sk, D, block_k, scale, st);
    case 8: return launch_smajor<128>(q, k, v, out, strides, B, H, Sq, Sk, D, block_k, scale, st);
    case 10: return launch_smajor<160>(q, k, v, out, strides, B, H, Sq, Sk, D, block_k, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
