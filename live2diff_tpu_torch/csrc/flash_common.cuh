// Device code shared by the flash attention kernels, for Hopper (sm_90a):
// flash_attention.cu (the d-major and s-major entries) and
// flash_attention_int8.cu include it. It holds the tile load, the rescale of
// the output accumulator, the P.V product, the output write-back, and the
// s-major block walk that both [B, H, S, D] entries run.
//
// A block of kThreads = 128 threads (4 warps) owns BQ = 64 query rows; warp
// w owns rows [16 w, 16 w + 16). In a softmax walk two lanes own a row of a
// 64-key tile's scores, 32 keys each, walked in an order skewed by the lane
// so that a warp's 32 shared-memory accesses hit 32 distinct banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace flash {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per tile
constexpr int kThreads = 128;

// rows [row0, row0 + 64) of one (b, h) slice into smem [64][DP]; rows at or
// past S and columns past D are zero
template <int DP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0, int S,
                                          long long row_stride, int D) {
  constexpr int cpr = DP / 8;  // 16-byte chunks per smem row
  for (int i = threadIdx.x; i < 64 * cpr; i += kThreads) {
    const int r = i / cpr, c8 = i % cpr;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S && c8 * 8 < D)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * row_stride + c8 * 8);
    *reinterpret_cast<uint4*>(dst + r * DP + c8 * 8) = val;
  }
}

// O[r0:r0+16, :] *= As[r0:r0+16], the lanes across each row
template <int DP>
__device__ __forceinline__ void rescale_rows(float* Os, const float* As, int r0, int lane) {
  for (int rr = 0; rr < 16; ++rr) {
    const float a = As[r0 + rr];
    float* orow = Os + (r0 + rr) * DP;
    for (int d = lane; d < DP; d += 32) orow[d] *= a;
  }
}

// O[r0:r0+16, :] += P[r0:r0+16, 0:64] V on bf16 WMMA with fp32 accumulation
template <int DP>
__device__ __forceinline__ void pv_accumulate(float* Os, const bf16* Ps, const bf16* Vs, int r0) {
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

// output rows row_base + [r0, r0 + 16) = O * (1 / l) (1 where l == 0), rows
// inside Sq and columns inside D only; ob points at row 0 of the (b, h) slice
template <int DP>
__device__ __forceinline__ void store_rows(bf16* ob, long long o_ss, const float* Os,
                                           const float* Ls, int r0, int lane, int row_base,
                                           int Sq, int D) {
  for (int i = lane; i < 16 * D; i += 32) {
    const int rr = r0 + i / D, d = i % D;
    const int row = row_base + rr;
    if (row < Sq) {
      const float l = Ls[rr];
      const float inv = l == 0.f ? 1.f : 1.f / l;
      ob[row * o_ss + d] = __float2bfloat16(Os[rr * DP + d] * inv);
    }
  }
}

// The s-major online softmax of one query tile, the Pallas kernels'
// blocking: the running max, sum and accumulator are updated once per block
// of block_k keys, and p is taken against the max of the whole block, so p
// is rounded to bf16 exactly where the plain versions round it. A block does
// not fit shared memory at once, so it is walked twice in 64-key tiles:
// sweep 1 finds each row's max over the block, sweep 2 computes p, l and P.V.
//
//   load_k(k0, k1)  all threads: stage the key tile [k0, k0 + 64), rows at or
//                   past k1 zero;
//   scores()        this warp: the raw Q.K of its 16 rows and the staged
//                   tile, then __syncwarp;
//   logit(r, c)     the fp32 logit of tile row r, key column c, after scores().
//
// Os, Ms, Ls must hold 0, -inf, 0 for the tile's rows on entry.
template <int DP, class LoadK, class Scores, class Logit>
__device__ __forceinline__ void block_walk(const bf16* vb, long long v_ss, int Sk, int D,
                                           int block_k, bf16* Ps, bf16* Vs, float* Os,
                                           float* Ms, float* Ls, float* As, LoadK&& load_k,
                                           Scores&& scores, Logit&& logit) {
  const int lane = threadIdx.x % 32, r0 = (threadIdx.x / 32) * 16;
  const int r = r0 + lane / 2, half = lane % 2;
  bf16* prow = Ps + r * BK + half * 32;

  for (int kb0 = 0; kb0 < Sk; kb0 += block_k) {
    const int kb1 = min(kb0 + block_k, Sk);

    // sweep 1: the block's row max
    float bm = -INFINITY;
    for (int k0 = kb0; k0 < kb1; k0 += BK) {
      __syncthreads();  // the previous tile fully consumed
      load_k(k0, kb1);
      __syncthreads();
      scores();
      const int valid = kb1 - k0 - half * 32;  // keys of this half inside the block
#pragma unroll 8
      for (int j = 0; j < 32; ++j) {
        const int c = (j + lane) & 31;
        if (c < valid) bm = fmaxf(bm, logit(r, half * 32 + c));
      }
      __syncwarp();
    }
    bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, 1));
    const float m_prev = Ms[r];
    const float m_new = fmaxf(m_prev, bm);  // finite: key kb0 is valid
    const float alpha = expf(m_prev - m_new);
    __syncwarp();  // both lanes of the row have read Ms[r]
    if (half == 0) {
      Ms[r] = m_new;
      Ls[r] *= alpha;
      As[r] = alpha;
    }
    __syncwarp();
    rescale_rows<DP>(Os, As, r0, lane);
    __syncwarp();

    // sweep 2: p against the block max, l and O accumulated
    for (int k0 = kb0; k0 < kb1; k0 += BK) {
      __syncthreads();
      load_k(k0, kb1);
      load_tile<DP>(Vs, vb, k0, kb1, v_ss, D);
      __syncthreads();
      scores();
      const int valid = kb1 - k0 - half * 32;
      float sum = 0.f;
#pragma unroll 8
      for (int j = 0; j < 32; ++j) {
        const int c = (j + lane) & 31;
        const float pj = c < valid ? expf(logit(r, half * 32 + c) - m_new) : 0.f;
        prow[c] = __float2bfloat16(pj);
        sum += pj;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if (half == 0) Ls[r] += sum;
      __syncwarp();
      pv_accumulate<DP>(Os, Ps, Vs, r0);
      __syncwarp();
    }
  }
}

}  // namespace flash
