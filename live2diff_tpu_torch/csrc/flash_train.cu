// Flash attention for training, fp32 in and out, for Hopper (sm_90a): the
// forward with its row log-sum-exp, and the backward, as plain CUDA C++.
//
// Replaces, for the trainer's fp32 calls under a gradient, the Pallas TPU
// kernel live2diff_tpu/ops/flash_attention.py flash_self_attention_dmajor
// (body _flash_kernel_dmajor): softmax(scale q k^T) v with no mask and no
// bias, an online softmax over key tiles, the max, sum and accumulator in
// fp32. The TPU kernel has no backward (JAX cannot differentiate a
// pallas_call); these kernels add the flash backward, recomputing the
// probabilities from the saved log-sum-exp instead of storing them:
//
//   delta = rowsum(dO * O)
//   P     = exp(scale q k^T - lse)
//   dV    = P^T dO
//   dS    = P * (dO v^T - delta)
//   dQ    = scale dS k,    dK = scale dS^T q
//
// q [N, Sq, H, D], k and v [N, Sk, H, D], o and dO [N, Sq, H, D], lse and
// delta [N, H, Sq], all fp32 and contiguous (the model's layout, read in
// place). Any Sq and Sk (ragged tiles are masked), 1 <= D <= 160.
//
// Design. fp32 operands keep these off the tensor cores (wgmma has no fp32
// input; TF32 would round q and k to 10 bits), so the bound is the 67
// TFLOP/s of the fp32 lanes: the forward does 4 N H Sq Sk D operations, the
// backward with its recompute 10. Each CTA of 256 threads owns one tile of
// 64 rows of one (n, h) and loops over the tiles of the other sequence,
// staging 64 x D tiles in dynamic shared memory (rows padded to D + 1
// floats, so the 16 threads that read 16 rows at one column hit 16 banks).
// A thread owns 4 rows (ty + 16 i) by 4 columns (tx + 16 j) of each 64 x 64
// score tile and the same 4 rows by ceil(D / 16) columns of its output
// tile, in registers; a row's max and sum are reduced over its 16 threads
// with shuffles, which stay inside a half warp. The backward runs three
// kernels with no atomics, so a run repeats bit for bit: delta (one warp a
// row), dK and dV (a CTA per key tile, looping over the query tiles), dQ (a
// CTA per query tile, looping over the key tiles). This is the simple
// version: no TMA, no pipelining of the tile loads, and a short sequence
// (the temporal attention's S = 4) fills 4 of a tile's 64 rows.

#include <cuda_runtime.h>

#include <math_constants.h>

namespace {

constexpr int BM = 64;       // rows of a tile, in either sequence
constexpr int NT = 256;      // threads a CTA: 16 x 16
constexpr int MAX_D = 160;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// rows s0 .. s0 + 63 of one (n, h) slice of a [N, S, H, D] tensor into a
// [64, ld] shared tile; rows past S read as 0
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int s0,
                                          int S, long long rs, int D, int ld) {
  for (int idx = threadIdx.x; idx < BM * D; idx += NT) {
    const int r = idx / D, c = idx - r * D;
    const int s = s0 + r;
    dst[r * ld + c] = s < S ? src[(long long)s * rs + c] : 0.f;
  }
}

// sum or max over the 16 threads of a row (lanes 0-15 or 16-31 of a warp)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// a[i][j] += sum_d A[(ty + 16 i) * ld + d] * B[(tx + 16 j) * ld + d]
__device__ __forceinline__ void dot_tiles(float (&a)[4][4], const float* A, const float* B,
                                          int D, int ld, int ty, int tx) {
  for (int d = 0; d < D; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = A[(ty + 16 * i) * ld + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = B[(tx + 16 * j) * ld + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) a[i][j] = fmaf(x[i], y[j], a[i][j]);
  }
}

// acc[i][j] += sum_{r < n} P[(ty + 16 i) * pld + r] * X[r * ld + tx + 16 j],
// columns tx + 16 j < D
template <int DPT>
__device__ __forceinline__ void product_tile(float (&acc)[4][DPT], const float* P, int pld,
                                             const float* X, int ld, int n, int D, int ty,
                                             int tx) {
  for (int r = 0; r < n; ++r) {
    float p[4], x[DPT];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = P[(ty + 16 * i) * pld + r];
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int c = tx + 16 * j;
      x[j] = c < D ? X[r * ld + c] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(p[i], x[j], acc[i][j]);
  }
}

template <int DPT>
__device__ __forceinline__ void store_tile(float* __restrict__ dst, const float (&acc)[4][DPT],
                                           float mul, int s0, int S, long long rs, int D, int ty,
                                           int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = s0 + ty + 16 * i;
    if (s >= S) continue;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int c = tx + 16 * j;
      if (c < D) dst[(long long)s * rs + c] = acc[i][j] * mul;
    }
  }
}

// grid (N * H, ceil(Sq / 64)): O and lse of one query tile
template <int DPT>
__global__ void __launch_bounds__(NT)
    flash_train_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ lse, int H, int Sq, int Sk, int D,
                           float scale_log2) {
  extern __shared__ float smem[];
  const int ld = D + 1, pld = BM + 1;
  float* Qs = smem;
  float* Ks = Qs + BM * ld;
  float* Vs = Ks + BM * ld;
  float* Ps = Vs + BM * ld;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nh = blockIdx.x, n = nh / H, h = nh - n * H;
  const int q0 = blockIdx.y * BM;
  const long long rs = (long long)H * D;
  const float* qb = q + ((long long)n * Sq * H + h) * D;
  const float* kb = k + ((long long)n * Sk * H + h) * D;
  const float* vb = v + ((long long)n * Sk * H + h) * D;

  load_tile(Qs, qb, q0, Sq, rs, D, ld);
  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }
  for (int k0 = 0; k0 < Sk; k0 += BM) {
    __syncthreads();  // the last tile's Ks, Vs and Ps are read
    load_tile(Ks, kb, k0, Sk, rs, D, ld);
    load_tile(Vs, vb, k0, Sk, rs, D, ld);
    __syncthreads();
    float s[4][4] = {};
    dot_tiles(s, Qs, Ks, D, ld, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = k0 + tx + 16 * j < Sk ? s[i][j] * scale_log2 : -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
      // key k0 is in range, so the new max is finite
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = exp2f(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[i][j] - m_new);
        sum += p;
        Ps[(ty + 16 * i) * pld + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    product_tile<DPT>(acc, Ps, pld, Vs, ld, min(BM, Sk - k0), D, ty, tx);
  }
  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    inv[i] = 1.f / l[i];
    const int s = q0 + ty + 16 * i;
    if (tx == 0 && s < Sq) lse[(long long)nh * Sq + s] = (m[i] + log2f(l[i])) * LN2;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] *= inv[i];
  store_tile<DPT>(o + ((long long)n * Sq * H + h) * D, acc, 1.f, q0, Sq, rs, D, ty, tx);
}

// delta[n, h, s] = sum_d dO[n, s, h, d] O[n, s, h, d], one warp a row
__global__ void __launch_bounds__(NT)
    flash_train_delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                             float* __restrict__ delta, int H, int Sq, int D, long long rows) {
  const long long row = (long long)blockIdx.x * (NT / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  // row = (n * H + h) * Sq + s
  const long long nh = row / Sq;
  const int s = (int)(row - nh * Sq);
  const long long n = nh / H, h = nh - n * H;
  const long long base = ((n * Sq + s) * H + h) * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(o[base + d], dout[base + d], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// grid (N * H, ceil(Sk / 64)): dK and dV of one key tile
template <int DPT>
__global__ void __launch_bounds__(NT)
    flash_train_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            float* __restrict__ dk, float* __restrict__ dv, int H, int Sq,
                            int Sk, int D, float scale, float scale_log2) {
  extern __shared__ float smem[];
  const int ld = D + 1, pld = BM + 1;
  float* Ks = smem;
  float* Vs = Ks + BM * ld;
  float* Qs = Vs + BM * ld;
  float* dOs = Qs + BM * ld;
  float* Ps = dOs + BM * ld;   // [key][query]
  float* dSs = Ps + BM * pld;  // [key][query]
  float* lse_s = dSs + BM * pld;
  float* delta_s = lse_s + BM;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nh = blockIdx.x, n = nh / H, h = nh - n * H;
  const int k0 = blockIdx.y * BM;
  const long long rs = (long long)H * D;
  const long long qoff = ((long long)n * Sq * H + h) * D, koff = ((long long)n * Sk * H + h) * D;

  load_tile(Ks, k + koff, k0, Sk, rs, D, ld);
  load_tile(Vs, v + koff, k0, Sk, rs, D, ld);
  float dk_acc[4][DPT], dv_acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int q0 = 0; q0 < Sq; q0 += BM) {
    __syncthreads();  // the last tile's Qs, dOs, Ps and dSs are read
    load_tile(Qs, q + qoff, q0, Sq, rs, D, ld);
    load_tile(dOs, dout + qoff, q0, Sq, rs, D, ld);
    if (threadIdx.x < BM) {
      const int s = q0 + threadIdx.x;
      lse_s[threadIdx.x] = s < Sq ? lse[(long long)nh * Sq + s] * LOG2E : 0.f;
      delta_s[threadIdx.x] = s < Sq ? delta[(long long)nh * Sq + s] : 0.f;
    }
    __syncthreads();
    // rows: keys ty + 16 i; columns: queries tx + 16 j
    float s[4][4] = {}, dp[4][4] = {};
    dot_tiles(s, Ks, Qs, D, ld, ty, tx);
    dot_tiles(dp, Vs, dOs, D, ld, ty, tx);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qi = tx + 16 * j;
      const bool valid = q0 + qi < Sq;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = valid ? exp2f(s[i][j] * scale_log2 - lse_s[qi]) : 0.f;
        Ps[(ty + 16 * i) * pld + qi] = p;
        dSs[(ty + 16 * i) * pld + qi] = p * (dp[i][j] - delta_s[qi]);
      }
    }
    __syncthreads();
    const int nq = min(BM, Sq - q0);
    product_tile<DPT>(dv_acc, Ps, pld, dOs, ld, nq, D, ty, tx);
    product_tile<DPT>(dk_acc, dSs, pld, Qs, ld, nq, D, ty, tx);
  }
  store_tile<DPT>(dk + koff, dk_acc, scale, k0, Sk, rs, D, ty, tx);
  store_tile<DPT>(dv + koff, dv_acc, 1.f, k0, Sk, rs, D, ty, tx);
}

// grid (N * H, ceil(Sq / 64)): dQ of one query tile
template <int DPT>
__global__ void __launch_bounds__(NT)
    flash_train_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dq, int H, int Sq, int Sk, int D, float scale,
                          float scale_log2) {
  extern __shared__ float smem[];
  const int ld = D + 1, pld = BM + 1;
  float* Qs = smem;
  float* dOs = Qs + BM * ld;
  float* Ks = dOs + BM * ld;
  float* Vs = Ks + BM * ld;
  float* dSs = Vs + BM * ld;  // [query][key]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nh = blockIdx.x, n = nh / H, h = nh - n * H;
  const int q0 = blockIdx.y * BM;
  const long long rs = (long long)H * D;
  const long long qoff = ((long long)n * Sq * H + h) * D, koff = ((long long)n * Sk * H + h) * D;

  load_tile(Qs, q + qoff, q0, Sq, rs, D, ld);
  load_tile(dOs, dout + qoff, q0, Sq, rs, D, ld);
  float lse_r[4], delta_r[4], dq_acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    lse_r[i] = s < Sq ? lse[(long long)nh * Sq + s] * LOG2E : 0.f;
    delta_r[i] = s < Sq ? delta[(long long)nh * Sq + s] : 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) dq_acc[i][j] = 0.f;
  }
  for (int k0 = 0; k0 < Sk; k0 += BM) {
    __syncthreads();  // the last tile's Ks, Vs and dSs are read
    load_tile(Ks, k + koff, k0, Sk, rs, D, ld);
    load_tile(Vs, v + koff, k0, Sk, rs, D, ld);
    __syncthreads();
    // rows: queries ty + 16 i; columns: keys tx + 16 j
    float s[4][4] = {}, dp[4][4] = {};
    dot_tiles(s, Qs, Ks, D, ld, ty, tx);
    dot_tiles(dp, dOs, Vs, D, ld, ty, tx);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ki = tx + 16 * j;
      const bool valid = k0 + ki < Sk;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = valid ? exp2f(s[i][j] * scale_log2 - lse_r[i]) : 0.f;
        dSs[(ty + 16 * i) * pld + ki] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();
    product_tile<DPT>(dq_acc, dSs, pld, Ks, ld, min(BM, Sk - k0), D, ty, tx);
  }
  store_tile<DPT>(dq + qoff, dq_acc, scale, q0, Sq, rs, D, ty, tx);
}

size_t fwd_smem(int D) { return (size_t)(3 * BM * (D + 1) + BM * (BM + 1)) * sizeof(float); }
size_t dkdv_smem(int D) {
  return (size_t)(4 * BM * (D + 1) + 2 * BM * (BM + 1) + 2 * BM) * sizeof(float);
}
size_t dq_smem(int D) { return (size_t)(4 * BM * (D + 1) + BM * (BM + 1)) * sizeof(float); }

// dynamic shared memory above 48 KB needs the attribute, once a kernel
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) done = true;
  return err;
}

template <int DPT>
int fwd(const float* q, const float* k, const float* v, float* o, float* lse, int N, int H,
        int Sq, int Sk, int D, float scale, cudaStream_t stream) {
  static bool attr = false;
  const size_t smem = fwd_smem(MAX_D);
  cudaError_t err = allow_smem(flash_train_fwd_kernel<DPT>, smem, attr);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N * H, (Sq + BM - 1) / BM);
  flash_train_fwd_kernel<DPT><<<grid, NT, fwd_smem(D), stream>>>(q, k, v, o, lse, H, Sq, Sk, D,
                                                                   scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int DPT>
int bwd(const float* q, const float* k, const float* v, const float* dout, const float* lse,
        float* delta, float* dq, float* dk, float* dv, int N, int H, int Sq, int Sk, int D,
        float scale, cudaStream_t stream) {
  static bool attr_kv = false, attr_q = false;
  cudaError_t err = allow_smem(flash_train_dkdv_kernel<DPT>, dkdv_smem(MAX_D), attr_kv);
  if (err == cudaSuccess) err = allow_smem(flash_train_dq_kernel<DPT>, dq_smem(MAX_D), attr_q);
  if (err != cudaSuccess) return (int)err;
  flash_train_dkdv_kernel<DPT><<<dim3(N * H, (Sk + BM - 1) / BM), NT, dkdv_smem(D), stream>>>(
      q, k, v, dout, lse, delta, dk, dv, H, Sq, Sk, D, scale, scale * LOG2E);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_train_dq_kernel<DPT><<<dim3(N * H, (Sq + BM - 1) / BM), NT, dq_smem(D), stream>>>(
      q, k, v, dout, lse, delta, dq, H, Sq, Sk, D, scale, scale * LOG2E);
  return (int)cudaGetLastError();
}

bool bad_shape(int N, int H, int Sq, int Sk, int D) {
  return N <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || D <= 0 || D > MAX_D ||
         (long long)N * H > 0x7fffffffLL || (Sq + BM - 1) / BM > 65535 ||
         (Sk + BM - 1) / BM > 65535;
}

}  // namespace

#define FLASH_TRAIN_CASES(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10)

// o [N, Sq, H, D] and lse [N, H, Sq] are written; every tensor fp32 and
// contiguous
extern "C" int flash_train_fwd(const float* q, const float* k, const float* v, float* o,
                               float* lse, int N, int H, int Sq, int Sk, int D, float scale,
                               void* stream) {
  if (bad_shape(N, H, Sq, Sk, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define FWD_CASE(c) \
  case c: return fwd<c>(q, k, v, o, lse, N, H, Sq, Sk, D, scale, s);
  switch ((D + 15) / 16) {
    FLASH_TRAIN_CASES(FWD_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FWD_CASE
}

// three launches: delta [N, H, Sq] (scratch), then dK and dV, then dQ; dq,
// dk and dv are written in q's, k's and v's layout
extern "C" int flash_train_bwd(const float* q, const float* k, const float* v, const float* o,
                               const float* lse, const float* dout, float* delta, float* dq,
                               float* dk, float* dv, int N, int H, int Sq, int Sk, int D,
                               float scale, void* stream) {
  if (bad_shape(N, H, Sq, Sk, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long rows = (long long)N * H * Sq;
  const long long blocks = (rows + NT / 32 - 1) / (NT / 32);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_train_delta_kernel<<<(unsigned)blocks, NT, 0, s>>>(o, dout, delta, H, Sq, D, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
#define BWD_CASE(c) \
  case c: return bwd<c>(q, k, v, dout, lse, delta, dq, dk, dv, N, H, Sq, Sk, D, scale, s);
  switch ((D + 15) / 16) {
    FLASH_TRAIN_CASES(BWD_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef BWD_CASE
}
