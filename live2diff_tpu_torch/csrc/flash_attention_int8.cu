// Flash attention with an int8 Q.K (no mask, no bias), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel live2diff_tpu/ops/flash_attention.py
// flash_self_attention_int8 (body _flash_kernel_dmajor_int8). The function:
// Q and K are quantised to symmetric int8 with one scale per quantisation
// group, s = max(max |x|, 1e-12) / 127 and code = round_half_even(x * (1/s));
// a group is block_q query rows (block_k key rows) of one (b, h), the Pallas
// kernel's tiles. The logits are the exact int32 Q.K times (s_k * s_q) *
// scale; then an fp32 online softmax updated once per key group, with p
// taken against the group's max and cast to bf16, and P.V on bf16 operands
// with fp32 accumulation.
//
// The groups are far larger than this kernel's tiles (512 query rows and up
// to 4096 key rows, against 64-row tiles), so a tile cannot find its own
// scale. Two kernels: group_amax_kernel reduces max |x| over each group of Q
// and of K (64-row chunks, merged by atomicMax on the float's bits, exact
// and order-free since |x| >= 0); flash_int8_kernel then quantises each
// tile of 64 rows in shared memory with the scales of its rows' groups and
// multiplies on the int8 tensor cores (WMMA 16x16x16 s8 -> s32; D zero-padded
// to a multiple of 16, exact in int8). Its softmax is the s-major block walk
// of flash_common.cuh with the key groups as blocks: a first sweep over a
// group's 64-key tiles finds the row max, a second takes p against it. So p
// is rounded to bf16 from the same fp32 logits and the same max as in the
// Pallas kernel and the plain version, and the kernel differs from them only
// in the order of its fp32 sums.
//
// Layout: q, k, v, out [B, H, S, D] bf16, read through strides with unit
// stride along D (the model's [B, S, H, D] transposed, without a copy).
//
// What bounds it: tensor-core operations at S = 4096 (the int8 half of the
// work at twice the bf16 rate) and, for the amax pass, the bytes of Q and K
// (read twice in all). This first version is simple, not fast: each key
// tile is quantised twice (once a sweep), the int8 tiles live in shared
// memory in a chunk-major [D/16][64][16] layout, so every WMMA operand
// pointer is 32-byte aligned, and the int32 scores go through shared memory.

#include "flash_common.cuh"

namespace {

using namespace flash;

__device__ __forceinline__ void unpack8(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

// the scale of a group from its max |x| (as the Pallas kernel computes it)
__device__ __forceinline__ float group_scale(unsigned int amax_bits) {
  return fmaxf(__uint_as_float(amax_bits), 1e-12f) / 127.0f;
}

// max |x| over each (b, h, group of `block` rows): one block per 64-row chunk
// of a group; amax [B, H, G] must be zeroed
__global__ void __launch_bounds__(kThreads) group_amax_kernel(
    const bf16* __restrict__ x, const long long sb, const long long sh, const long long ss,
    int S, int D, int block, int chunks_per_group, int H, int G,
    unsigned int* __restrict__ amax) {
  const int g = blockIdx.x / chunks_per_group, chunk = blockIdx.x % chunks_per_group;
  const int h = blockIdx.y, b = blockIdx.z;
  const int row0 = g * block + chunk * 64;
  const int row1 = min(min(row0 + 64, (g + 1) * block), S);
  const bf16* xb = x + b * sb + h * sh;
  const int vpr = D / 8;  // 16-byte vectors per row
  float m = 0.f;
  for (int i = threadIdx.x; i < (row1 - row0) * vpr; i += kThreads) {
    const int r = row0 + i / vpr, c8 = i % vpr;
    float f[8];
    unpack8(*reinterpret_cast<const uint4*>(xb + r * ss + c8 * 8), f);
#pragma unroll
    for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(f[j]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float warp_max[kThreads / 32];
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float mm = warp_max[0];
    for (int w = 1; w < kThreads / 32; ++w) mm = fmaxf(mm, warp_max[w]);
    atomicMax(amax + ((size_t)b * H + h) * G + g, __float_as_uint(mm));
  }
}

// rows [row0, row0 + 64) of one (b, h) slice, quantised with their groups'
// scales into dst [DP/16][64][16] int8; row_scale[r] gets row r's scale.
// Rows at or past S and columns past D are zero.
template <int DP>
__device__ __forceinline__ void quantise_tile(signed char* dst, float* row_scale,
                                              const bf16* src, int row0, int S,
                                              long long row_stride, int D,
                                              const unsigned int* amax, int block) {
  constexpr int cpr = DP / 8;  // 8-element vectors per padded row
  for (int i = threadIdx.x; i < 64 * cpr; i += kThreads) {
    const int r = i / cpr, c8 = i % cpr, row = row0 + r;
    uint2 packed = make_uint2(0u, 0u);
    float s = 0.f;
    if (row < S) {
      s = group_scale(amax[row / block]);
      if (c8 * 8 < D) {
        const float inv = 1.0f / s;
        float f[8];
        unpack8(*reinterpret_cast<const uint4*>(src + row * row_stride + c8 * 8), f);
        signed char* c = reinterpret_cast<signed char*>(&packed);
#pragma unroll
        for (int j = 0; j < 8; ++j) c[j] = (signed char)__float2int_rn(f[j] * inv);
      }
    }
    *reinterpret_cast<uint2*>(dst + (c8 / 2) * 64 * 16 + r * 16 + (c8 % 2) * 8) = packed;
    if (c8 == 0) row_scale[r] = s;
  }
}

template <int DP>
constexpr size_t smem_bytes() {
  return (size_t)BQ * DP * sizeof(float)    // output accumulator
         + (size_t)BQ * BK * sizeof(int)    // int32 scores
         + (size_t)BQ * BK * sizeof(bf16)   // probabilities
         + (size_t)BK * DP * sizeof(bf16)   // V tile
         + (size_t)2 * 64 * DP              // Q and K int8 tiles
         + (size_t)5 * 64 * sizeof(float);  // max, sum, rescale, q and k row scales
}

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_int8_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ out, const long long q_sb, const long long q_sh, const long long q_ss,
    const long long k_sb, const long long k_sh, const long long k_ss, const long long v_sb,
    const long long v_sh, const long long v_ss, const long long o_sb, const long long o_sh,
    const long long o_ss, const unsigned int* __restrict__ q_amax,
    const unsigned int* __restrict__ k_amax, int H, int Sq, int Sk, int D, int block_q,
    int block_k, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Os = reinterpret_cast<float*>(smem_raw);
  int* Si = reinterpret_cast<int*>(Os + BQ * DP);
  bf16* Ps = reinterpret_cast<bf16*>(Si + BQ * BK);
  bf16* Vs = Ps + BQ * BK;
  signed char* Q8 = reinterpret_cast<signed char*>(Vs + BK * DP);
  signed char* K8 = Q8 + 64 * DP;
  float* Ms = reinterpret_cast<float*>(K8 + 64 * DP);
  float* Ls = Ms + BQ;
  float* As = Ls + BQ;
  float* SQ = As + BQ;
  float* SK = SQ + BQ;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int Gq = Sq / block_q, Gk = Sk / block_k;
  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + h * k_sh;
  const bf16* vb = v + b * v_sb + h * v_sh;
  const unsigned int* qa_bits = q_amax + ((size_t)b * H + h) * Gq;
  const unsigned int* ka_bits = k_amax + ((size_t)b * H + h) * Gk;

  quantise_tile<DP>(Q8, SQ, qb, qt * BQ, Sq, q_ss, D, qa_bits, block_q);
  for (int i = tid; i < BQ * DP; i += kThreads) Os[i] = 0.f;
  if (tid < BQ) {
    Ms[tid] = -INFINITY;
    Ls[tid] = 0.f;
  }

  const int r0 = warp * 16;  // this warp's query rows within the tile
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> qa[DP / 16];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wmma::load_matrix_sync(qa[kk], Q8 + kk * 64 * 16 + r0 * 16, 16);

  // the key groups are the walk's blocks: a tile never straddles two
  block_walk<DP>(
      vb, v_ss, Sk, D, block_k, Ps, Vs, Os, Ms, Ls, As,
      [&](int k0, int k1) { quantise_tile<DP>(K8, SK, kb, k0, k1, k_ss, D, ka_bits, block_k); },
      [&]() {  // int32 scores S[r0:r0+16, 0:64] = Q8 K8^T, exact
#pragma unroll
        for (int n = 0; n < BK / 16; ++n) {
          wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc;
          wmma::fill_fragment(acc, 0);
#pragma unroll
          for (int kk = 0; kk < DP / 16; ++kk) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> bt;
            wmma::load_matrix_sync(bt, K8 + kk * 64 * 16 + n * 16 * 16, 16);
            wmma::mma_sync(acc, qa[kk], bt, acc);
          }
          wmma::store_matrix_sync(Si + r0 * BK + n * 16, acc, BK, wmma::mem_row_major);
        }
        __syncwarp();
      },
      // logit = float(int) * ((s_k * s_q) * scale), the Pallas kernel's order
      [&](int r, int c) { return (float)Si[r * BK + c] * ((SK[c] * SQ[r]) * scale); });

  store_rows<DP>(out + b * o_sb + h * o_sh, o_ss, Os, Ls, r0, lane, qt * BQ, Sq, D);
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* out, unsigned int* amax,
           const long long* st, int B, int H, int Sq, int Sk, int D, int block_q, int block_k,
           float scale, cudaStream_t stream) {
  const int Gq = Sq / block_q, Gk = Sk / block_k;
  unsigned int* q_amax = amax;
  unsigned int* k_amax = amax + (size_t)B * H * Gq;
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(unsigned int) * (size_t)B * H * (Gq + Gk),
                                    stream);
  if (err != cudaSuccess) return (int)err;
  const int cpg_q = (block_q + 63) / 64, cpg_k = (block_k + 63) / 64;
  group_amax_kernel<<<dim3(Gq * cpg_q, H, B), kThreads, 0, stream>>>(
      (const bf16*)q, st[0], st[1], st[2], Sq, D, block_q, cpg_q, H, Gq, q_amax);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  group_amax_kernel<<<dim3(Gk * cpg_k, H, B), kThreads, 0, stream>>>(
      (const bf16*)k, st[3], st[4], st[5], Sk, D, block_k, cpg_k, H, Gk, k_amax);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  constexpr size_t smem = smem_bytes<DP>();
  err = cudaFuncSetAttribute(flash_int8_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_int8_kernel<DP><<<grid, kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], q_amax, k_amax, H, Sq, Sk, D,
      block_q, block_k, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, out [B, H, S, D] bf16 with unit stride along D; strides holds the
// (b, h, s) strides in elements of q, k, v and out, in that order. block_q
// and block_k must divide Sq and Sk. amax is scratch of B * H * (Sq /
// block_q + Sk / block_k) 32-bit words.
extern "C" int flash_attention_int8(const void* q, const void* k, const void* v, void* out,
                                    void* amax, const long long* strides, int B, int H, int Sq,
                                    int Sk, int D, int block_q, int block_k, float scale,
                                    void* stream) {
  if (D % 8 != 0 || Sq <= 0 || Sk <= 0 || block_q <= 0 || block_k <= 0 || Sq % block_q != 0 ||
      Sk % block_k != 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 12; ++i)
    if (strides[i] % 8 != 0) return (int)cudaErrorInvalidValue;
  unsigned int* a = (unsigned int*)amax;
  cudaStream_t st = (cudaStream_t)stream;
  switch ((D + 15) / 16) {
    case 1: return launch<16>(q, k, v, out, a, strides, B, H, Sq, Sk, D, block_q, block_k, scale, st);
    case 2: return launch<32>(q, k, v, out, a, strides, B, H, Sq, Sk, D, block_q, block_k, scale, st);
    case 3: return launch<48>(q, k, v, out, a, strides, B, H, Sq, Sk, D, block_q, block_k, scale, st);
    case 4: return launch<64>(q, k, v, out, a, strides, B, H, Sq, Sk, D, block_q, block_k, scale, st);
    case 5: return launch<80>(q, k, v, out, a, strides, B, H, Sq, Sk, D, block_q, block_k, scale, st);
    case 6: return launch<96>(q, k, v, out, a, strides, B, H, Sq, Sk, D, block_q, block_k, scale, st);
    case 8: return launch<128>(q, k, v, out, a, strides, B, H, Sq, Sk, D, block_q, block_k, scale, st);
    case 10: return launch<160>(q, k, v, out, a, strides, B, H, Sq, Sk, D, block_q, block_k, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
