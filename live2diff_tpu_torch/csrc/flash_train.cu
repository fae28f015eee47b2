// Flash attention for training, fp32 in and out, for Hopper (sm_90a): the
// forward with its row log-sum-exp, and the backward.
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
// place). Any Sq and Sk, 1 <= D <= 160. Two routes, which
// ops/flash_train.py:train_route picks from the lengths:
//
// The short route (Sq and Sk both at most SHORT_MAX = 16: the clip-mode
// temporal attention at S = 4, the 4 x 4 latent's self-attention at 16) is
// bound by bytes: a (n, h) slice holds 16-256 scores, so a 64-row tile
// would be nearly all padding. A CTA owns a run of (n, h) slices, whole
// samples (all H heads of consecutive n, one contiguous [nb, S, H, D] slab
// of each tensor) or, where a sample's slab would not fit, a run of heads of
// one sample, and copies them into shared memory with 16-byte cp.async (4-byte
// where D % 4 != 0), unpadded. A group of 8 lanes owns a row: its dot
// products are reduced over the group with shuffles, the softmax of a whole
// row is exact, and O, dQ, dK and dV go from registers to device memory in
// 16-byte stores. The backward is one launch: delta, P and dS of each query
// row (dQ with them), then, after one barrier, dK and dV of each key row
// from the P and dS the CTA left in shared memory. No atomics: a run repeats
// bit for bit.
//
// The tiled route (everything else: the spatial self-attentions at S = 64 to
// 1024, the cross-attentions over 77 text tokens) is bound by its products.
// Every product runs on the tensor cores in 3xTF32, as PyTorch's fp32
// attention does: each operand x is split into big = rna_tf32(x) and small =
// rna_tf32(x - big) (round to nearest, ties away, to a 10-bit mantissa, done
// with integer operations: bit for bit what cvt.rna.tf32.f32 gives a finite
// x), and acc += a_small b_big + a_big b_small + a_big b_big through
// mma.sync.m16n8k8 tf32 with fp32 accumulation, which keeps fp32's accuracy
// (a single TF32 product rounds q and k to 10 bits, another function). So
// the least time is 3 x the products at the TF32 rate. mma.sync and not
// wgmma: wgmma takes TF32 only with both operands K-major in shared memory,
// which P V and the backward's transposed products are not. A CTA of 4
// warps owns 64 rows (16 a warp) and walks the other sequence in tiles that
// cp.async double-buffers into shared memory, rows padded to D8 + 4 floats
// (D8: D rounded up to a multiple of 8, zero-filled), which keeps the rows
// 16-byte aligned and both fragment reads free of bank conflicts: row-major
// (row g, column t) and the transposed one below (row 2t, column g). A score
// tile's accumulator becomes the next product's A operand in registers, its
// k index permuted (column t of the A fragment is key 2t, column t + 4 key
// 2t + 1) and the B operand read with the same permutation. The backward
// runs two kernels with no atomics: dQ (a CTA per query tile, looping over
// the key tiles; it computes delta for its rows first and writes it), then dK
// and dV (a CTA per key tile, looping over the query tiles). Where D > 80 and
// there are at most 128 keys (the 16 x 16 and 8 x 8 latents at D = 160) a
// 64-row CTA would walk every key alone while most SMs idle; there the
// forward's CTA owns 16 query rows with K and V whole in shared memory, its
// 4 warps split the keys, and their running max, sum and O are merged at
// the end.

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include <math_constants.h>

namespace {

constexpr int MAX_D = 160;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// cp.async
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// 16 bytes, zero-filled where !ok (src is then not read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// The short route
// ---------------------------------------------------------------------------

constexpr int SHORT_MAX = 16;       // Sq and Sk at most this
constexpr int SG = 8;               // lanes a row
constexpr int SHORT_THREADS = 256;  // at most, a CTA
constexpr size_t SHORT_SMEM = 96 * 1024;

// sum over the 8 lanes of a row group (aligned to 8 in its warp)
__device__ __forceinline__ float group_sum(float x, unsigned mask) {
  x += __shfl_xor_sync(mask, x, 4);
  x += __shfl_xor_sync(mask, x, 2);
  x += __shfl_xor_sync(mask, x, 1);
  return x;
}

// a lane's part of a D-row: chunks of W floats at columns (l8 + 8 m) W,
// m < E; zeros past D (W = 4 needs D % 4 == 0 and 16-byte aligned rows)
template <int W, int E>
__device__ __forceinline__ void ld_row(float (&x)[W * E], const float* row, int l8, int D) {
#pragma unroll
  for (int m = 0; m < E; ++m) {
    const int c = (l8 + SG * m) * W;
    if (W == 4) {
      const float4 t = c < D ? *reinterpret_cast<const float4*>(row + c)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      x[4 * m] = t.x;
      x[4 * m + 1] = t.y;
      x[4 * m + 2] = t.z;
      x[4 * m + 3] = t.w;
    } else {
      x[m] = c < D ? row[c] : 0.f;
    }
  }
}
template <int W, int E>
__device__ __forceinline__ void st_row(float* row, const float (&x)[W * E], float mul, int l8,
                                       int D) {
#pragma unroll
  for (int m = 0; m < E; ++m) {
    const int c = (l8 + SG * m) * W;
    if (c >= D) continue;
    if (W == 4) {
      *reinterpret_cast<float4*>(row + c) =
          make_float4(x[4 * m] * mul, x[4 * m + 1] * mul, x[4 * m + 2] * mul, x[4 * m + 3] * mul);
    } else {
      row[c] = x[m] * mul;
    }
  }
}
template <int N>
__device__ __forceinline__ float dot_part(const float (&a)[N], const float (&b)[N]) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) s = fmaf(a[i], b[i], s);
  return s;
}
template <int N>
__device__ __forceinline__ void axpy(float (&acc)[N], float p, const float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = fmaf(p, x[i], acc[i]);
}

// the (n, h) slices a CTA owns: nb samples from n0 and hc heads from h0
// (hc == H, or nb == 1 and hc divides H)
struct Slices {
  int n0, nb, h0, hc;
};
__device__ __forceinline__ Slices my_slices(int N, int H, int nb, int hc) {
  const int per_n = H / hc;
  Slices s;
  s.n0 = (int)(blockIdx.x / per_n) * nb;
  s.nb = min(nb, N - s.n0);
  s.h0 = (int)(blockIdx.x % per_n) * hc;
  s.hc = hc;
  return s;
}

// the [nb, S, hc, D] part of a [N, S, H, D] tensor into shared memory, as
// nb * S rows of hc * D contiguous floats
template <int W>
__device__ __forceinline__ void load_slab(float* dst, const float* __restrict__ src,
                                          const Slices& sl, int S, int H, int D) {
  const int row_len = sl.hc * D / W;
  const int total = sl.nb * S * row_len;
  for (int f = threadIdx.x; f < total; f += blockDim.x) {
    const int row = f / row_len, c = (f - row * row_len) * W;
    const float* g = src + ((long long)(sl.n0 * S + row) * H + sl.h0) * D + c;
    if (W == 4)
      cp_async16(dst + row * sl.hc * D + c, g, true);
    else
      cp_async4(dst + row * sl.hc * D + c, g, true);
  }
}

// blockDim.x = 8 lanes x Sq rows x the CTA's slices
template <int W, int E>
__global__ void __launch_bounds__(SHORT_THREADS)
    flash_train_short_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, float* __restrict__ o,
                                 float* __restrict__ lse, int N, int H, int Sq, int Sk, int D,
                                 int nb, int hc, float scale_log2) {
  extern __shared__ __align__(16) float smem[];
  const Slices sl = my_slices(N, H, nb, hc);
  float* Qs = smem;
  float* Ks = Qs + nb * Sq * hc * D;
  float* Vs = Ks + nb * Sk * hc * D;
  load_slab<W>(Qs, q, sl, Sq, H, D);
  load_slab<W>(Ks, k, sl, Sk, H, D);
  load_slab<W>(Vs, v, sl, Sk, H, D);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // group (nbi, i, hi), heads fastest: the shared and the device row orders
  const int grp = threadIdx.x / SG, l8 = threadIdx.x % SG;
  if (grp >= sl.nb * Sq * hc) return;
  const unsigned mask = 0xffu << (threadIdx.x & 24);
  const int hi = grp % hc, row = grp / hc, nbi = row / Sq, i = row - nbi * Sq;
  const int kstride = hc * D;
  const float* kr = Ks + (nbi * Sk * hc + hi) * D;
  const float* vr = Vs + (nbi * Sk * hc + hi) * D;
  float qv[W * E], x[W * E];
  ld_row<W, E>(qv, Qs + grp * D, l8, D);
  float s[SHORT_MAX];
  float mx = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < SHORT_MAX; ++j) {
    if (j < Sk) {
      ld_row<W, E>(x, kr + j * kstride, l8, D);
      s[j] = group_sum(dot_part(qv, x), mask) * scale_log2;
      mx = fmaxf(mx, s[j]);
    }
  }
  float acc[W * E] = {}, sum = 0.f;
#pragma unroll
  for (int j = 0; j < SHORT_MAX; ++j) {
    if (j < Sk) {
      const float p = exp2f(s[j] - mx);
      sum += p;
      ld_row<W, E>(x, vr + j * kstride, l8, D);
      axpy(acc, p, x);
    }
  }
  const int n = sl.n0 + nbi, h = sl.h0 + hi;
  st_row<W, E>(o + (((long long)n * Sq + i) * H + h) * D, acc, 1.f / sum, l8, D);
  if (l8 == 0) lse[((long long)n * H + h) * Sq + i] = (mx + log2f(sum)) * LN2;
}

// one launch: blockDim.x = 8 lanes x max(Sq, Sk) rows x the CTA's slices
template <int W, int E>
__global__ void __launch_bounds__(SHORT_THREADS)
    flash_train_short_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, const float* __restrict__ o,
                                 const float* __restrict__ lse, const float* __restrict__ dout,
                                 float* __restrict__ dq, float* __restrict__ dk,
                                 float* __restrict__ dv, int N, int H, int Sq, int Sk, int D,
                                 int nb, int hc, float scale, float scale_log2) {
  extern __shared__ __align__(16) float smem[];
  const Slices sl = my_slices(N, H, nb, hc);
  float* Qs = smem;
  float* dOs = Qs + nb * Sq * hc * D;
  float* Ks = dOs + nb * Sq * hc * D;
  float* Vs = Ks + nb * Sk * hc * D;
  float* Ps = Vs + nb * Sk * hc * D;  // [slice][query][key]
  float* dSs = Ps + nb * hc * Sq * Sk;
  load_slab<W>(Qs, q, sl, Sq, H, D);
  load_slab<W>(dOs, dout, sl, Sq, H, D);
  load_slab<W>(Ks, k, sl, Sk, H, D);
  load_slab<W>(Vs, v, sl, Sk, H, D);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int grp = threadIdx.x / SG, l8 = threadIdx.x % SG;
  const unsigned mask = 0xffu << (threadIdx.x & 24);
  const int hi = grp % hc, row = grp / hc;
  const int kstride = hc * D;
  float a[W * E], b[W * E], acc[W * E];

  // 1. group (nbi, i, hi) as query row i: delta, P and dS of its row, dQ
  if (grp < sl.nb * Sq * hc) {
    const int nbi = row / Sq, i = row - nbi * Sq;
    const int n = sl.n0 + nbi, h = sl.h0 + hi, u = nbi * hc + hi;
    const long long grow = (((long long)n * Sq + i) * H + h) * D;
    float qv[W * E], dov[W * E];
    ld_row<W, E>(qv, Qs + grp * D, l8, D);
    ld_row<W, E>(dov, dOs + grp * D, l8, D);
    ld_row<W, E>(a, o + grow, l8, D);
    const float delta = group_sum(dot_part(dov, a), mask);
    const float lse2 = lse[((long long)n * H + h) * Sq + i] * LOG2E;
    const float* kr = Ks + (nbi * Sk * hc + hi) * D;
    const float* vr = Vs + (nbi * Sk * hc + hi) * D;
#pragma unroll
    for (int m = 0; m < W * E; ++m) acc[m] = 0.f;
#pragma unroll
    for (int j = 0; j < SHORT_MAX; ++j) {
      if (j < Sk) {
        ld_row<W, E>(a, kr + j * kstride, l8, D);
        ld_row<W, E>(b, vr + j * kstride, l8, D);
        const float s = group_sum(dot_part(qv, a), mask);
        const float dp = group_sum(dot_part(dov, b), mask);
        const float p = exp2f(s * scale_log2 - lse2);
        const float ds = p * (dp - delta);
        if (l8 == 0) {
          Ps[(u * Sq + i) * Sk + j] = p;
          dSs[(u * Sq + i) * Sk + j] = ds;
        }
        axpy(acc, ds, a);
      }
    }
    st_row<W, E>(dq + grow, acc, scale, l8, D);
  }
  __syncthreads();

  // 2. group (nbi, j, hi) as key row j: dK and dV from the CTA's P and dS
  if (grp < sl.nb * Sk * hc) {
    const int nbi = row / Sk, j = row - nbi * Sk;
    const int n = sl.n0 + nbi, h = sl.h0 + hi, u = nbi * hc + hi;
    const float* qr = Qs + (nbi * Sq * hc + hi) * D;
    const float* dor = dOs + (nbi * Sq * hc + hi) * D;
    float dva[W * E];
#pragma unroll
    for (int m = 0; m < W * E; ++m) acc[m] = dva[m] = 0.f;
#pragma unroll
    for (int i = 0; i < SHORT_MAX; ++i) {
      if (i < Sq) {
        const float p = Ps[(u * Sq + i) * Sk + j], ds = dSs[(u * Sq + i) * Sk + j];
        ld_row<W, E>(a, qr + i * kstride, l8, D);
        ld_row<W, E>(b, dor + i * kstride, l8, D);
        axpy(acc, ds, a);
        axpy(dva, p, b);
      }
    }
    const long long grow = (((long long)n * Sk + j) * H + h) * D;
    st_row<W, E>(dk + grow, acc, scale, l8, D);
    st_row<W, E>(dv + grow, dva, 1.f, l8, D);
  }
}

struct ShortPlan {
  int nb, hc, threads;
  unsigned blocks;
  size_t smem;
};

// slices a CTA: as many as 256 threads hold (8 a row), whole samples where
// a sample fits, within SHORT_SMEM of shared memory
ShortPlan short_plan(int N, int H, int Sq, int Sk, int D, bool bwd) {
  const int rows = bwd ? (Sq > Sk ? Sq : Sk) : Sq;
  const int units = (SHORT_THREADS / SG) / rows > 0 ? (SHORT_THREADS / SG) / rows : 1;
  ShortPlan p;
  if (units >= H) {
    p.hc = H;
    p.nb = units / H < N ? units / H : N;
  } else {
    p.hc = units;
    while (H % p.hc) --p.hc;
    p.nb = 1;
  }
  auto bytes = [&](int nb, int hc) {
    size_t f = (size_t)nb * hc * D * (bwd ? 2 * (Sq + Sk) : Sq + 2 * Sk);
    if (bwd) f += 2 * (size_t)nb * hc * Sq * Sk;
    return f * sizeof(float);
  };
  while (bytes(p.nb, p.hc) > SHORT_SMEM) {  // (1, 1) fits: at most 42 KB
    if (p.nb > 1) {
      --p.nb;
    } else {
      --p.hc;
      while (H % p.hc) --p.hc;
    }
  }
  p.smem = bytes(p.nb, p.hc);
  p.threads = p.nb * p.hc * rows * SG;
  p.blocks = (unsigned)((H / p.hc) * ((N + p.nb - 1) / p.nb));
  return p;
}

// ---------------------------------------------------------------------------
// The tiled route: 3xTF32 on mma.sync
// ---------------------------------------------------------------------------

constexpr int TW = 4;        // warps a CTA
constexpr int TT = 32 * TW;  // threads a CTA
constexpr int TB = 16 * TW;  // rows a CTA owns

template <int DK>  // D rounded up to 8 DK
struct Tile {
  static constexpr int DP = 8 * DK;
  static constexpr int LD = DP + 4;  // row pitch in shared memory (floats)
  // keys a forward tile; the other sequence's tile in the backward. Two
  // stages of K and V at D = 160 and 64 keys would not leave room for Q
  static constexpr int BN = DK > 10 ? 32 : 64;
  static constexpr int BB = DK > 10 ? 16 : (DK > 5 ? 32 : 64);
};

// round to nearest, ties away from zero, to TF32 (10 mantissa bits): what
// cvt.rna.tf32.f32 gives a finite x, with two integer operations
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = rna_tf32(x);
  small = rna_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// d += a b to fp32 accuracy: the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], const uint32_t (&bb)[2],
                                     const uint32_t (&bs)[2]) {
  mma_tf32(d, as, bb);
  mma_tf32(d, ab, bs);
  mma_tf32(d, ab, bb);
}

// fragments, for lane (g = lane / 4, t = lane % 4), split into big and small:
// A (16 x 8) from rows r.. r + 15 and columns c.. c + 7 of a row-major tile
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t (&big)[4], uint32_t (&small)[4],
                                       const float* tile, int r, int c, int g, int t) {
  split(tile[(r + g) * LD + c + t], big[0], small[0]);
  split(tile[(r + g + 8) * LD + c + t], big[1], small[1]);
  split(tile[(r + g) * LD + c + t + 4], big[2], small[2]);
  split(tile[(r + g + 8) * LD + c + t + 4], big[3], small[3]);
}
// B (8 x 8) with B[k][n] = tile[r + n][c + k]
template <int LD>
__device__ __forceinline__ void frag_b(uint32_t (&big)[2], uint32_t (&small)[2],
                                       const float* tile, int r, int c, int g, int t) {
  split(tile[(r + g) * LD + c + t], big[0], small[0]);
  split(tile[(r + g) * LD + c + t + 4], big[1], small[1]);
}
// B (8 x 8) with B[k][n] = tile[r + pi(k)][c + n], pi(t) = 2t, pi(t + 4) =
// 2t + 1: the permutation acc_as_a gives the k index
template <int LD>
__device__ __forceinline__ void frag_bt(uint32_t (&big)[2], uint32_t (&small)[2],
                                        const float* tile, int r, int c, int g, int t) {
  split(tile[(r + 2 * t) * LD + c + g], big[0], small[0]);
  split(tile[(r + 2 * t + 1) * LD + c + g], big[1], small[1]);
}
// a 16 x 8 accumulator (rows g, g + 8; columns 2t, 2t + 1) as the A fragment
// of a product over its columns, k permuted by pi
__device__ __forceinline__ void acc_as_a(uint32_t (&big)[4], uint32_t (&small)[4],
                                         const float (&c)[4]) {
  split(c[0], big[0], small[0]);
  split(c[2], big[1], small[1]);
  split(c[1], big[2], small[2]);
  split(c[3], big[3], small[3]);
}

// rows r0 .. r0 + ROWS - 1 of one (n, h) slice of a [N, S, H, D] tensor
// (src: its row 0) into a [ROWS][LD] tile; rows past S and columns past D
// read as 0
template <int DP, int LD>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int r0,
                                          int rows, int S, long long rs, int D, bool vec4) {
  if (vec4) {
    constexpr int C = DP / 4;
    for (int f = threadIdx.x; f < rows * C; f += TT) {
      const int r = f / C, c = (f - r * C) * 4;
      const bool ok = r0 + r < S && c < D;
      cp_async16(dst + r * LD + c, ok ? src + (long long)(r0 + r) * rs + c : src, ok);
    }
  } else {
    for (int f = threadIdx.x; f < rows * DP; f += TT) {
      const int r = f / DP, c = f - r * DP;
      const bool ok = r0 + r < S && c < D;
      cp_async4(dst + r * LD + c, ok ? src + (long long)(r0 + r) * rs + c : src, ok);
    }
  }
}
template <int ROWS, int DP, int LD>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int r0,
                                          int S, long long rs, int D, bool vec4) {
  load_rows<DP, LD>(dst, src, r0, ROWS, S, rs, D, vec4);
}
// n floats of a row vector from r0 (zero past S)
__device__ __forceinline__ void load_vec(float* dst, const float* __restrict__ src, int r0,
                                         int n, int S) {
  for (int f = threadIdx.x; f < n; f += TT) {
    const bool ok = r0 + f < S;
    cp_async4(dst + f, ok ? src + r0 + f : src, ok);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// rows r + g and r + g + 8 of a [16 x 8 DK] accumulator into a [N, S, H, D]
// slice (dst: its row 0), times mul[row]
template <int DK>
__device__ __forceinline__ void store_acc(float* __restrict__ dst, const float (&acc)[DK][4],
                                          const float (&mul)[2], int r, int S, long long rs,
                                          int D, int g, int t) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int s = r + g + 8 * e;
    if (s >= S) continue;
    float* row = dst + (long long)s * rs;
#pragma unroll
    for (int j = 0; j < DK; ++j) {
      const int c = 8 * j + 2 * t;
      if (c < D) row[c] = acc[j][2 * e] * mul[e];
      if (c + 1 < D) row[c + 1] = acc[j][2 * e + 1] * mul[e];
    }
  }
}

// grid (N * H, ceil(Sq / 64)): O and lse of one query tile
template <int DK>
__global__ void __launch_bounds__(TT)
    flash_train_tiled_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, float* __restrict__ o,
                                 float* __restrict__ lse, int H, int Sq, int Sk, int D,
                                 float scale_log2, int vec4) {
  constexpr int DP = Tile<DK>::DP, LD = Tile<DK>::LD, BN = Tile<DK>::BN;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + TB * LD;      // two stages
  float* Vs = Ks + 2 * BN * LD;  // two stages
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nh = blockIdx.x, n = nh / H, h = nh - n * H;
  const int q0 = blockIdx.y * TB, wr = warp * 16;
  const long long rs = (long long)H * D;
  const float* qb = q + ((long long)n * Sq * H + h) * D;
  const float* kb = k + ((long long)n * Sk * H + h) * D;
  const float* vb = v + ((long long)n * Sk * H + h) * D;
  const int tiles = (Sk + BN - 1) / BN;

  load_rows<TB, DP, LD>(Qs, qb, q0, Sq, rs, D, vec4);
  load_rows<BN, DP, LD>(Ks, kb, 0, Sk, rs, D, vec4);
  load_rows<BN, DP, LD>(Vs, vb, 0, Sk, rs, D, vec4);
  cp_async_commit();
  float acc[DK][4] = {};  // O of rows wr + g, wr + g + 8
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  for (int it = 0; it < tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < tiles) {
      load_rows<BN, DP, LD>(Ks + (st ^ 1) * BN * LD, kb, (it + 1) * BN, Sk, rs, D, vec4);
      load_rows<BN, DP, LD>(Vs + (st ^ 1) * BN * LD, vb, (it + 1) * BN, Sk, rs, D, vec4);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and Q) landed; the next may be in flight
    __syncthreads();
    const float* Kt = Ks + st * BN * LD;
    const float* Vt = Vs + st * BN * LD;

    float s[BN / 8][4] = {};  // S = Q K^T: rows wr + g (+ 8), keys 8 j + 2t (+ 1)
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      uint32_t ab[4], as[4];
      frag_a<LD>(ab, as, Qs, wr, 8 * kk, g, t);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        uint32_t bb[2], bs[2];
        frag_b<LD>(bb, bs, Kt, 8 * j, 8 * kk, g, t);
        mma3(s[j], ab, as, bb, bs);
      }
    }
    const int k0 = it * BN;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[j][2 * r + e];
          x = k0 + 8 * j + 2 * t + e < Sk ? x * scale_log2 : -CUDART_INF_F;
          mx = fmaxf(mx, x);
        }
      // key k0 is in range, so the new max is finite
      const float mn = fmaxf(m[r], quad_max(mx));
      const float alpha = exp2f(m[r] - mn);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[j][2 * r + e];
          x = exp2f(x - mn);
          sum += x;
        }
      l[r] = l[r] * alpha + quad_sum(sum);
      m[r] = mn;
#pragma unroll
      for (int j = 0; j < DK; ++j) {
        acc[j][2 * r] *= alpha;
        acc[j][2 * r + 1] *= alpha;
      }
    }
    // O += P V, P from the registers
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      uint32_t ab[4], as[4];
      acc_as_a(ab, as, s[j]);
#pragma unroll
      for (int jd = 0; jd < DK; ++jd) {
        uint32_t bb[2], bs[2];
        frag_bt<LD>(bb, bs, Vt, 8 * j, 8 * jd, g, t);
        mma3(acc[jd], ab, as, bb, bs);
      }
    }
    __syncthreads();  // the next iteration loads into this stage
  }
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    inv[r] = 1.f / l[r];
    const int s = q0 + wr + g + 8 * r;
    if (t == 0 && s < Sq) lse[(long long)nh * Sq + s] = (m[r] + log2f(l[r])) * LN2;
  }
  store_acc<DK>(o + ((long long)n * Sq * H + h) * D, acc, inv, q0 + wr, Sq, rs, D, g, t);
}

// The forward where few CTAs would each walk all keys in turn (D > 80 and
// at most SPLIT_MAX_SK keys: the 16 x 16 and 8 x 8 latents' attentions at
// D = 160). grid (N * H, ceil(Sq / 16)): a CTA owns 16 query rows, K and V
// of its (n, h) whole in shared memory, and its 4 warps split the keys
// (warp w takes the 16-key tiles w, w + 4, ...), each with its own running
// max, sum and O; the four are merged through shared memory at the end
constexpr int SPLIT_MAX_SK = 128;
constexpr int SK_T = 16;  // keys a warp's tile

template <int DK>
__global__ void __launch_bounds__(TT)
    flash_train_tiled_fwd_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                       const float* __restrict__ v, float* __restrict__ o,
                                       float* __restrict__ lse, int H, int Sq, int Sk, int D,
                                       float scale_log2, int vec4) {
  constexpr int DP = Tile<DK>::DP, LD = Tile<DK>::LD;
  extern __shared__ __align__(16) float smem[];
  const int skp = (Sk + SK_T - 1) / SK_T * SK_T;
  float* Qs = smem;            // [16][LD]
  float* Ks = Qs + 16 * LD;    // [skp][LD]
  float* Vs = Ks + skp * LD;   // [skp][LD]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nh = blockIdx.x, n = nh / H, h = nh - n * H;
  const int q0 = blockIdx.y * 16;
  const long long rs = (long long)H * D;
  load_rows<16, DP, LD>(Qs, q + ((long long)n * Sq * H + h) * D, q0, Sq, rs, D, vec4);
  load_rows<DP, LD>(Ks, k + ((long long)n * Sk * H + h) * D, 0, skp, Sk, rs, D, vec4);
  load_rows<DP, LD>(Vs, v + ((long long)n * Sk * H + h) * D, 0, skp, Sk, rs, D, vec4);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float acc[DK][4] = {};
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  for (int k0 = warp * SK_T; k0 < Sk; k0 += TW * SK_T) {
    float s[SK_T / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      uint32_t ab[4], as[4];
      frag_a<LD>(ab, as, Qs, 0, 8 * kk, g, t);
#pragma unroll
      for (int j = 0; j < SK_T / 8; ++j) {
        uint32_t bb[2], bs[2];
        frag_b<LD>(bb, bs, Ks, k0 + 8 * j, 8 * kk, g, t);
        mma3(s[j], ab, as, bb, bs);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < SK_T / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[j][2 * r + e];
          x = k0 + 8 * j + 2 * t + e < Sk ? x * scale_log2 : -CUDART_INF_F;
          mx = fmaxf(mx, x);
        }
      const float mn = fmaxf(m[r], quad_max(mx));  // key k0 is in range
      const float alpha = exp2f(m[r] - mn);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < SK_T / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[j][2 * r + e];
          x = exp2f(x - mn);
          sum += x;
        }
      l[r] = l[r] * alpha + quad_sum(sum);
      m[r] = mn;
#pragma unroll
      for (int j = 0; j < DK; ++j) {
        acc[j][2 * r] *= alpha;
        acc[j][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < SK_T / 8; ++j) {
      uint32_t ab[4], as[4];
      acc_as_a(ab, as, s[j]);
#pragma unroll
      for (int jd = 0; jd < DK; ++jd) {
        uint32_t bb[2], bs[2];
        frag_bt<LD>(bb, bs, Vs, k0 + 8 * j, 8 * jd, g, t);
        mma3(acc[jd], ab, as, bb, bs);
      }
    }
  }
  // merge: each warp's O (unnormalised), max and sum into shared memory (in
  // K's place, which split_smem makes at least 4 x 16 rows), then the four
  // weighted by exp2(m_w - m) / l
  __syncthreads();
  float* part = Ks + warp * 16 * LD;  // [16][LD] a warp
  float* mw = Qs;                     // [4][16], Q's place
  float* lw = Qs + 4 * 16;            // [4][16]
  float* coef = Qs + 8 * 16;          // [4][16]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int j = 0; j < DK; ++j) {
      part[(g + 8 * r) * LD + 8 * j + 2 * t] = acc[j][2 * r];
      part[(g + 8 * r) * LD + 8 * j + 2 * t + 1] = acc[j][2 * r + 1];
    }
    if (t == 0) {
      mw[warp * 16 + g + 8 * r] = m[r];
      lw[warp * 16 + g + 8 * r] = l[r];
    }
  }
  __syncthreads();
  if (threadIdx.x < 16) {
    const int r = threadIdx.x;
    float mx = -CUDART_INF_F, sum = 0.f;
#pragma unroll
    for (int w = 0; w < TW; ++w) mx = fmaxf(mx, mw[w * 16 + r]);  // warp 0 saw key 0
#pragma unroll
    for (int w = 0; w < TW; ++w) sum += lw[w * 16 + r] * exp2f(mw[w * 16 + r] - mx);
#pragma unroll
    for (int w = 0; w < TW; ++w) coef[w * 16 + r] = exp2f(mw[w * 16 + r] - mx) / sum;
    if (q0 + r < Sq) lse[(long long)nh * Sq + q0 + r] = (mx + log2f(sum)) * LN2;
  }
  __syncthreads();
  float* ob = o + ((long long)n * Sq * H + h) * D;
  for (int f = threadIdx.x; f < 16 * D; f += TT) {
    const int r = f / D, c = f - r * D;
    if (q0 + r >= Sq) break;  // rows in order: the rest are past Sq too
    float x = 0.f;
#pragma unroll
    for (int w = 0; w < TW; ++w) x = fmaf(Ks[(w * 16 + r) * LD + c], coef[w * 16 + r], x);
    ob[(long long)(q0 + r) * rs + c] = x;
  }
}

// grid (N * H, ceil(Sq / 64)): delta of one query tile (written for the
// dK/dV kernel), then its dQ
template <int DK>
__global__ void __launch_bounds__(TT)
    flash_train_tiled_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const float* __restrict__ o,
                                const float* __restrict__ dout, const float* __restrict__ lse,
                                float* __restrict__ delta, float* __restrict__ dq, int H, int Sq,
                                int Sk, int D, float scale, float scale_log2, int vec4) {
  constexpr int DP = Tile<DK>::DP, LD = Tile<DK>::LD, BN = Tile<DK>::BB;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + TB * LD;
  float* Ks = dOs + TB * LD;     // two stages
  float* Vs = Ks + 2 * BN * LD;  // two stages
  float* delta_s = Vs + 2 * BN * LD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nh = blockIdx.x, n = nh / H, h = nh - n * H;
  const int q0 = blockIdx.y * TB, wr = warp * 16;
  const long long rs = (long long)H * D;
  const long long qoff = ((long long)n * Sq * H + h) * D, koff = ((long long)n * Sk * H + h) * D;
  const int tiles = (Sk + BN - 1) / BN;

  load_rows<TB, DP, LD>(Qs, q + qoff, q0, Sq, rs, D, vec4);
  load_rows<TB, DP, LD>(dOs, dout + qoff, q0, Sq, rs, D, vec4);
  load_rows<BN, DP, LD>(Ks, k + koff, 0, Sk, rs, D, vec4);
  load_rows<BN, DP, LD>(Vs, v + koff, 0, Sk, rs, D, vec4);
  cp_async_commit();
  float lse2[2], dl[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = q0 + wr + g + 8 * r;
    lse2[r] = s < Sq ? lse[(long long)nh * Sq + s] * LOG2E : 0.f;
  }
  float acc[DK][4] = {};
  for (int it = 0; it < tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < tiles) {
      load_rows<BN, DP, LD>(Ks + (st ^ 1) * BN * LD, k + koff, (it + 1) * BN, Sk, rs, D, vec4);
      load_rows<BN, DP, LD>(Vs + (st ^ 1) * BN * LD, v + koff, (it + 1) * BN, Sk, rs, D, vec4);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) {
      // delta of the warp's 16 rows: dO (shared) . O (device memory)
      for (int r = 0; r < 16; ++r) {
        const int s = q0 + wr + r;
        float x = 0.f;
        if (s < Sq) {
          const float* orow = o + qoff + (long long)s * rs;
          for (int d = lane; d < D; d += 32) x = fmaf(dOs[(wr + r) * LD + d], orow[d], x);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
        if (lane == 0) {
          delta_s[wr + r] = x;
          if (s < Sq) delta[(long long)nh * Sq + s] = x;
        }
      }
      __syncwarp();
      dl[0] = delta_s[wr + g];
      dl[1] = delta_s[wr + g + 8];
    }
    const float* Kt = Ks + st * BN * LD;
    const float* Vt = Vs + st * BN * LD;

    float s[BN / 8][4] = {}, dp[BN / 8][4] = {};  // S = Q K^T, dP = dO V^T
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      uint32_t qb_[4], qs_[4], db[4], ds_[4];
      frag_a<LD>(qb_, qs_, Qs, wr, 8 * kk, g, t);
      frag_a<LD>(db, ds_, dOs, wr, 8 * kk, g, t);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        uint32_t bb[2], bs[2];
        frag_b<LD>(bb, bs, Kt, 8 * j, 8 * kk, g, t);
        mma3(s[j], qb_, qs_, bb, bs);
        frag_b<LD>(bb, bs, Vt, 8 * j, 8 * kk, g, t);
        mma3(dp[j], db, ds_, bb, bs);
      }
    }
    const int k0 = it * BN;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = k0 + 8 * j + 2 * t + (e & 1) < Sk ? exp2f(s[j][e] * scale_log2 - lse2[r])
                                                          : 0.f;
        s[j][e] = p * (dp[j][e] - dl[r]);  // dS
      }
    // dQ += dS K
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      uint32_t ab[4], as[4];
      acc_as_a(ab, as, s[j]);
#pragma unroll
      for (int jd = 0; jd < DK; ++jd) {
        uint32_t bb[2], bs[2];
        frag_bt<LD>(bb, bs, Kt, 8 * j, 8 * jd, g, t);
        mma3(acc[jd], ab, as, bb, bs);
      }
    }
    __syncthreads();
  }
  const float mul[2] = {scale, scale};
  store_acc<DK>(dq + qoff, acc, mul, q0 + wr, Sq, rs, D, g, t);
}

// grid (N * H, ceil(Sk / 64)): dK and dV of one key tile
template <int DK>
__global__ void __launch_bounds__(TT)
    flash_train_tiled_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                  const float* __restrict__ v, const float* __restrict__ dout,
                                  const float* __restrict__ lse, const float* __restrict__ delta,
                                  float* __restrict__ dk, float* __restrict__ dv, int H, int Sq,
                                  int Sk, int D, float scale, float scale_log2, int vec4) {
  constexpr int DP = Tile<DK>::DP, LD = Tile<DK>::LD, BQ = Tile<DK>::BB;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + TB * LD;
  float* Qs = Vs + TB * LD;       // two stages
  float* dOs = Qs + 2 * BQ * LD;  // two stages
  float* lse_s = dOs + 2 * BQ * LD;
  float* delta_s = lse_s + 2 * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nh = blockIdx.x, n = nh / H, h = nh - n * H;
  const int k0 = blockIdx.y * TB, wr = warp * 16;
  const long long rs = (long long)H * D;
  const long long qoff = ((long long)n * Sq * H + h) * D, koff = ((long long)n * Sk * H + h) * D;
  const float* lse_b = lse + (long long)nh * Sq;
  const float* delta_b = delta + (long long)nh * Sq;
  const int tiles = (Sq + BQ - 1) / BQ;

  load_rows<TB, DP, LD>(Ks, k + koff, k0, Sk, rs, D, vec4);
  load_rows<TB, DP, LD>(Vs, v + koff, k0, Sk, rs, D, vec4);
  load_rows<BQ, DP, LD>(Qs, q + qoff, 0, Sq, rs, D, vec4);
  load_rows<BQ, DP, LD>(dOs, dout + qoff, 0, Sq, rs, D, vec4);
  load_vec(lse_s, lse_b, 0, BQ, Sq);
  load_vec(delta_s, delta_b, 0, BQ, Sq);
  cp_async_commit();
  float dka[DK][4] = {}, dva[DK][4] = {};  // keys wr + g (+ 8)
  for (int it = 0; it < tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < tiles) {
      const int r0 = (it + 1) * BQ, o = (st ^ 1) * BQ;
      load_rows<BQ, DP, LD>(Qs + o * LD, q + qoff, r0, Sq, rs, D, vec4);
      load_rows<BQ, DP, LD>(dOs + o * LD, dout + qoff, r0, Sq, rs, D, vec4);
      load_vec(lse_s + o, lse_b, r0, BQ, Sq);
      load_vec(delta_s + o, delta_b, r0, BQ, Sq);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* Qt = Qs + st * BQ * LD;
    const float* dOt = dOs + st * BQ * LD;
    const float* ls = lse_s + st * BQ;
    const float* dls = delta_s + st * BQ;

    // S^T = K Q^T and dP^T = V dO^T: rows keys wr + g (+ 8), columns queries
    float sT[BQ / 8][4] = {}, dpT[BQ / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
      uint32_t kb_[4], ks_[4], vb_[4], vs_[4];
      frag_a<LD>(kb_, ks_, Ks, wr, 8 * kk, g, t);
      frag_a<LD>(vb_, vs_, Vs, wr, 8 * kk, g, t);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        uint32_t bb[2], bs[2];
        frag_b<LD>(bb, bs, Qt, 8 * j, 8 * kk, g, t);
        mma3(sT[j], kb_, ks_, bb, bs);
        frag_b<LD>(bb, bs, dOt, 8 * j, 8 * kk, g, t);
        mma3(dpT[j], vb_, vs_, bb, bs);
      }
    }
    const int q0 = it * BQ;
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 8 * j + 2 * t + (e & 1);
        const float p = q0 + qi < Sq ? exp2f(sT[j][e] * scale_log2 - ls[qi] * LOG2E) : 0.f;
        sT[j][e] = p;                          // P^T
        dpT[j][e] = p * (dpT[j][e] - dls[qi]);  // dS^T
      }
    // dV += P^T dO, dK += dS^T Q
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      uint32_t pb[4], ps[4], sb[4], ss[4];
      acc_as_a(pb, ps, sT[j]);
      acc_as_a(sb, ss, dpT[j]);
#pragma unroll
      for (int jd = 0; jd < DK; ++jd) {
        uint32_t bb[2], bs[2];
        frag_bt<LD>(bb, bs, dOt, 8 * j, 8 * jd, g, t);
        mma3(dva[jd], pb, ps, bb, bs);
        frag_bt<LD>(bb, bs, Qt, 8 * j, 8 * jd, g, t);
        mma3(dka[jd], sb, ss, bb, bs);
      }
    }
    __syncthreads();
  }
  const float one[2] = {1.f, 1.f}, sc[2] = {scale, scale};
  store_acc<DK>(dk + koff, dka, sc, k0 + wr, Sk, rs, D, g, t);
  store_acc<DK>(dv + koff, dva, one, k0 + wr, Sk, rs, D, g, t);
}

template <int DK>
size_t tiled_fwd_smem() {
  return (size_t)(TB + 4 * Tile<DK>::BN) * Tile<DK>::LD * sizeof(float);
}
// Q, then K and V whole (rows padded to 16), at least the 4 x 16 rows the
// merge writes
template <int DK>
size_t split_smem(int Sk) {
  const int skp = (Sk + SK_T - 1) / SK_T * SK_T;
  return (size_t)(16 + (2 * skp > TW * 16 ? 2 * skp : TW * 16)) * Tile<DK>::LD * sizeof(float);
}
template <int DK>
size_t tiled_dq_smem() {
  return ((size_t)(2 * TB + 4 * Tile<DK>::BB) * Tile<DK>::LD + TB) * sizeof(float);
}
template <int DK>
size_t tiled_dkdv_smem() {
  return ((size_t)(2 * TB + 4 * Tile<DK>::BB) * Tile<DK>::LD + 4 * Tile<DK>::BB) * sizeof(float);
}

// dynamic shared memory above 48 KB needs the attribute, once a kernel
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) done = true;
  return err;
}

template <int DK>
int tiled_fwd(const float* q, const float* k, const float* v, float* o, float* lse, int N, int H,
              int Sq, int Sk, int D, float scale, int vec4, cudaStream_t stream) {
  if constexpr (DK == 20) {
    if (Sk <= SPLIT_MAX_SK && (Sq + 15) / 16 <= 65535) {
      static bool attr_split = false;
      cudaError_t err = allow_smem(flash_train_tiled_fwd_split_kernel<DK>,
                                   split_smem<DK>(SPLIT_MAX_SK), attr_split);
      if (err != cudaSuccess) return (int)err;
      flash_train_tiled_fwd_split_kernel<DK>
          <<<dim3(N * H, (Sq + 15) / 16), TT, split_smem<DK>(Sk), stream>>>(
              q, k, v, o, lse, H, Sq, Sk, D, scale * LOG2E, vec4);
      return (int)cudaGetLastError();
    }
  }
  static bool attr = false;
  const size_t smem = tiled_fwd_smem<DK>();
  cudaError_t err = allow_smem(flash_train_tiled_fwd_kernel<DK>, smem, attr);
  if (err != cudaSuccess) return (int)err;
  flash_train_tiled_fwd_kernel<DK><<<dim3(N * H, (Sq + TB - 1) / TB), TT, smem, stream>>>(
      q, k, v, o, lse, H, Sq, Sk, D, scale * LOG2E, vec4);
  return (int)cudaGetLastError();
}

template <int DK>
int tiled_bwd(const float* q, const float* k, const float* v, const float* o, const float* lse,
              const float* dout, float* delta, float* dq, float* dk, float* dv, int N, int H,
              int Sq, int Sk, int D, float scale, int vec4, cudaStream_t stream) {
  static bool attr_q = false, attr_kv = false;
  const size_t smem_q = tiled_dq_smem<DK>(), smem_kv = tiled_dkdv_smem<DK>();
  cudaError_t err = allow_smem(flash_train_tiled_dq_kernel<DK>, smem_q, attr_q);
  if (err == cudaSuccess) err = allow_smem(flash_train_tiled_dkdv_kernel<DK>, smem_kv, attr_kv);
  if (err != cudaSuccess) return (int)err;
  flash_train_tiled_dq_kernel<DK><<<dim3(N * H, (Sq + TB - 1) / TB), TT, smem_q, stream>>>(
      q, k, v, o, dout, lse, delta, dq, H, Sq, Sk, D, scale, scale * LOG2E, vec4);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_train_tiled_dkdv_kernel<DK><<<dim3(N * H, (Sk + TB - 1) / TB), TT, smem_kv, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, H, Sq, Sk, D, scale, scale * LOG2E, vec4);
  return (int)cudaGetLastError();
}

template <int W, int E>
int short_fwd(const float* q, const float* k, const float* v, float* o, float* lse, int N, int H,
              int Sq, int Sk, int D, float scale, cudaStream_t stream) {
  static bool attr = false;
  cudaError_t err = allow_smem(flash_train_short_fwd_kernel<W, E>, SHORT_SMEM, attr);
  if (err != cudaSuccess) return (int)err;
  const ShortPlan p = short_plan(N, H, Sq, Sk, D, false);
  flash_train_short_fwd_kernel<W, E><<<p.blocks, p.threads, p.smem, stream>>>(
      q, k, v, o, lse, N, H, Sq, Sk, D, p.nb, p.hc, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int W, int E>
int short_bwd(const float* q, const float* k, const float* v, const float* o, const float* lse,
              const float* dout, float* dq, float* dk, float* dv, int N, int H, int Sq, int Sk,
              int D, float scale, cudaStream_t stream) {
  static bool attr = false;
  cudaError_t err = allow_smem(flash_train_short_bwd_kernel<W, E>, SHORT_SMEM, attr);
  if (err != cudaSuccess) return (int)err;
  const ShortPlan p = short_plan(N, H, Sq, Sk, D, true);
  flash_train_short_bwd_kernel<W, E><<<p.blocks, p.threads, p.smem, stream>>>(
      q, k, v, o, lse, dout, dq, dk, dv, N, H, Sq, Sk, D, p.nb, p.hc, scale, scale * LOG2E);
  return (int)cudaGetLastError();
}

bool bad_shape(int N, int H, int Sq, int Sk, int D) {
  return N <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || D <= 0 || D > MAX_D ||
         (long long)N * H > 0x7fffffffLL || (Sq + TB - 1) / TB > 65535 ||
         (Sk + TB - 1) / TB > 65535;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// 16-byte copies: every row starts on 16 bytes
bool vec4_ok(int D, std::initializer_list<const void*> ptrs) {
  if (D % 4) return false;
  for (const void* p : ptrs)
    if (!aligned16(p)) return false;
  return true;
}

}  // namespace

// the tiled route's D classes: D padded to 40, 80 or 160 (the model's head
// widths; fewer classes build faster)
#define TILED_CASES(X) X(5) X(10) X(20)

static int tiled_dk(int D) { return D <= 40 ? 5 : D <= 80 ? 10 : 20; }

// o [N, Sq, H, D] and lse [N, H, Sq] are written; every tensor fp32 and
// contiguous. One launch
extern "C" int flash_train_tiled_fwd(const float* q, const float* k, const float* v, float* o,
                                     float* lse, int N, int H, int Sq, int Sk, int D,
                                     float scale, void* stream) {
  if (bad_shape(N, H, Sq, Sk, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int vec4 = vec4_ok(D, {q, k, v});
#define FWD_CASE(c) \
  case c: return tiled_fwd<c>(q, k, v, o, lse, N, H, Sq, Sk, D, scale, vec4, s);
  switch (tiled_dk(D)) {
    TILED_CASES(FWD_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef FWD_CASE
}

// two launches: delta [N, H, Sq] (scratch) with dQ, then dK and dV; dq, dk
// and dv are written in q's, k's and v's layout
extern "C" int flash_train_tiled_bwd(const float* q, const float* k, const float* v,
                                     const float* o, const float* lse, const float* dout,
                                     float* delta, float* dq, float* dk, float* dv, int N, int H,
                                     int Sq, int Sk, int D, float scale, void* stream) {
  if (bad_shape(N, H, Sq, Sk, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int vec4 = vec4_ok(D, {q, k, v, dout});
#define BWD_CASE(c)                                                                         \
  case c:                                                                                   \
    return tiled_bwd<c>(q, k, v, o, lse, dout, delta, dq, dk, dv, N, H, Sq, Sk, D, scale, \
                        vec4, s);
  switch (tiled_dk(D)) {
    TILED_CASES(BWD_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef BWD_CASE
}

// Sq, Sk <= 16: a lane's part of a row is E chunks of 4 floats (D % 4 ==
// 0, rows 16-byte aligned; E = 2, 3, 5 at D = 40, 80, 160) or E single
// floats (any D)
#define SHORT_CASES(X) X(4, 2) X(4, 3) X(4, 5) X(1, 20)

static int short_case(int D, bool vec4) {
  if (!vec4) return 120;
  const int e = (D + 4 * SG - 1) / (4 * SG);
  return e <= 2 ? 402 : e == 3 ? 403 : 405;
}

static bool short_shape(int N, int H, int Sq, int Sk, int D) {
  return N > 0 && H > 0 && Sq > 0 && Sk > 0 && D > 0 && D <= MAX_D && Sq <= SHORT_MAX &&
         Sk <= SHORT_MAX && (long long)N * H <= 0x7fffffffLL;
}

// o and lse as the tiled route writes them, one launch
extern "C" int flash_train_short_fwd(const float* q, const float* k, const float* v, float* o,
                                     float* lse, int N, int H, int Sq, int Sk, int D,
                                     float scale, void* stream) {
  if (!short_shape(N, H, Sq, Sk, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define SFWD_CASE(w, e) \
  case 100 * w + e: return short_fwd<w, e>(q, k, v, o, lse, N, H, Sq, Sk, D, scale, s);
  switch (short_case(D, vec4_ok(D, {q, k, v, o}))) {
    SHORT_CASES(SFWD_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SFWD_CASE
}

// dq, dk and dv in one launch
extern "C" int flash_train_short_bwd(const float* q, const float* k, const float* v,
                                     const float* o, const float* lse, const float* dout,
                                     float* dq, float* dk, float* dv, int N, int H, int Sq,
                                     int Sk, int D, float scale, void* stream) {
  if (!short_shape(N, H, Sq, Sk, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define SBWD_CASE(w, e)                                                                  \
  case 100 * w + e:                                                                      \
    return short_bwd<w, e>(q, k, v, o, lse, dout, dq, dk, dv, N, H, Sq, Sk, D, scale, s);
  switch (short_case(D, vec4_ok(D, {q, k, v, o, dout, dq, dk, dv}))) {
    SHORT_CASES(SBWD_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SBWD_CASE
}
