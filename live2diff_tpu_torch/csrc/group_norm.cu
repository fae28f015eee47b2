// GroupNorm (+ SiLU or ReLU) over [B, T, C] bf16, for Hopper (sm_90a), in one
// launch a call.
//
// Replaces the Pallas TPU kernel live2diff_tpu/ops/norm.py _group_norm_kernel
// (body _kernel, :66-100): per-sample fp32 statistics of each group of C / G
// channels over all T rows, the centred (two-pass) variance, then
//
//   y = x * scale + shift,  scale = rstd * gamma,  shift = beta - mean * scale
//
// and the activation, rounded once to bf16. (The fma form differs from the
// centred (x - mean) * scale + beta by |mean * scale| * 2^-24 at most, far
// below the bf16 rounding of y that sets the 1e-2 tolerance.)
//
// The Pallas kernel holds a whole [T, C] sample in VMEM (grid (B,)). Here a
// sample is up to 6 MB, an SM's shared memory 227 KB. What bounds the
// function is bytes (x read once, y written once: 3.1 us at [2, 4096, 320]),
// but most of the 132 calls of a stream step move under 2 MB, and there the
// launch and the dependent steps of a reduction across CTAs set the time.
// So:
// * One cooperative launch a call (cudaLaunchKernelEx with
//   cudaLaunchAttributeCooperative: CUDA refuses a grid that cannot be
//   resident at once; the launch captures in a CUDA graph), at most one CTA
//   an SM, fewer where the slab is small (ops/norm.py:group_norm_plan: no
//   CTA under 16 KB of x).
// * A sample's rows are cut into k tiles of whole rows (the first T % k of
//   T / k + 1 rows, the rest of T / k; a tile never straddles samples) and
//   each CTA takes a run of consecutive tiles. One lane brings a tile into
//   shared memory with 1-D bulk copies (cp.async.bulk) on an mbarrier: a
//   tile is one contiguous, 16-byte aligned run of x, so no tensor map.
//   gamma and beta come the same way at the start.
// * Statistics: per tile, two exact passes over shared memory (the
//   per-group sum, giving the tile's mean; the centred sum of squares M2
//   about it). Each thread owns one 16-byte column of 8 channels over a
//   share of the rows; the per-channel partials meet in shared memory and
//   L lanes a group fold them (a strided share each, then a butterfly).
//   (mean, M2) of each (tile, group) go to scratch, group-major: every CTA
//   of a sample reads all k x G of them, so a warp's load must take one
//   line a group, not gather one from every tile.
// * cooperative_groups::this_grid().sync(): the one meeting.
//   Then every CTA merges its sample's partials by the exact two-pass
//   combination (mean from the weighted means, then M2 = sum M2_i + n_i
//   (mean_i - mean)^2: no cancellation, one division) in a fixed order:
//   every CTA of a sample holds bit-identical mean and rstd, whatever order
//   the CTAs arrived in.
// * Apply: each thread forms its column's 8 scales and shifts in registers
//   once, then runs over its rows in shared memory (a (row, vector) loop,
//   no division by C / 8), fma, activation (SiLU with __expf and
//   __fdividef), 16-byte stores.
// * No 64-bit division (nvcc makes it a subroutine of ~60 dependent
//   instructions); the host works out the launch's geometry, so a
//   thread's place in a tile costs no division on the device.
// * Residency: a CTA keeps `slots` tile buffers. Where its tiles all fit
//   (every call of a 512x512 stream step on an H100; ops/norm.py counts the
//   route), x is read from device memory once. Where they do not (on an
//   H100, four of prepare's B = 8 shapes: [8, 4096, 640] = 42 MB, [8,
//   1024, 1920], [8, 9216, 256], [8, 36864, 64]; and anything larger), the
//   statistics stream the tiles through the slots
//   (the next tile's copy in flight while one is reduced), the last `slots`
//   tiles stay resident and are applied first, and the others are read
//   again (from L2 where they still are) into the freed slots, one copy
//   ahead.
// Every sum runs in a fixed order given the plan: the same input gives the
// same bits on every call. C % 8 == 0 and C <= 16384 (one row, gamma and
// beta and the statistics' partials fit a CTA), any G dividing C, any B.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;
namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kMaxC = 16384;
constexpr int kMaxSlots = 8;
constexpr int kBarBytes = 128;  // an mbarrier per tile buffer, one for gamma and beta
constexpr uint32_t kCopyPiece = 32768;  // bytes a bulk copy instruction moves
constexpr int kMaxDevices = 64;

// floats of the work area: the statistics' per-slot partials [P][C] and
// group means [G]; then the sample's (mean, rstd) of each group [G][2]
inline int work_floats(int C, int G) {
  const int V = C / 8;
  return (V <= kThreads ? (kThreads / V) * C : C) + G;
}

// dynamic shared memory of a launch: mbarriers, gamma and beta, work area,
// tile buffers (ops/norm.py:_gn_smem_bytes computes the same to plan a
// launch; the launcher checks the plan against it)
inline long long smem_bytes(int C, int G, int slots, int rows) {
  return kBarBytes + 4LL * C + (4LL * work_floats(C, G) + 15) / 16 * 16 + 2LL * slots * rows * C;
}

// a sample's T rows cut into k tiles: the first T % k take q + 1 rows, the
// rest q = T / k (no division on the way: a 64-bit one is a subroutine)
struct Cut {
  int k, q, r;
  __device__ Cut(int T, int k_) : k(k_), q(T / k_), r(T - (T / k_) * k_) {}
  __device__ int begin(int i) const { return i * q + min(i, r); }
  __device__ int rows(int i) const { return q + (i < r); }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed; a wait over 2^32
// clocks (about 2 s) traps, so a fault becomes a launch error, not a hang
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done && clock64() - t0 > (1ll << 32)) __trap();
  } while (!done);
}

// `bytes` (a multiple of 16) from global `src` into shared `dst` by 1-D
// bulk copies completing on `bar`, which expects them; one lane
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  const char* p = reinterpret_cast<const char*>(src);
  for (uint32_t o = 0; o < bytes; o += kCopyPiece) {
    const uint32_t n = bytes - o < kCopyPiece ? bytes - o : kCopyPiece;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(dst + o), "l"(p + o), "r"(n), "r"(bar) : "memory");
  }
}

// tile `tile` (global index: sample tile / k) into the shared buffer `dst`,
// completing on `bar`; one lane
__device__ __forceinline__ void load_tile(const bf16* x, int tile, int T, const Cut& cut, int C,
                                          uint32_t dst, uint32_t bar) {
  const int s = tile / cut.k, i = tile - s * cut.k;
  const uint32_t bytes = (uint32_t)cut.rows(i) * C * 2;
  mbar_expect_tx(bar, bytes);
  bulk_load(dst, x + ((size_t)s * T + cut.begin(i)) * C, bytes, bar);
}

// from channel c in group g at place `at` to channel c + 1
__device__ __forceinline__ void step(int cg, int& g, int& at) {
  if (++at == cg) {
    at = 0;
    ++g;
  }
}

// 8 bf16 of a 16-byte vector as floats; `raw` by value, so that a vector in
// shared memory is read by one 16-byte load (through a reference nvcc reads
// four 4-byte words, each a 4-way bank conflict)
__device__ __forceinline__ void unpack8(const uint4 raw, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return raw;
}

// lanes that share a group's reduction: a power of two up to 32, no more
// than the threads give every group, no more than its items
__host__ __device__ inline int lanes_for(int G, int items) {
  int L = 1;
  while (L < 32 && 2 * L * G <= kThreads && L < items) L *= 2;
  return L;
}

// the sum of v over the L lanes of a group by a butterfly: every lane ends
// with the same bits
__device__ __forceinline__ float group_sum(float v, int L) {
  for (int o = L / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// What every thread's place in a tile follows from, the same for the whole
// launch and worked out on the host (an integer division on the device is
// a chain of ~150 cycles): V = C / 8 16-byte columns; P slots (row
// strides) of V threads when V <= the threads, else one slot whose threads
// take columns col0, col0 + kThreads, ...; cg = C / G; the fold's L lanes a
// group (L = 2^lg) and a lane's stride (dp, dj) over a group's items p *
// cg + j; and reciprocals m = (2^32 - 1) / d + 1 that divide any a < 2^16
// by V or cg exactly as __umulhi(a, m) (m wraps to 0 for d = 1: quot());
// the tile buffers' offset in shared memory.
struct Geom {
  int V, P, cg, L, lg, dp, dj, buf_off;
  unsigned mV, mcg;
};

Geom geom_of(int C, int G) {
  Geom q;
  q.V = C / 8;
  q.cg = C / G;
  q.P = q.V <= kThreads ? kThreads / q.V : 1;
  q.L = lanes_for(G, q.P * q.cg);
  for (q.lg = 0; (1 << q.lg) < q.L; ++q.lg) {
  }
  q.dp = q.L / q.cg;
  q.dj = q.L - q.dp * q.cg;
  q.mV = (unsigned)(0xffffffffu / (unsigned)q.V + 1u);
  q.mcg = (unsigned)(0xffffffffu / (unsigned)q.cg + 1u);
  q.buf_off = (int)smem_bytes(C, G, 0, 0);
  return q;
}

// a / d for 0 <= a < 2^16, given m = (2^32 - 1) / d + 1 (0 for d = 1)
__device__ __forceinline__ int quot(int a, unsigned m) {
  return m ? (int)__umulhi((unsigned)a, m) : a;
}

// A thread's fixed place in every tile: its slot and first column, the
// group and place of that column's first channel, its lane in the fold and
// that lane's first item (p0, j0).
struct Lay {
  int V, P, cg, L, lg, dp, dj, slot, col0, g0, at0, lane, p0, j0;
  unsigned mcg;
  __device__ explicit Lay(const Geom& q)
      : V(q.V), P(q.P), cg(q.cg), L(q.L), lg(q.lg), dp(q.dp), dj(q.dj), mcg(q.mcg) {
    slot = V <= kThreads ? quot(threadIdx.x, q.mV) : 0;
    col0 = V <= kThreads ? threadIdx.x - slot * V : threadIdx.x;
    g0 = quot(col0 * 8, mcg);
    at0 = col0 * 8 - g0 * cg;
    lane = threadIdx.x & (L - 1);
    p0 = quot(lane, mcg);
    j0 = lane - p0 * cg;
  }
  // the group and place of channel col * 8
  __device__ void group_of(int col, int& g, int& at) const {
    if (col == col0) {
      g = g0;
      at = at0;
    } else {
      g = quot(col * 8, mcg);
      at = col * 8 - g * cg;
    }
  }
};

// the sum of each group's P x cg partials red[p][g * cg + j]: L lanes a group
// each sum a strided share in order, then a butterfly (every lane of the
// group ends with the same bits); done(g, sum) on the group's first lane
template <typename F>
__device__ __forceinline__ void fold_groups(const float* red, const Lay& ly, int C, int G,
                                            F done) {
  const int L = ly.L, l = ly.lane, cg = ly.cg, n = ly.P * cg;
  for (int gb = 0; gb < G; gb += kThreads >> ly.lg) {  // the same trip count on every lane
    const int g = gb + (threadIdx.x >> ly.lg);
    float s = 0.f;
    if (g < G) {
      const float* base = red + g * cg;
      int p = ly.p0, j = ly.j0;  // item e = p * cg + j of the group
#pragma unroll 4
      for (int e = l; e < n; e += L) {
        s += base[p * C + j];
        p += ly.dp;
        j += ly.dj;
        if (j >= cg) {
          j -= cg;
          ++p;
        }
      }
    }
    s = group_sum(s, L);
    if (g < G && l == 0) done(g, s);
  }
}

// the (mean, M2) of each group over one resident tile of `rows` rows, into
// part_tile[g * k]; ends with the tile's buffer read (after a barrier, when
// `after_read` runs on thread 0) and the partials written
template <typename F>
__device__ __forceinline__ void tile_stats(const uint4* tile, int rows, const Lay& ly, int C,
                                           int G, int k, float* work, float2* part_tile,
                                           F after_read) {
  const int V = ly.V, P = ly.P, slot = ly.slot, col0 = ly.col0, cg = ly.cg;
  float* red = work;
  float* gmean = work + (V <= kThreads ? P * C : C);
  const float inv_n = 1.f / ((float)rows * (float)cg);

  // pass 1: per-channel sums -> each group's mean over the tile
  if (slot < P) {
    for (int col = col0; col < V; col += kThreads) {
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int r = slot; r < rows; r += P) {
        float f[8];
        unpack8(tile[r * V + col], f);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] += f[j];
      }
      float4* dst = reinterpret_cast<float4*>(red + slot * C + col * 8);
      dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    }
  }
  __syncthreads();
  fold_groups(red, ly, C, G, [&](int g, float s) { gmean[g] = s * inv_n; });
  __syncthreads();

  // pass 2: centred sums of squares about the tile's mean (a 16-byte
  // column may hold channels of two or more groups)
  if (slot < P) {
    for (int col = col0; col < V; col += kThreads) {
      float mean8[8], acc[8];
      int g, at;
      ly.group_of(col, g, at);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mean8[j] = gmean[g];
        acc[j] = 0.f;
        step(cg, g, at);
      }
      for (int r = slot; r < rows; r += P) {
        float f[8];
        unpack8(tile[r * V + col], f);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float d = f[j] - mean8[j];
          acc[j] += d * d;
        }
      }
      float4* dst = reinterpret_cast<float4*>(red + slot * C + col * 8);
      dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    }
  }
  __syncthreads();  // the tile is read: its buffer may take the next copy
  if (threadIdx.x == 0) after_read();
  fold_groups(red, ly, C, G,
              [&](int g, float m2) { part_tile[(size_t)g * k] = make_float2(gmean[g], m2); });
  __syncthreads();  // red and gmean free for the next tile
}

// the (mean, rstd) of each group of sample s from its k tile partials
// (mean, M2; tile i holds cut.rows(i) * cg elements, the sample 1 / inv_n),
// into stats[g]. The
// exact two-pass combination of Chan et al.: mean = sum n_i mean_i / N,
// then M2 = sum M2_i + n_i (mean_i - mean)^2, so no sum cancels and no
// division sits on the chain. L lanes a group: lane l takes tiles l, l + L,
// ... (a group's partials lie in a row, so a warp's load reads one line a
// group), 8 loads in flight, and the lanes meet in butterflies: a fixed
// order, the same in every CTA of the sample, whatever order the CTAs
// arrived in.
__device__ __forceinline__ void sample_stats(const float2* part, int s, const Cut& cut, int G,
                                             int cg, float inv_n, float eps, float2* stats) {
  const int k = cut.k;
  int L = lanes_for(G, k);
  while (L < 32 && 8 * L < k) L *= 2;  // one batch of 8 loads a lane where k allows
  const int lg = __ffs(L) - 1, l = threadIdx.x & (L - 1);
  for (int g0 = 0; g0 < G; g0 += kThreads >> lg) {  // the same trip count on every lane
    const int g = g0 + (threadIdx.x >> lg);
    const float2* src = part + ((size_t)s * G + g) * k;
    float2 p[8];
    float w[8];  // elements of each tile of the batch
    auto load = [&](int i) {  // tiles i, i + L, ..., i + 7 L
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (i + u * L < k) {
          p[u] = __ldcg(src + i + u * L);
          w[u] = (float)(cut.rows(i + u * L) * cg);
        }
    };
    float sum = 0.f;
    if (g < G) {
      for (int i = l; i < k; i += 8 * L) {
        load(i);
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (i + u * L < k) sum += w[u] * p[u].x;
      }
    }
    const float mean = group_sum(sum, L) * inv_n;
    float m2 = 0.f;
    if (g < G) {
      for (int i = l; i < k; i += 8 * L) {
        if (k > 8 * L) load(i);  // else the one batch is still held
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (i + u * L < k) {
            const float d = p[u].x - mean;
            m2 += p[u].y + w[u] * d * d;
          }
      }
    }
    m2 = group_sum(m2, L);
    if (g < G && l == 0) stats[g] = make_float2(mean, rsqrtf(m2 * inv_n + eps));
  }
}

// y = x * scale + shift, then the activation, over one resident tile;
// each thread forms its column's scale = rstd * gamma and shift = beta -
// mean * scale once from the group statistics and gamma, beta (shared)
template <int ACT>
__device__ __forceinline__ void tile_apply(const uint4* tile, int rows, const Lay& ly,
                                           const float2* stats, const uint4* gb, uint4* yt) {
  const int V = ly.V, P = ly.P, slot = ly.slot, col0 = ly.col0, cg = ly.cg;
  if (slot >= P) return;
  for (int col = col0; col < V; col += kThreads) {
    float sc[8], sh[8];
    unpack8(gb[col], sc);      // gamma
    unpack8(gb[V + col], sh);  // beta
    int g, at;
    ly.group_of(col, g, at);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 st = stats[g];
      sc[j] *= st.y;
      sh[j] -= st.x * sc[j];
      step(cg, g, at);
    }
    for (int r = slot; r < rows; r += P) {
      float f[8];
      unpack8(tile[r * V + col], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float v = fmaf(f[j], sc[j], sh[j]);
        if (ACT == 1) v = __fdividef(v, 1.f + __expf(-v));  // SiLU
        if (ACT == 2) v = fmaxf(v, 0.f);                     // ReLU
        f[j] = v;
      }
      yt[(size_t)r * V + col] = pack8(f);
    }
  }
}

// One CTA takes tiles [blockIdx.x * per_cta, +per_cta) of the B * k tiles,
// `slots` of them resident at a time in buffers of rows_max rows.
template <int ACT>
__global__ void __launch_bounds__(kThreads, 1) group_norm_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ gamma, const bf16* __restrict__ beta,
    bf16* __restrict__ y, float2* part, int B, int T, int C, int G, int k, int per_cta,
    int slots, int rows_max, float eps, Geom geom) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint4* gb = reinterpret_cast<const uint4*>(smem + kBarBytes);  // gamma [C], beta [C]
  float* work = reinterpret_cast<float*>(smem + kBarBytes + 4 * C);
  unsigned char* buf0 = smem + geom.buf_off;
  const size_t buf_elems = (size_t)rows_max * C;
  const int t0 = blockIdx.x * per_cta;
  const int m = min(per_cta, B * k - t0);  // this CTA's tiles
  const int S = min(slots, m);             // buffers in use
  const uint32_t bar0 = smem_u32(smem);
  const uint32_t buf0_u32 = smem_u32(buf0);
  auto buf = [&](int j) { return reinterpret_cast<const uint4*>(buf0) + (j % S) * buf_elems / 8; };
  auto buf_addr = [&](int j) { return buf0_u32 + (uint32_t)((j % S) * buf_elems * 2); };
  auto bar = [&](int j) { return bar0 + 8u * (j % S); };
  const Cut cut(T, k);

  const uint32_t bar_gb = bar0 + 8u * kMaxSlots;
  if (threadIdx.x == 0) {
    for (int j = 0; j < S; ++j) mbar_init(bar(j), 1);
    mbar_init(bar_gb, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar_gb, 4 * C);
    bulk_load(smem_u32(gb), gamma, 2 * C, bar_gb);
    bulk_load(smem_u32(gb) + 2 * C, beta, 2 * C, bar_gb);
    for (int j = 0; j < S; ++j) load_tile(x, t0 + j, T, cut, C, buf_addr(j), bar(j));
  }
  const Lay ly(geom);
  const float inv_n = 1.f / ((float)T * (float)ly.cg);  // a group's elements
  __syncthreads();
  uint32_t parity = 0;  // bit j: the phase of buffer j's next completion

  // statistics phase: every tile in order, the copy S tiles ahead in flight
  for (int j = 0; j < m; ++j) {
    const int sj = (t0 + j) / k, ij = t0 + j - sj * k;
    mbar_wait(bar(j), (parity >> (j % S)) & 1);
    parity ^= 1u << (j % S);
    tile_stats(buf(j), cut.rows(ij), ly, C, G, k, work, part + (size_t)sj * G * k + ij, [&]() {
      if (j + S < m) load_tile(x, t0 + j + S, T, cut, C, buf_addr(j), bar(j));
    });
  }

  cg::this_grid().sync();  // every tile's partials are written

  // apply phase: the resident tiles (the last S) first, in reverse; each
  // freed buffer takes the copy of the tile S before
  float2* stats = reinterpret_cast<float2*>(work);
  mbar_wait(bar_gb, 0);
  int sample = -1;
  for (int j = m - 1; j >= 0; --j) {
    const int tile = t0 + j, s = tile / k;
    if (s != sample) {
      sample_stats(part, s, cut, G, ly.cg, inv_n, eps, stats);
      __syncthreads();
      sample = s;
    }
    if (j < m - S) {
      mbar_wait(bar(j), (parity >> (j % S)) & 1);
      parity ^= 1u << (j % S);
    }
    const int i = tile - s * k;
    tile_apply<ACT>(buf(j), cut.rows(i), ly, stats, gb,
                    reinterpret_cast<uint4*>(y + ((size_t)s * T + cut.begin(i)) * C));
    __syncthreads();  // the buffer and the statistics are read
    if (threadIdx.x == 0 && j >= S) load_tile(x, t0 + j - S, T, cut, C, buf_addr(j), bar(j));
  }
}

typedef void (*Kernel)(const bf16*, const bf16*, const bf16*, bf16*, float2*, int, int, int, int,
                       int, int, int, int, float, Geom);

int query(int device, int* sms, int* optin) {
  static int s_sms[kMaxDevices] = {0}, s_optin[kMaxDevices] = {0};
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (s_sms[device] == 0) {
    cudaError_t err = cudaDeviceGetAttribute(&s_optin[device],
                                             cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&s_sms[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) {
      s_sms[device] = 0;
      return (int)err;
    }
  }
  *sms = s_sms[device];
  *optin = s_optin[device];
  return (int)cudaSuccess;
}

}  // namespace

// the SM count and the dynamic shared memory a block may opt into, of
// `device`: what ops/norm.py:group_norm_plan sizes a launch by
extern "C" int group_norm_limits(int device, int* sms, int* smem_optin) {
  return query(device, sms, smem_optin);
}

// x, y [B, T, C] bf16 contiguous; gamma, beta [C] bf16; x, gamma and beta
// 16-byte aligned; part: scratch of B * G * k float2. The plan
// (ops/norm.py:group_norm_plan): k tiles a sample, per_cta tiles a CTA,
// `slots` tile buffers, `ctas` CTAs. act: 0 none, 1 SiLU, 2 ReLU.
extern "C" int group_norm(const void* x, const void* gamma, const void* beta, void* y,
                          void* part, int B, int T, int C, int G, int k, int per_cta, int slots,
                          int ctas, int act, float eps, void* stream) {
  if (B <= 0 || T <= 0 || C <= 0 || C % 8 != 0 || C > kMaxC || G <= 0 || C % G != 0 || k < 1 ||
      k > T || per_cta < 1 || slots < 1 || slots > kMaxSlots || ctas < 1 || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)B * k;
  if (tiles >= (1ll << 31) || (long long)ctas * per_cta < tiles ||
      (long long)(ctas - 1) * per_cta >= tiles)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int rc = query(dev, &sms, &optin);
  if (rc != (int)cudaSuccess) return rc;
  const int rows_max = (T + k - 1) / k;
  const long long smem = smem_bytes(C, G, slots, rows_max);
  if (ctas > sms || smem > optin) return (int)cudaErrorInvalidValue;
  const Kernel kernels[3] = {group_norm_kernel<0>, group_norm_kernel<1>, group_norm_kernel<2>};
  // the shared memory each instance may take, raised only when a call needs more
  static int attr_bytes[3] = {0, 0, 0};
  if (smem > attr_bytes[act]) {
    err = cudaFuncSetAttribute(kernels[act], cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr_bytes[act] = (int)smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernels[act], (const bf16*)x, (const bf16*)gamma,
                           (const bf16*)beta, (bf16*)y, (float2*)part, B, T, C, G, k, per_cta,
                           slots, rows_max, eps, geom_of(C, G));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
