// Stream window attention over the KV cache, for Hopper (sm_90a): one
// template over the cache's element type, two entry points.
//
// Replaces the Pallas TPU kernels live2diff_tpu/ops/stream_attention.py
// stream_window_attention_kernel_int8 (body _kernel_int8; entry
// stream_attention_int8) and stream_window_attention_kernel (body _kernel,
// the bf16 cache; entry stream_attention_bf16). Per (denoising step s,
// head h, spatial position p) the new frame's query attends over the 16
// slots of its temporal window:
//
//   logit[w] = scale * sum_c q[s,p,c] * k[s,w,c,p] * k_scale[s,w,c] + extra[s,w,h,p]
//   prob     = softmax_w(logit)                                  (fp32)
//   out[s,p,c] = sum_w prob[w] * (v[s,w,c,p] * v_scale[s,w,c] + pe_v[s,w,c])
//
// for the channels c of head h. The int8 cache carries per-(slot, channel)
// scales; the bf16 cache has none (k_scale = v_scale = 1). The TPU bf16
// kernel rounds each k*q product to bf16 before its head reduction; this
// one keeps the products in fp32. `extra` holds the positional-encoding
// logits plus the visibility bias (0 / -inf), computed outside the kernel;
// the sink slots are always visible, so no row is all -inf.
//
// What bounds it: memory. Each frame reads the whole cache once, about
// 1.5 GB of int8 (3.0 GB of bf16) over the 40 calls of a 512x512 stream
// step, at ~6 flops a byte: the tensor cores have no part, and the cache
// must stream at the card's bandwidth. The design:
//
// * Tiles of 128-byte rows. A CTA owns P positions of one (step, head), P =
//   128 int8 or 64 bf16, so one (slot, channel) row of the tile is 128
//   bytes. The cache streams through a ring of 4 shared-memory stages, each
//   [16 slots][8 channels][P positions]: the head's K chunks, then its V
//   chunks, in one sequence, so V's first stages are in flight while the
//   last K chunk reduces and the softmax runs, and no barrier stands
//   between issuing the K copies and the V copies.
// * Two staging routes, chosen by the wrapper from the channel stride HW *
//   sizeof(T): where it is a multiple of 16 bytes (every production shape),
//   one TMA box a stage, [16][8][P] of a (HW, C, 16, 2 S) tensor map, zeros
//   past HW, completion on the stage's mbarrier, issued by one thread; else
//   element loads by every thread into the same layout. Both feed the same
//   consumers.
// * No global load waits alone: the q tile's first 16-byte loads are
//   queued ahead of the cache copies, and the visibility rows and the
//   per-(channel, slot) tables arrive by 4-byte cp.async in chunk 0's group.
// * Consumers read shared memory 4 bytes a lane (4 int8 or 2 bf16
//   positions a word, a warp reads one whole row). K pass: warp g takes
//   slots 2g and 2g + 1 of every channel, so each thread holds the full
//   channel sum of its positions x 2 slots in registers and the warps meet
//   once, in a [16][P] logit tile. Softmax: one thread a position, fp32. V
//   pass: warp g takes channel g of each chunk over all 16 slots, the
//   probabilities of its positions in registers. The output goes back
//   through a shared-memory transpose into [S, HW, C], in 16-byte stores
//   where C and the head width are multiples of 8.
// * Enough CTAs at every level. Where (HW / P) x heads x steps CTAs would
//   not fill the SMs (the small latent levels), the wrapper splits the
//   head's channel chunks over a thread-block cluster of 2-8 CTAs. Each sums
//   the partial logits of all the cluster's CTAs from distributed shared
//   memory (every thread a share, all its loads in flight together), in
//   rank order, so all of them hold the same logits, and each writes its own
//   channels' output. Still one launch a call.
// * Fixed reduction order everywhere (no atomics): repeated launches agree
//   bit for bit.
// * Host: the shared-memory attribute is set once per kernel instance (again
//   only for a call that needs more); each TMA call encodes one tensor map
//   (timed, for stream_attention_encode_stats).
//
// int8 codes become floats exactly without the conversion unit: the byte,
// offset by 128, is placed in the mantissa of 2^23 and 2^23 + 128 is
// subtracted.

#include <cooperative_groups.h>
#include <chrono>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "flash_sm90.cuh"  // mbarrier and TMA helpers, the tensor-map encoder

namespace cg = cooperative_groups;

namespace {

using fsm90::encode_fn;
using fsm90::EncodeTiled;
using fsm90::mbar_expect_tx;
using fsm90::mbar_init;
using fsm90::mbar_wait;
using fsm90::smem_u32;
using fsm90::tma_load;

constexpr int kWindow = 16;
constexpr int kThreads = 256;  // 8 warps
constexpr int kChunk = 8;      // channels a stage holds, one per warp in the V pass
constexpr int kRowBytes = 128;
constexpr int kStageBytes = kWindow * kChunk * kRowBytes;  // 16 KB
constexpr int kStages = 4;
constexpr int kMaxCluster = 8;
constexpr int kBatch = 4;  // 16-byte q loads a thread keeps in flight

template <typename T>
struct Tile {
  static constexpr int VPL = 4 / sizeof(T);       // positions a 4-byte word holds
  static constexpr int P = kRowBytes / sizeof(T);  // positions a CTA owns
  static constexpr int QP = P + 4;                 // q / out tile row pitch (bf16)
  static constexpr int TABLES = std::is_same<T, int8_t>::value ? 3 : 1;  // ks, vs, pe | pe
};

// shared-memory layout, bytes: the ring, the logit and probability tiles,
// the per-(channel, slot) tables, the q / out tile, the stages' mbarriers
struct Layout {
  int lg, pr, tables, qt, bar, total;
};

template <typename T>
__host__ __device__ Layout layout(int dl_max) {
  using TL = Tile<T>;
  Layout L;
  L.lg = kStages * kStageBytes;
  L.pr = L.lg + kWindow * TL::P * 4;
  L.tables = L.pr + kWindow * TL::P * 4;
  L.qt = L.tables + TL::TABLES * dl_max * kWindow * 4;
  L.bar = L.qt + ((dl_max * TL::QP * 2 + 15) & ~15);  // one mbarrier a stage
  L.total = L.bar + kStages * 8 + 128;  // and the base's alignment
  return L;
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// one 4-byte word of the tile as floats
__device__ __forceinline__ void unpack(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;  // each byte + 128, as unsigned
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
}
__device__ __forceinline__ void unpack(uint32_t w, float (&f)[2]) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xFFFF0000u);
}

// the tile's q / out row of channel c at this lane's positions
template <int VPL>
__device__ __forceinline__ void load_q(const __nv_bfloat16* row, int lane, float (&f)[VPL]) {
  if constexpr (VPL == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(row + 4 * lane);
    f[0] = __uint_as_float(raw.x << 16);
    f[1] = __uint_as_float(raw.x & 0xFFFF0000u);
    f[2] = __uint_as_float(raw.y << 16);
    f[3] = __uint_as_float(raw.y & 0xFFFF0000u);
  } else {
    unpack(*reinterpret_cast<const uint32_t*>(row + 2 * lane), f);
  }
}

// T: int8_t (scaled) or __nv_bfloat16 (scales == nullptr). TMA: the cache
// is staged by TMA boxes through `tmap`, a (HW, C, W, S * 2) map, else by
// element loads. Grid (tiles x cluster, heads, steps); a cluster of
// `cluster` CTAs shares one tile's channel chunks.
template <typename T, bool TMA>
__global__ void __launch_bounds__(kThreads, 2) stream_attention_kernel(
    const __grid_constant__ CUtensorMap tmap,
    const __nv_bfloat16* __restrict__ q,  // [S, HW, C]  (q + its PE row)
    const T* __restrict__ cache,          // [S, 2, W, C, HW]
    const float* __restrict__ scales,     // [S, 2, W, C], int8 only
    const float* __restrict__ extra,      // [S, W, heads, HW]
    const float* __restrict__ pe_v,       // [S, W, C]
    __nv_bfloat16* __restrict__ out,      // [S, HW, C]
    int C, int HW, int heads, float scale, int cluster, int dl_max) {
  using TL = Tile<T>;
  constexpr int VPL = TL::VPL, P = TL::P, QP = TL::QP;
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // TMA boxes land on 128-byte boundaries
  unsigned char* smem = smem_raw + ((128u - (smem_u32(smem_raw) & 127u)) & 127u);
  const Layout L = layout<T>(dl_max);
  float* lg = reinterpret_cast<float*>(smem + L.lg);  // [16][P] partial logits
  float* pr = reinterpret_cast<float*>(smem + L.pr);  // [16][P] extra, logits, probabilities
  float* pe = reinterpret_cast<float*>(smem + L.tables);  // [dl][16] pe_v
  float* ks = pe + dl_max * kWindow;  // [dl][16] K scale (int8)
  float* vs = ks + dl_max * kWindow;  // [dl][16] V scale (int8)
  __nv_bfloat16* qt = reinterpret_cast<__nv_bfloat16*>(smem + L.qt);  // [dl][QP] q, then out
  const uint32_t bar = smem_u32(smem + L.bar);  // stage i's mbarrier at bar + 8 i

  const int tid = threadIdx.x, lane = tid % 32, g = tid / 32;
  const int rank = blockIdx.x % cluster, tile = blockIdx.x / cluster;
  const int h = blockIdx.y, s = blockIdx.z;
  const int p0 = tile * P;
  const int dh = C / heads;
  const int chunks = (dh + kChunk - 1) / kChunk;
  const int first = rank * chunks / cluster, last = (rank + 1) * chunks / cluster;
  const int c0 = first * kChunk;  // this CTA's channels of the head: [c0, c0 + dl)
  const int dl = min(last * kChunk, dh) - c0;
  const int nch = last - first;
  const int ch0 = h * dh + c0;  // its first channel in C
  const size_t slot = (size_t)C * HW;

  // chunk j of the sequence: K chunks 0..nch-1, then V chunks. TMA: one box
  // of 16 slots x 8 channels x P positions, zeros past HW and C (a last
  // chunk shorter than 8 channels also brings the next head's, unused)
  auto issue = [&](int j) {
    if (j >= 2 * nch) return;
    const int kv = j >= nch, cb = (j - kv * nch) * kChunk;
    unsigned char* st = smem + (j % kStages) * kStageBytes;
    if constexpr (TMA) {
      if (tid == 0) {
        const uint32_t b = bar + 8 * (j % kStages);
        mbar_expect_tx(b, kStageBytes);
        tma_load(smem_u32(st), &tmap, b, p0, ch0 + cb, 0, s * 2 + kv);
      }
    } else {
      const int nc = min(kChunk, dl - cb);
      const T* base = cache + ((size_t)(s * 2 + kv) * kWindow) * slot + (size_t)(ch0 + cb) * HW;
      T* dst = reinterpret_cast<T*>(st);
      for (int i = tid; i < kWindow * kChunk * P; i += kThreads) {
        const int r = i / P, pp = i % P;
        const int w = r / kChunk, cc = r % kChunk, p = p0 + pp;
        dst[i] = cc < nc && p < HW ? base[(size_t)w * slot + (size_t)cc * HW + p] : T{};
      }
    }
  };

  if (TMA && tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(bar + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the q tile, transposed to [channel][position]. With 16-byte loads a
  // thread keeps kBatch of them in flight; the first round is queued ahead
  // of the cache copies.
  const bool vec8 = C % 8 == 0 && dh % 8 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const int groups = dl / 8, nq = vec8 ? P * groups : 0;
  uint4 qraw[kBatch];
  auto fetch_q = [&](int rd) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = (rd * kBatch + u) * kThreads + tid;
      qraw[u] = make_uint4(0, 0, 0, 0);
      if (i < nq && p0 + i / groups < HW)
        qraw[u] = __ldg(reinterpret_cast<const uint4*>(
            q + ((size_t)s * HW + p0 + i / groups) * C + ch0 + (i % groups) * 8));
    }
  };
  auto place_q = [&](int rd) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = (rd * kBatch + u) * kThreads + tid;
      if (i < nq) {
        const int pp = i / groups, cg8 = (i % groups) * 8;
        const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&qraw[u]);
#pragma unroll
        for (int k = 0; k < 8; ++k) qt[(cg8 + k) * QP + pp] = v[k];
      }
    }
  };
  fetch_q(0);

  // the visibility rows (into pr as [16][P], zero past HW) and the
  // per-(channel, slot) tables, by 4-byte cp.async, waited for before
  // chunk 0 is read
  for (int i = tid; i < kWindow * P; i += kThreads) {
    const int w = i / P, p = p0 + i % P;
    const bool valid = p < HW;
    cp_async4(smem_u32(pr + i),
              valid ? extra + ((size_t)(s * kWindow + w) * heads + h) * HW + p : extra, valid);
  }
  for (int i = tid; i < dl * kWindow; i += kThreads) {
    const int w = i / dl, c = i % dl, o = c * kWindow + w;
    cp_async4(smem_u32(pe + o), pe_v + ((size_t)s * kWindow + w) * C + ch0 + c, true);
    if constexpr (kInt8) {
      cp_async4(smem_u32(ks + o), scales + ((size_t)(s * 2 + 0) * kWindow + w) * C + ch0 + c,
                true);
      cp_async4(smem_u32(vs + o), scales + ((size_t)(s * 2 + 1) * kWindow + w) * C + ch0 + c,
                true);
    }
  }
  cp_async_commit();
  for (int j = 0; j < kStages - 1; ++j) issue(j);

  place_q(0);
  const int rounds = (nq + kBatch * kThreads - 1) / (kBatch * kThreads);
  for (int rd = 1; rd < rounds; ++rd) {
    fetch_q(rd);
    place_q(rd);
  }
  if (!vec8) {
    for (int i = tid; i < P * dl; i += kThreads) {
      const int pp = i / dl, c = i % dl;
      qt[c * QP + pp] = p0 + pp < HW ? q[((size_t)s * HW + p0 + pp) * C + ch0 + c]
                                     : __float2bfloat16(0.f);
    }
  }

  float acc[2][VPL];  // K pass: slots 2g, 2g + 1 x this lane's positions
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int k = 0; k < VPL; ++k) acc[i][k] = 0.f;
  float prob[kWindow][VPL];  // V pass: all slots x this lane's positions

  for (int j = 0; j < 2 * nch; ++j) {
    if (j == 0) cp_async_wait<0>();  // the tables and visibility rows
    if constexpr (TMA) mbar_wait(bar + 8 * (j % kStages), (j / kStages) & 1);  // chunk j
    __syncthreads();  // everyone's copies have landed; chunk j - 1 is consumed
    issue(j + kStages - 1);
    const uint32_t* st = reinterpret_cast<const uint32_t*>(smem + (j % kStages) * kStageBytes);
    const bool is_k = j < nch;
    const int cb = (is_k ? j : j - nch) * kChunk, nc = min(kChunk, dl - cb);
    if (is_k) {
      // channel cb + cc of the chunk, this warp's two slots
      auto kstep = [&](int cc) {
        float qf[VPL];
        load_q<VPL>(qt + (cb + cc) * QP, lane, qf);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int w = 2 * g + i;
          float kv[VPL];
          unpack(st[(w * kChunk + cc) * 32 + lane], kv);
          if constexpr (kInt8) {
            const float ksc = ks[(cb + cc) * kWindow + w];
#pragma unroll
            for (int k = 0; k < VPL; ++k) acc[i][k] = fmaf(qf[k] * ksc, kv[k], acc[i][k]);
          } else {
#pragma unroll
            for (int k = 0; k < VPL; ++k) acc[i][k] = fmaf(qf[k], kv[k], acc[i][k]);
          }
        }
      };
      if (nc == kChunk) {
#pragma unroll
        for (int cc = 0; cc < kChunk; ++cc) kstep(cc);
      } else {
        for (int cc = 0; cc < nc; ++cc) kstep(cc);
      }
      if (j == nch - 1) {
        // ---- the warps (and the cluster's CTAs) meet: logits, softmax ----
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int k = 0; k < VPL; ++k) lg[(2 * g + i) * P + VPL * lane + k] = acc[i][k];
        cg::cluster_group cl = cg::this_cluster();
        if (cluster > 1) cl.sync();
        else __syncthreads();
        // each thread sums kPer (slot, position) logits over the cluster's
        // CTAs in rank order (so every CTA gets the same sums), all loads in
        // flight together, and adds them, scaled, to the visibility rows
        constexpr int kPer = kWindow * P / kThreads;
        float part[kPer];
#pragma unroll
        for (int u = 0; u < kPer; ++u) part[u] = 0.f;
#pragma unroll
        for (int r = 0; r < kMaxCluster; ++r) {
          if (r < cluster) {
            const float* src = cluster > 1 ? cl.map_shared_rank(lg, r) : lg;
#pragma unroll
            for (int u = 0; u < kPer; ++u) part[u] += src[u * kThreads + tid];
          }
        }
#pragma unroll
        for (int u = 0; u < kPer; ++u)
          pr[u * kThreads + tid] = fmaf(part[u], scale, pr[u * kThreads + tid]);
        __syncthreads();
        if (tid < P) {  // one thread a position: the softmax over the window, in place
          float l[kWindow];
          float m = -INFINITY;
#pragma unroll
          for (int w = 0; w < kWindow; ++w) {
            l[w] = pr[w * P + tid];
            m = fmaxf(m, l[w]);
          }
          float sum = 0.f;
#pragma unroll
          for (int w = 0; w < kWindow; ++w) {
            l[w] = expf(l[w] - m);
            sum += l[w];
          }
          const float inv = 1.f / sum;
#pragma unroll
          for (int w = 0; w < kWindow; ++w) pr[w * P + tid] = l[w] * inv;
        }
        __syncthreads();
#pragma unroll
        for (int w = 0; w < kWindow; ++w)
#pragma unroll
          for (int k = 0; k < VPL; ++k) prob[w][k] = pr[w * P + VPL * lane + k];
      }
    } else if (g < nc) {
      // ---- V pass: channel cb + g of the chunk, over all 16 slots ----
      const int c = cb + g;
      float o[VPL];
#pragma unroll
      for (int k = 0; k < VPL; ++k) o[k] = 0.f;
#pragma unroll
      for (int w = 0; w < kWindow; ++w) {
        float vv[VPL];
        unpack(st[(w * kChunk + g) * 32 + lane], vv);
        const float pw = pe[c * kWindow + w];
        if constexpr (kInt8) {
          const float vsc = vs[c * kWindow + w];
#pragma unroll
          for (int k = 0; k < VPL; ++k) o[k] = fmaf(prob[w][k], fmaf(vv[k], vsc, pw), o[k]);
        } else {
#pragma unroll
          for (int k = 0; k < VPL; ++k) o[k] = fmaf(prob[w][k], vv[k] + pw, o[k]);
        }
      }
      // the q row of this channel was read by the K pass only: it takes the output
#pragma unroll
      for (int k = 0; k < VPL; ++k) qt[c * QP + VPL * lane + k] = __float2bfloat16(o[k]);
    }
  }
  __syncthreads();

  // ---- the out tile, transposed back to [S, HW, C] ----
  if (vec8) {
    const int groups = dl / 8;
    for (int i = tid; i < P * groups; i += kThreads) {
      const int pp = i / groups, cg8 = (i % groups) * 8;
      if (p0 + pp >= HW) continue;
      uint4 raw;
      __nv_bfloat16* v = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = qt[(cg8 + k) * QP + pp];
      *reinterpret_cast<uint4*>(out + ((size_t)s * HW + p0 + pp) * C + ch0 + cg8) = raw;
    }
  } else {
    for (int i = tid; i < P * dl; i += kThreads) {
      const int pp = i / dl, c = i % dl;
      if (p0 + pp < HW) out[((size_t)s * HW + p0 + pp) * C + ch0 + c] = qt[c * QP + pp];
    }
  }
  // no CTA leaves while another of its cluster may still read its logits
  if (cluster > 1) cg::this_cluster().sync();
}

long long g_encode_ns = 0, g_encode_calls = 0;

template <typename T>
int launch(const void* q, const void* cache, const void* scales, const void* extra,
           const void* pe_v, void* out, int steps, int window, int C, int HW, int heads,
           float scale, int cluster, int tma, void* stream) {
  if (window != kWindow || heads <= 0 || C % heads != 0 || steps <= 0 || HW <= 0)
    return (int)cudaErrorInvalidValue;
  const int dh = C / heads, chunks = (dh + kChunk - 1) / kChunk;
  if (cluster < 1 || cluster > kMaxCluster || cluster > chunks) return (int)cudaErrorInvalidValue;
  CUtensorMap tmap;
  memset(&tmap, 0, sizeof(tmap));
  if (tma) {
    // TMA: 16-byte aligned data and channel stride
    if ((size_t)HW * sizeof(T) % 16 != 0 || reinterpret_cast<uintptr_t>(cache) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    EncodeTiled fn = encode_fn();
    if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
    const auto t0 = std::chrono::steady_clock::now();
    const cuuint64_t dims[4] = {(cuuint64_t)HW, (cuuint64_t)C, (cuuint64_t)kWindow,
                                (cuuint64_t)steps * 2};
    const cuuint64_t row = (cuuint64_t)HW * sizeof(T);
    const cuuint64_t strides[3] = {row, row * C, row * C * kWindow};
    const cuuint32_t box[4] = {(cuuint32_t)Tile<T>::P, kChunk, kWindow, 1};
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    const CUresult r = fn(&tmap,
                          std::is_same<T, int8_t>::value ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                          4, const_cast<void*>(cache), dims, strides, box, elem,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    g_encode_ns += std::chrono::duration_cast<std::chrono::nanoseconds>(
                       std::chrono::steady_clock::now() - t0).count();
    ++g_encode_calls;
    if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  }
  const int dl_max = (chunks + cluster - 1) / cluster * kChunk;
  const Layout L = layout<T>(dl_max);
  auto kernel = tma ? &stream_attention_kernel<T, true> : &stream_attention_kernel<T, false>;
  // the shared memory each instance may take, raised only when a call needs more
  static int attr_bytes[2] = {0, 0};
  int& set_bytes = attr_bytes[tma ? 1 : 0];
  cudaError_t err = cudaSuccess;
  if (L.total > set_bytes) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (err != cudaSuccess) return (int)err;
    set_bytes = L.total;
  }
  const int tiles = (HW + Tile<T>::P - 1) / Tile<T>::P;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * cluster, heads, steps);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, tmap, (const __nv_bfloat16*)q, (const T*)cache,
                           (const float*)scales, (const float*)extra, (const float*)pe_v,
                           (__nv_bfloat16*)out, C, HW, heads, scale, cluster, dl_max);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int stream_attention_int8(
    const void* q, const void* cache, const void* scales, const void* extra,
    const void* pe_v, void* out, int steps, int window, int C, int HW,
    int heads, float scale, int cluster, int tma, void* stream) {
  return launch<int8_t>(q, cache, scales, extra, pe_v, out, steps, window, C, HW, heads,
                        scale, cluster, tma, stream);
}

extern "C" int stream_attention_bf16(
    const void* q, const void* cache, const void* extra, const void* pe_v, void* out,
    int steps, int window, int C, int HW, int heads, float scale, int cluster, int tma,
    void* stream) {
  return launch<__nv_bfloat16>(q, cache, nullptr, extra, pe_v, out, steps, window, C, HW,
                               heads, scale, cluster, tma, stream);
}

// host ns spent encoding tensor maps, and the number of launches that did,
// since the library was loaded
extern "C" long long stream_attention_encode_stats(long long* calls) {
  *calls = g_encode_calls;
  return g_encode_ns;
}
