// Fused 3x3 convolution (stride 1 or 2, padding 1), NHWC bf16, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels live2diff_tpu/ops/conv.py conv3x3_fused
// (stride 1: _conv3x3_impl / _kernel) and conv3x3_s2_fused (stride 2:
// _conv3x3_s2_impl / _kernel_s2), both built here from one template:
//
//   out = act(conv3x3(x, w) + bias + skip)      act = ReLU or identity
//
// with fp32 accumulation, the bias (optional: zero when absent) and the
// residual skip (optional, added before the ReLU) fused into the store.
// These are the TAESD codec's convs: Cout = 64 at 512^2 down to 64^2
// (768x512 down to 96x64), Cin = 64, plus the 3-channel input conv.
//
// What bounds it. At 512^2 and 256^2 the bytes: [2, 512, 512, 64] with a
// skip moves x, skip and out, 201 MB (60 us at 3.35 TB/s), against 38.7
// GFLOP (39 us at 989 TFLOP/s), so the copies and the products must
// overlap. At 128^2 and below the work is a few us: the floor is the
// launch, staging 72 KB of weights once per CTA, and the first tile's
// copy. Staged with one 2-byte load in flight per thread, the weights
// alone take ~45 us (144 round trips in series); here each thread has
// nine 16-byte loads in flight.
//
// Design: an implicit GEMM, M = output pixels, N = Cout = 64, K = 9 taps x
// Cin (padded to KS k-steps of 16 channels). One persistent CTA a SM, 384
// threads:
// * All threads first stage the weights once: w [Cout, Cin, 3, 3] is read
//   in its own order (16-byte loads when Cin % 8 == 0 and w is 16-byte
//   aligned; each thread takes 8 input channels of one output channel, 144
//   contiguous bytes) and written as wgmma's K-major B operand: per tap,
//   64 rows [co] of 128 bytes [ci], 128-byte swizzle (73,728 bytes).
// * Warps 8-11 are the producer. A job is one tile of TH x TW = 4 x 16
//   output pixels (wgmma's M = 64); its input box with the one-pixel halo
//   ((TH - 1) s + 3 rows by (TW - 1) s + 3 columns, 64 channels of 128
//   bytes, 128-byte swizzle) goes into a ring of NS stages (8 at stride 1,
//   4 at stride 2). When Cin % 8 == 0 one lane loads each box by TMA from
//   a (Cin, W, H, B) tensor map at (0, x0 s - 1, y0 s - 1, b): the
//   out-of-bounds fill zeroes the padding, the ragged edges and the
//   channels past Cin, so the padding never exists in device memory. TMA
//   needs 16-byte pixel strides; for other Cin (the RGB input conv) each
//   producer warp stages every fourth job with ordinary loads into the
//   same swizzled layout, channels zero-padded to 16 KS.
// * Warps 0-7 are two consumer warpgroups taking the CTA's jobs in turn,
//   ping-pong: named barriers hand the tensor cores from one to the other
//   once a job's products are issued, so one's epilogue runs while the
//   other's products are in flight. For each tap and k-step a warp
//   gathers its 16 pixels' im2col rows straight from the halo box with
//   ldmatrix.x4 (each lane addresses one pixel, (oy s + dy, ox s + dx),
//   swizzle applied: stride 1 and 2 alike, no copy) and the warpgroup
//   issues wgmma m64n64k16 with A from registers and B the tap's weights:
//   9 KS products a job, a tap's ldmatrix overlapping the previous tap's
//   products. The fp32 accumulator stays in registers through the
//   epilogue: + bias (registers, loaded once) + skip (loaded before the
//   products are waited for), ReLU, bf16 pairs stored straight from the
//   accumulator layout, pixels past Ho or Wo skipped.
// * Host: the shared-memory attribute and the SM count are set once per
//   process; each call encodes one tensor map (timed, for
//   conv3x3_encode_stats).

#include <chrono>
#include <string.h>

#include "flash_sm90.cuh"

namespace {

using namespace fsm90;

constexpr int COUT = 64;
constexpr int TH = 4, TW = 16;                     // output pixels of a job: 64 = wgmma's M
constexpr int kConsumerThreads = 256;              // two warpgroups
constexpr int kThreads = kConsumerThreads + 128;   // and the producer warpgroup
constexpr int W_BYTES = 9 * COUT * 128;            // the weights, 8 KB a tap

template <int S>
struct Box {
  static constexpr int BH = (TH - 1) * S + 3, BW = (TW - 1) * S + 3;
  static constexpr int PIX = BH * BW;
  static constexpr int BYTES = PIX * 128;                       // TMA transaction bytes
  static constexpr int STAGE = (BYTES + 1023) / 1024 * 1024;    // 128-byte swizzle: 1 KB aligned
  // stages: a multiple of 4, so that stage j % NS is always filled by the
  // same producer warp (j % 4) and drained by the same warpgroup (j % 2),
  // each in job order. A waiter is then never two phases ahead of an
  // mbarrier, where its parity would alias (with 3 stages, warpgroup 0
  // could pass job 6's wait on stage 0 while job 3's copy was in flight).
  static constexpr int NS = S == 1 ? 8 : 4;
  static_assert(NS % 4 == 0, "stage ownership");
  static constexpr int SMEM = 1024 + W_BYTES + NS * STAGE + 16 * NS;
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// keeps an A fragment live (unmoved) until the product reading it is waited for
__device__ __forceinline__ void fence_a(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// d (+)= A B, m64n64k16, bf16 in, fp32 accumulate; A from registers, B
// K-major from shared memory (not transposed)
__device__ __forceinline__ void wgmma_rs_kmajor(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// tmap: x as a (Cin, W, H, B) map, boxes (64, BW, BH, 1), 128-byte swizzle
// (encoded only when use_tma); x itself for the other Cin. Jobs are the
// tiles_x * tiles_y * B output tiles ordered (b, tile row, tile column);
// CTA i takes jobs i, i + gridDim.x, ...
template <int S, int KS>
__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_sm90(const __grid_constant__ CUtensorMap tmap, const bf16* __restrict__ x,
                 const bf16* __restrict__ w, const bf16* __restrict__ bias,
                 const bf16* __restrict__ skip, bf16* __restrict__ out, int H, int W, int Cin,
                 int Ho, int Wo, int tiles_x, int tiles_y, int n_tiles, int use_tma, int relu) {
  using BX = Box<S>;
  constexpr int NS = BX::NS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sW = (raw + 1023u) & ~1023u;
  const uint32_t sX = sW + W_BYTES;
  const uint32_t full = sX + NS * BX::STAGE, empty = full + 8 * NS;
  unsigned char* const gW = smem_raw + (sW - raw);  // generic pointer to sW
  unsigned char* const gX = gW + W_BYTES;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int my_jobs = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const bool tma_lane = use_tma && warp == kConsumerThreads / 32 && lane == 0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(full + 8 * i, use_tma ? 1 : 32);  // TMA: one expect_tx; else a warp's lanes
      mbar_init(empty + 8 * i, 4);                // the consumer warpgroup's warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto tile_of = [&](int j, int& b, int& oy0, int& ox0) {
    const int t = (int)blockIdx.x + j * (int)gridDim.x;
    ox0 = t % tiles_x * TW;
    oy0 = t / tiles_x % tiles_y * TH;
    b = t / (tiles_x * tiles_y);
  };
  auto tma_job = [&](int j) {
    const int s = j % NS;
    mbar_wait(empty + 8 * s, ((j / NS) & 1) ^ 1);
    int b, oy0, ox0;
    tile_of(j, b, oy0, ox0);
    mbar_expect_tx(full + 8 * s, BX::BYTES);
    tma_load(sX + s * BX::STAGE, &tmap, full + 8 * s, 0, ox0 * S - 1, oy0 * S - 1, b);
  };
  // the first boxes are in flight while the weights are staged
  const int pre = my_jobs < NS ? my_jobs : NS;
  if (tma_lane)
    for (int j = 0; j < pre; ++j) tma_job(j);

  // ---- weights: w[co][ci][tap] -> [tap][co][ci], 128-byte rows, swizzled ----
  {
    const bool vec = Cin % 8 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
    const unsigned short* wh = reinterpret_cast<const unsigned short*>(w);
    for (int item = threadIdx.x; item < COUT * 2 * KS; item += kThreads) {
      const int co = item / (2 * KS), ch = item % (2 * KS), ci0 = 8 * ch;
      uint32_t v[36];  // bf16 number ci * 9 + tap (ci < 8) in half (k & 1) of v[k / 2]
      if (vec && ci0 < Cin) {
        const uint4* src = reinterpret_cast<const uint4*>(w + ((size_t)co * Cin + ci0) * 9);
#pragma unroll
        for (int i = 0; i < 9; ++i) {
          const uint4 t = __ldg(src + i);
          v[4 * i] = t.x;
          v[4 * i + 1] = t.y;
          v[4 * i + 2] = t.z;
          v[4 * i + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 36; ++i) v[i] = 0u;
#pragma unroll
        for (int k = 0; k < 72; ++k)
          if (ci0 + k / 9 < Cin)
            v[k / 2] |= (uint32_t)__ldg(wh + ((size_t)co * Cin + ci0 + k / 9) * 9 + k % 9)
                        << (16 * (k % 2));
      }
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        uint32_t q[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int k0 = 2 * jj * 9 + tap, k1 = k0 + 9;
          q[jj] = ((v[k0 / 2] >> (16 * (k0 % 2))) & 0xffffu) |
                  (((v[k1 / 2] >> (16 * (k1 % 2))) & 0xffffu) << 16);
        }
        *reinterpret_cast<uint4*>(gW + tap * (COUT * 128) + co * 128 + ((ch ^ (co & 7)) << 4)) =
            make_uint4(q[0], q[1], q[2], q[3]);
      }
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // st.shared, read by wgmma
  __syncthreads();

  if (warp >= kConsumerThreads / 32) {
    // ---- producer ----
    if (use_tma) {
      if (tma_lane)
        for (int j = pre; j < my_jobs; ++j) tma_job(j);
    } else {
      // Cin % 8 != 0: warp pw stages jobs pw, pw + 4, ... with ordinary
      // loads, 16-byte chunks of 8 channels (zero past Cin and outside the image)
      const int pw = warp - kConsumerThreads / 32;
      const unsigned short* xh = reinterpret_cast<const unsigned short*>(x);
      for (int j = pw; j < my_jobs; j += 4) {
        const int s = j % NS;
        mbar_wait(empty + 8 * s, ((j / NS) & 1) ^ 1);
        int b, oy0, ox0;
        tile_of(j, b, oy0, ox0);
        const int iy0 = oy0 * S - 1, ix0 = ox0 * S - 1;
        unsigned char* const st = gX + s * BX::STAGE;
        for (int it = lane; it < BX::PIX * 2 * KS; it += 32) {
          const int p = it / (2 * KS), c = it % (2 * KS);
          const int iy = iy0 + p / BX::BW, ix = ix0 + p % BX::BW;
          uint32_t q[4] = {0u, 0u, 0u, 0u};
          if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
            const unsigned short* src = xh + (((size_t)b * H + iy) * W + ix) * Cin + 8 * c;
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (8 * c + e < Cin) q[e / 2] |= (uint32_t)__ldg(src + e) << (16 * (e % 2));
          }
          *reinterpret_cast<uint4*>(st + p * 128 + ((c ^ (p & 7)) << 4)) =
              make_uint4(q[0], q[1], q[2], q[3]);
        }
        mbar_arrive(full + 8 * s);  // every lane: its stores are released
      }
    }
  } else {
    // ---- two consumer warpgroups, jobs in turn ----
    const int wg = warp / 4, w4 = warp % 4;
    // this lane's ldmatrix row: pixel m of the warp's 16 (rows 0-7 then
    // 8-15), in the lower or upper 8 channels of a k-step. With TW = 16 a
    // warp's 16 pixels are one output row of the tile: row w4, columns 0-15.
    const int m = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int p0 = w4 * S * BX::BW + m * S;  // its box pixel at tap (0, 0)
    const int khalf = lane >> 4;
    // the accumulator's pixels of this thread (columns lane / 4 and + 8 of
    // tile row w4) and its channels 8 g + c0 + {0, 1}
    const int c0 = 2 * (lane % 4);
    float bv[16];
#pragma unroll
    for (int g = 0; g < 8; ++g)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        bv[2 * g + e] = bias ? __bfloat162float(bias[8 * g + c0 + e]) : 0.f;
    // ping-pong: warpgroup g issues a job's products after bar.sync on
    // barrier 1 + g and hands the tensor cores to the other with bar.arrive
    // on 2 - g, so one's epilogue runs while the other's products do.
    // Warpgroup 1 gives 0 the first turn; the CTA's last job hands over to
    // no one, so both barriers see as many arrivals as syncs.
    if (wg == 1) named_arrive(1, kConsumerThreads);

    for (int j = wg; j < my_jobs; j += 2) {
      const int s = j % NS;
      int b, oy0, ox0;
      tile_of(j, b, oy0, ox0);
      const int gy = oy0 + w4;
      bool ok[2];
      size_t ob[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gx = ox0 + lane / 4 + 8 * h;
        ok[h] = gy < Ho && gx < Wo;
        ob[h] = (((size_t)b * Ho + gy) * Wo + gx) * COUT + c0;
      }
      uint32_t sk[16];  // the skip's bf16 pairs, loaded while the products run
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int g = 0; g < 8; ++g)
          sk[8 * h + g] = skip && ok[h]
                              ? __ldg(reinterpret_cast<const unsigned int*>(skip + ob[h] + 8 * g))
                              : 0u;

      mbar_wait(full + 8 * s, (j / NS) & 1);
      named_sync(1 + wg, kConsumerThreads);  // this warpgroup's turn
      const uint32_t st = sX + s * BX::STAGE;
      float acc[32];
      uint32_t a[2][KS][4];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int p = p0 + (tap / 3) * BX::BW + tap % 3;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          ldsm_x4(a[tap & 1][kk], st + p * 128 + (((2 * kk + khalf) ^ (p & 7)) << 4));
        if (tap == 0) fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          wgmma_rs_kmajor(acc, a[tap & 1][kk], sw128_desc(sW + tap * (COUT * 128) + kk * 32, 16, 1024),
                          tap > 0 || kk > 0);
        wgmma_commit();
        if (tap < 8) {
          wgmma_wait<1>();  // the previous tap's products are done: its A registers are free
          if (tap > 0)
#pragma unroll
            for (int kk = 0; kk < KS; ++kk) fence_a(a[(tap - 1) & 1][kk]);
        }
      }
      if (j + 1 < my_jobs) named_arrive(2 - wg, kConsumerThreads);  // the other's turn
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        fence_a(a[0][kk]);
        fence_a(a[1][kk]);
      }
      if (lane == 0) mbar_arrive(empty + 8 * s);  // the producer may refill the stage

      // ---- epilogue from registers: + bias + skip, ReLU, bf16 pairs ----
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!ok[h]) continue;
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          __nv_bfloat162 t;
          memcpy(&t, &sk[8 * h + g], 4);
          const float2 f = __bfloat1622float2(t);  // zero without a skip
          float v0 = acc[4 * g + 2 * h] + bv[2 * g] + f.x;
          float v1 = acc[4 * g + 2 * h + 1] + bv[2 * g + 1] + f.y;
          if (relu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          *reinterpret_cast<uint32_t*>(out + ob[h] + 8 * g) = pack_bf16(v0, v1);
        }
      }
    }
  }
}

long long g_encode_ns = 0, g_encode_calls = 0;

int sm_count(int* sms) {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  *sms = n;
  return 0;
}

template <int S, int KS>
int launch(const void* x, const void* w, const void* bias, const void* skip, void* out, int B,
           int H, int W, int Cin, int Ho, int Wo, int relu, cudaStream_t stream) {
  using BX = Box<S>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(conv3x3_sm90<S, KS>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, BX::SMEM);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  int sms = 0;
  if (int err = sm_count(&sms)) return err;
  const int tiles_x = (Wo + TW - 1) / TW, tiles_y = (Ho + TH - 1) / TH;
  const long long n_tiles = (long long)tiles_x * tiles_y * B;
  if (n_tiles <= 0 || n_tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;

  CUtensorMap tmap;
  memset(&tmap, 0, sizeof(tmap));
  const int use_tma = Cin % 8 == 0;
  if (use_tma) {
    EncodeTiled fn = encode_fn();
    if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
    const auto t0 = std::chrono::steady_clock::now();
    const cuuint64_t dims[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)Cin * 2, (cuuint64_t)W * Cin * 2,
                                   (cuuint64_t)H * W * Cin * 2};
    const cuuint32_t box[4] = {64, (cuuint32_t)BX::BW, (cuuint32_t)BX::BH, 1};
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    const CUresult r = fn(&tmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
                          strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    g_encode_ns += std::chrono::duration_cast<std::chrono::nanoseconds>(
                       std::chrono::steady_clock::now() - t0).count();
    ++g_encode_calls;
    if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  }
  // persistent: one CTA a SM (the shared memory allows no second)
  const int grid = (int)(n_tiles < sms ? n_tiles : sms);
  conv3x3_sm90<S, KS><<<grid, kThreads, BX::SMEM, stream>>>(
      tmap, (const bf16*)x, (const bf16*)w, (const bf16*)bias, (const bf16*)skip, (bf16*)out, H,
      W, Cin, Ho, Wo, tiles_x, tiles_y, (int)n_tiles, use_tma, relu);
  return (int)cudaGetLastError();
}

template <int S>
int dispatch(const void* x, const void* w, const void* bias, const void* skip, void* out, int B,
             int H, int W, int Cin, int Ho, int Wo, int relu, cudaStream_t st) {
  switch ((Cin + 15) / 16) {  // k-steps of 16 channels
    case 1: return launch<S, 1>(x, w, bias, skip, out, B, H, W, Cin, Ho, Wo, relu, st);
    case 2: return launch<S, 2>(x, w, bias, skip, out, B, H, W, Cin, Ho, Wo, relu, st);
    case 3: return launch<S, 3>(x, w, bias, skip, out, B, H, W, Cin, Ho, Wo, relu, st);
    case 4: return launch<S, 4>(x, w, bias, skip, out, B, H, W, Cin, Ho, Wo, relu, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int conv3x3(const void* x, const void* w, const void* bias, const void* skip,
                       void* out, int B, int H, int W, int Cin, int Cout, int stride,
                       int relu, void* stream) {
  if (Cout != COUT || Cin <= 0 || Cin > 64 || B <= 0 || B > 65535 || H <= 0 || W <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (stride == 1) return dispatch<1>(x, w, bias, skip, out, B, H, W, Cin, H, W, relu, st);
  if (stride == 2 && H % 2 == 0 && W % 2 == 0)
    return dispatch<2>(x, w, bias, skip, out, B, H, W, Cin, H / 2, W / 2, relu, st);
  return (int)cudaErrorInvalidValue;
}

// host ns spent encoding tensor maps, and the number of launches that did,
// since the library was loaded
extern "C" long long conv3x3_encode_stats(long long* calls) {
  *calls = g_encode_calls;
  return g_encode_ns;
}
