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
// These are the TAESD codec's convs: 64 channels at 512^2, 256^2, 128^2 and
// 64^2, plus the 3-channel input conv.
//
// What bounds it: at 512^2, Cin = Cout = 64 a call moves x + out + skip,
// about 101 MB (~30 us at 3.35 TB/s) and does 19.3 GFLOP (~20 us at 989
// TFLOP/s): close to balanced, so both the bytes and the MACs must stay on
// the fast path. Design: an implicit GEMM (M = output pixels, N = Cout = 64,
// K = 9 taps x Cin). One persistent block of 8 warps per SM stages all
// 9 x Cin x 64 weights in shared memory once (72 KB at Cin = 64, above the
// 48 KB default, so dynamic shared memory) and walks tiles of TH x 32 output
// pixels with all 64 output channels. For each tile it stages the input
// with its one-pixel halo (zero outside the image: the padding never
// exists in device memory), then each warp runs WMMA bf16 16x16x16
// products: a 16-pixel row segment of one tap
// is a row-major A operand with leading dimension stride x pixel pitch, so
// stride 2 needs no gather. Shared-memory rows are padded by 16 elements
// to spread banks. Cin is zero-padded to a multiple of 16 (3 -> 16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int COUT = 64;
constexpr int TW = 32;        // output tile width (two 16-pixel segments)
constexpr int NWARPS = 8;
constexpr int kThreads = NWARPS * 32;
constexpr int WPITCH = COUT + 16;  // weight row pitch in smem (elements)

template <int STRIDE, int TH>
struct Tile {
  static constexpr int IH = (TH - 1) * STRIDE + 3;  // input rows incl. halo
  static constexpr int IW = (TW - 1) * STRIDE + 3;  // input cols incl. halo
  static constexpr int SEGS = TH * TW / 16 / NWARPS;  // segments per warp
};

template <int STRIDE, int TH>
size_t smem_bytes(int cinp) {
  const int pitch = cinp + 16;
  return (size_t)Tile<STRIDE, TH>::IH * Tile<STRIDE, TH>::IW * pitch * sizeof(bf16)
         + (size_t)9 * cinp * WPITCH * sizeof(bf16)
         + (size_t)NWARPS * 16 * COUT * sizeof(float);
}

template <int STRIDE, int TH>
__global__ void __launch_bounds__(kThreads) conv3x3_kernel(
    const bf16* __restrict__ x,     // [B, H, W, Cin]
    const bf16* __restrict__ w,     // [COUT, Cin, 3, 3]
    const bf16* __restrict__ bias,  // [COUT] or null
    const bf16* __restrict__ skip,  // [B, Ho, Wo, COUT] or null
    bf16* __restrict__ out,         // [B, Ho, Wo, COUT]
    int B, int H, int W, int Cin, int cinp, int Ho, int Wo, int relu) {
  using T = Tile<STRIDE, TH>;
  const int pitch = cinp + 16;  // input pixel pitch in smem (elements)
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);                 // [IH][IW][pitch]
  bf16* ws = xs + T::IH * T::IW * pitch;                        // [9][cinp][WPITCH]
  float* es = reinterpret_cast<float*>(ws + 9 * cinp * WPITCH);  // [NWARPS][16][COUT]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // weights [co][ci][dy][dx] -> ws[tap][ci][co], once per (persistent) block
  for (int i = tid; i < 9 * cinp * COUT; i += kThreads) {
    const int co = i % COUT, ci = (i / COUT) % cinp, tap = i / (COUT * cinp);
    ws[(tap * cinp + ci) * WPITCH + co] =
        ci < Cin ? w[((size_t)co * Cin + ci) * 9 + tap] : __float2bfloat16(0.f);
  }

  const int tiles_x = (Wo + TW - 1) / TW, tiles_y = (Ho + TH - 1) / TH;
  const int ntiles = tiles_x * tiles_y * B;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int b = tile / (tiles_x * tiles_y);
    const int oy0 = (tile / tiles_x) % tiles_y * TH, ox0 = tile % tiles_x * TW;
    const int iy0 = oy0 * STRIDE - 1, ix0 = ox0 * STRIDE - 1;
    __syncthreads();  // the previous tile's reads of xs are done

    // input tile with halo; zero outside the image and in the channel padding
    if (Cin % 8 == 0) {
      const int cpp = cinp / 8;  // 16-byte chunks per pixel
#pragma unroll 4
      for (int i = tid; i < T::IH * T::IW * cpp; i += kThreads) {
        const int c8 = i % cpp, pix = i / cpp;
        const int iy = iy0 + pix / T::IW, ix = ix0 + pix % T::IW;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (iy >= 0 && iy < H && ix >= 0 && ix < W && c8 * 8 < Cin)
          val = *reinterpret_cast<const uint4*>(x + (((size_t)b * H + iy) * W + ix) * Cin + c8 * 8);
        *reinterpret_cast<uint4*>(xs + pix * pitch + c8 * 8) = val;
      }
    } else {
      for (int i = tid; i < T::IH * T::IW * cinp; i += kThreads) {
        const int c = i % cinp, pix = i / cinp;
        const int iy = iy0 + pix / T::IW, ix = ix0 + pix % T::IW;
        bf16 val = __float2bfloat16(0.f);
        if (iy >= 0 && iy < H && ix >= 0 && ix < W && c < Cin)
          val = x[(((size_t)b * H + iy) * W + ix) * Cin + c];
        xs[pix * pitch + c] = val;
      }
    }
    __syncthreads();

    float* ep = es + warp * 16 * COUT;
#pragma unroll
    for (int j = 0; j < T::SEGS; ++j) {
      const int seg = warp + NWARPS * j;  // 16-pixel segment of the tile
      const int oy = seg / (TW / 16), ox = (seg % (TW / 16)) * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[COUT / 16];
#pragma unroll
      for (int n = 0; n < COUT / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        const bf16* arow = xs + ((oy * STRIDE + dy) * T::IW + ox * STRIDE + dx) * pitch;
        for (int kc = 0; kc < cinp; kc += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::load_matrix_sync(a, arow + kc, STRIDE * pitch);
#pragma unroll
          for (int n = 0; n < COUT / 16; ++n) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw;
            wmma::load_matrix_sync(bw, ws + (tap * cinp + kc) * WPITCH + n * 16, WPITCH);
            wmma::mma_sync(acc[n], a, bw, acc[n]);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < COUT / 16; ++n)
        wmma::store_matrix_sync(ep + n * 16, acc[n], COUT, wmma::mem_row_major);
      __syncwarp();

      // epilogue: + bias + skip, ReLU, bf16 store; each lane takes channel
      // pairs (lanes on consecutive pairs), unrolled so the skip loads of
      // several iterations are in flight together
      const int gy = oy0 + oy;
#pragma unroll 4
      for (int i = lane; i < 16 * COUT / 2; i += 32) {
        const int m = i / (COUT / 2), co = 2 * (i % (COUT / 2));
        const int gx = ox0 + ox + m;
        if (gy < Ho && gx < Wo) {
          float2 val = make_float2(ep[m * COUT + co], ep[m * COUT + co + 1]);
          if (bias) {
            const float2 bv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + co));
            val.x += bv.x;
            val.y += bv.y;
          }
          const size_t o = (((size_t)b * Ho + gy) * Wo + gx) * COUT + co;
          if (skip) {
            const float2 sv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(skip + o));
            val.x += sv.x;
            val.y += sv.y;
          }
          if (relu) {
            val.x = fmaxf(val.x, 0.f);
            val.y = fmaxf(val.y, 0.f);
          }
          *reinterpret_cast<__nv_bfloat162*>(out + o) = __float22bfloat162_rn(val);
        }
      }
      __syncwarp();
    }
  }
}

template <int STRIDE, int TH>
int launch(const void* x, const void* w, const void* bias, const void* skip, void* out,
           int B, int H, int W, int Cin, int Ho, int Wo, int relu, cudaStream_t stream) {
  const int cinp = (Cin + 15) / 16 * 16;
  const size_t smem = smem_bytes<STRIDE, TH>(cinp);
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_kernel<STRIDE, TH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // persistent blocks, one per SM (the shared memory allows no second):
  // each stages the weights once and walks the output tiles
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  const long ntiles = (long)((Wo + TW - 1) / TW) * ((Ho + TH - 1) / TH) * B;
  const int grid = (int)(ntiles < sms ? ntiles : sms);
  conv3x3_kernel<STRIDE, TH><<<grid, kThreads, smem, stream>>>(
      (const bf16*)x, (const bf16*)w, (const bf16*)bias, (const bf16*)skip, (bf16*)out,
      B, H, W, Cin, cinp, Ho, Wo, relu);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int conv3x3(const void* x, const void* w, const void* bias, const void* skip,
                       void* out, int B, int H, int W, int Cin, int Cout, int stride,
                       int relu, void* stream) {
  if (Cout != COUT || Cin <= 0 || Cin > 64 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (stride == 1) return launch<1, 8>(x, w, bias, skip, out, B, H, W, Cin, H, W, relu, st);
  if (stride == 2 && H % 2 == 0 && W % 2 == 0)
    return launch<2, 4>(x, w, bias, skip, out, B, H, W, Cin, H / 2, W / 2, relu, st);
  return (int)cudaErrorInvalidValue;
}
