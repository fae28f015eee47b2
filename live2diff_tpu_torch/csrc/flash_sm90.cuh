// The Hopper flash-attention core (sm_90a) that both entries of
// flash_attention.cu run, the d-major entry (replaces the Pallas kernel
// flash_self_attention_dmajor) and the s-major entry (replaces
// flash_self_attention), and that flash_attention_int8.cu runs with an int8
// Q.K (replaces flash_self_attention_int8), live2diff_tpu/ops/flash_attention.py.
//
// What bounds it at the main path's D = 40: not the tensor cores but the
// exponentials. [2, 8, 4096, 40] is 268 M exp2 at 16 a clock per SM (about
// 64 us on 132 SMs) against 43 GFLOP of bf16 products (44 us at 989
// TFLOP/s). So S, P and O stay in registers, each score costs one FFMA and
// one EX2, and the softmax overlaps the tensor cores twice over: two
// consumer warpgroups take the tensor cores in turn (one's softmax runs
// while the other's products are in flight), and within a warpgroup tile
// t's softmax runs while tile t - 1's P.V is in flight.
//
// A persistent CTA of 384 threads (one a SM) walks query tiles of BM = 128
// rows of one (b, h) each:
// * warps 0-7, two consumer warpgroups of 64 rows each (setmaxnreg 240);
// * warps 8-11, the producer warpgroup (setmaxnreg 24). One lane of warp 8
//   issues every copy with TMA (cp.async.bulk.tensor) onto mbarriers: each
//   query tile's Q into one of two buffers (the next tile's Q and first K/V
//   arrive while this tile ends), and K and V tiles of BN keys into a ring
//   of NS stages (3 where D <= 64, else 2: shared memory). An "empty"
//   mbarrier per stage or Q buffer (8 arrivals, one per consumer warp)
//   hands it back. The other three warps exist to give up registers: ptxas
//   gives each thread 168 (65,536 over 384), and setmaxnreg moves 128 x 144
//   of them to the 256 consumer threads (168 -> 240) only if the whole
//   producer warpgroup releases them.
// Tiles in shared memory are rows of 64 bf16 (128 B) with the 128-byte
// swizzle, D cut into DC chunks of 64 columns: D is padded to 64 * DC (40
// -> 64), columns past D and rows past S are TMA's out-of-bounds zeros.
// S = Q K^T is wgmma m64 n(BN) k16, both operands K-major from shared
// memory, over KS = ceil(D / 16) k-steps only (40 -> 3); KS is a template
// argument, since a k-loop with a run-time bound made ptxas serialise the
// wgmma. P is rounded to bf16 in registers and is wgmma's A operand from
// registers; V is the B operand, MN-major (transposed), N = 64 * DC. O is
// fp32 in registers, rescaled in registers. The row max and sum live with
// the four lanes that hold a row (__shfl_xor_sync 1, 2). BN = 128 keys, 64
// at DC = 3 (D up to 160: O takes 96 registers a thread).
//
// Softmax, in the log2 domain: with c = scale * log2(e), m = max(s * c) and
// p = exp2(s * c - m) (one FFMA, one ex2.approx). Keys past the end of a
// block or of Sk are masked before the max.
// * d-major (SMAJOR = false): one block of Sk keys, an online softmax per
//   key tile, as the Pallas d-major kernel's grid updates it per key block.
// * s-major (SMAJOR = true): blocks of block_k keys, p taken against the
//   block's max, as the Pallas kernel and flash_self_attention_plain do.
//   Each block is walked twice: sweep 1 loads K only and keeps a running
//   row max in registers (no exponentials); sweep 2 is the d-major body
//   with m fixed for the block (no rescale inside a block).
// The epilogue writes O * (1 / l) (1 where l == 0) as bf16 from registers,
// rows inside Sq and columns inside D, in the caller's strides.
//
// int8 Q.K (INT8 = true, s-major only): Q and K arrive as int8 codes,
// [B, H, S, DP] with DP = D rounded up to 16, by TMA into the same 128-byte
// swizzled rows (128 codes, 4 k-steps of 32; columns past DP are TMA's
// zeros): a K tile moves half the bf16 bytes from memory, and the ring has
// one more stage. S = Q K^T is wgmma m64 n(BN) k32 s32.s8.s8, both operands
// K-major, over KS = ceil(D / 32) k-steps, exact in s32. The key blocks are
// the key quantisation groups, and a query tile of 128 rows lies in one
// query group, so the factor f = (s_k * s_q) * scale is one fp32 number per
// (tile, block). Sweep 1 keeps the integer row max of S (its min where
// f < 0), two scores an instruction with Hopper's DPX three-way max, and
// takes the block max as float(max) * f. Sweep 2 turns each score into the
// logit float(S) * f (the int becomes a float exactly through the mantissa
// of 1.5 * 2^23: |S| <= 127^2 * 160 < 2^22), rounded as the plain version
// rounds it, before the log2-domain FFMA with c = log2(e).
//
// A wait on an mbarrier that lasts over 2^32 clocks (about 2 s) traps: a
// pipeline fault becomes a launch error, not a hang.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace fsm90 {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;                    // query rows per CTA
constexpr int kConsumerThreads = 256;      // two warpgroups
constexpr int kThreads = kConsumerThreads + 128;  // and the producer warpgroup
// 384 x 168 = 128 x 24 + 256 x 240 registers
constexpr int kRegsConsumer = 240, kRegsProducer = 24;

// DC: chunks of 64 bf16 columns of V (and O); QKC: chunks of 128-byte rows
// of Q and K (64 bf16 or 128 int8 columns each)
template <int DC, int QKC = DC, bool INT8 = false>
struct Cfg {
  static constexpr int BN = DC == 3 ? 64 : 128;                // keys per tile
  static constexpr int NS = (DC == 1 ? 3 : 2) + (INT8 ? 1 : 0);  // K/V stages
  static constexpr int DPAD = 64 * DC;                         // P.V width
  static constexpr int Q_BYTES = BM * 128 * QKC;
  static constexpr int K_BYTES = BN * 128 * QKC;               // one K tile
  static constexpr int V_BYTES = BN * 128 * DC;                // one V tile
  static constexpr int BAR_BYTES = 8 * (4 + 3 * NS);
  // two Q buffers, NS stages of K and V, the mbarriers, 1 KB of alignment
  static constexpr int SMEM = 2 * Q_BYTES + NS * (K_BYTES + V_BYTES) + BAR_BYTES + 1024;
};

// the chunking of a core instance: KS k-steps of Q.K (16 bf16 or 32 int8
// columns each)
template <int KS, bool INT8>
struct Shape {
  static constexpr int DC = INT8 ? (KS + 1) / 2 : (KS + 3) / 4;
  static constexpr int QKC = (KS + 3) / 4;
  using C = Cfg<DC, QKC, INT8>;
};

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  if (done) return;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (clock64() - t0 > (1ll << 32)) __trap();
  } while (!done);
}

// one TMA box of a 4-d map (D, S, H, B) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of wgmma's registers across
// the asynchronous product's issue and wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// d (+)= A B, m64 nN k16, bf16 in, fp32 accumulate. _ss: A and B K-major
// from shared memory; _rs: A from registers, B MN-major from shared memory.
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d);
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<192>(float (&d)[96], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (+)= A B, m64 nN k32, s8 in, s32 accumulate (exact); A and B K-major
// from shared memory, as int8 wgmma requires
template <int N>
__device__ void wgmma_ss_s8(uint32_t (&d)[N / 2], uint64_t da, uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss_s8<64>(uint32_t (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss_s8<128>(uint32_t (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// the sign-adjusted row maxima of the two rows a thread holds (i / 2 even:
// row r, odd: row r + 8); neg flips the sign, so that max(s * c) is
// mx * |c| whatever the sign of c
template <int N>
__device__ __forceinline__ void row_max(const float (&s)[N], bool neg, float& mx0, float& mx1) {
  if (!neg) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if ((i >> 1) & 1) mx1 = fmaxf(mx1, s[i]);
      else mx0 = fmaxf(mx0, s[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if ((i >> 1) & 1) mx1 = fmaxf(mx1, -s[i]);
      else mx0 = fmaxf(mx0, -s[i]);
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// tensor maps: q (box 64 x BM rows), k and v (box 64 x BN rows), each over
// (D, S, H, B) in the caller's strides; with INT8, q and k over the codes
// (DP, S, H, B), boxes of 128 codes. out [b, h, s, d] at the element
// strides o_sb, o_sh, o_ss (unit stride along d). c = scale * log2(e); with
// INT8, c = scale, and q_scales [B, H, Sq / block_q], k_scales
// [B, H, Sk / block_k] are the groups' scales (block_q a multiple of BM, or
// Sq). Sk must be a multiple of block_k (the d-major entry passes block_k =
// Sk). KS k-steps of Q.K (ceil(D / 16) bf16, ceil(D / 32) int8). The grid
// is persistent: CTA i takes query tiles i, i + gridDim.x, ... of the
// B * H * ceil(Sq / BM) tiles, ordered (b, h, query tile).
template <int KS, bool SMAJOR, bool INT8 = false>
__global__ void __launch_bounds__(kThreads, 1)
    flash_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out,
                      long long o_sb, long long o_sh, long long o_ss, int H, int Sq, int Sk,
                      int D, int block_k, int n_tiles, float c,
                      const float* __restrict__ q_scales, const float* __restrict__ k_scales,
                      int block_q) {
  static_assert(SMAJOR || !INT8, "the int8 Q.K runs the s-major walk");
  using C = typename Shape<KS, INT8>::C;
  constexpr int BN = C::BN, NS = C::NS, QKC = Shape<KS, INT8>::QKC, DC = Shape<KS, INT8>::DC;
  constexpr int kQKCols = INT8 ? 128 : 64;  // Q/K columns a 128-byte row holds
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;  // 128-byte swizzle: 1 KB aligned
  const uint32_t sK = sQ + 2 * C::Q_BYTES;
  const uint32_t sV = sK + NS * C::K_BYTES;
  const uint32_t q_full = sV + NS * C::V_BYTES, q_empty = q_full + 16;
  const uint32_t k_full = q_empty + 16, v_full = k_full + 8 * NS, empty = v_full + 8 * NS;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full + 8 * i, 1);
      mbar_init(q_empty + 8 * i, kConsumerThreads / 32);
    }
    for (int i = 0; i < NS; ++i) {
      mbar_init(k_full + 8 * i, 1);
      mbar_init(v_full + 8 * i, 1);
      mbar_init(empty + 8 * i, kConsumerThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the key walk of a query tile: blocks of block_k keys; in each, tiles of
  // BN keys from the block's start (the last may end inside the tile:
  // masked); s-major walks each block twice, K only, then K and V
  const int tiles = (block_k + BN - 1) / BN;
  const int blocks = Sk / block_k;
  constexpr int kSweeps = SMAJOR ? 2 : 1;
  const int q_tiles = (Sq + BM - 1) / BM;

  if (warp >= kConsumerThreads / 32) {
    // ---- producer warpgroup ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegsProducer));
    if (warp == kConsumerThreads / 32 && lane == 0) {
      int job = 0, local = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++local) {
        const int qt = tile % q_tiles, h = (tile / q_tiles) % H, b = tile / (q_tiles * H);
        const int qb = local & 1;  // Q is double-buffered: the next tile's loads early
        mbar_wait(q_empty + 8 * qb, ((local >> 1) & 1) ^ 1);
        mbar_expect_tx(q_full + 8 * qb, C::Q_BYTES);
#pragma unroll
        for (int cc = 0; cc < QKC; ++cc)
          tma_load(sQ + qb * C::Q_BYTES + cc * BM * 128, &tq, q_full + 8 * qb, cc * kQKCols,
                   qt * BM, h, b);
        for (int blk = 0; blk < blocks; ++blk) {
          for (int sweep = 0; sweep < kSweeps; ++sweep) {
            const bool with_v = sweep == kSweeps - 1;
            for (int t = 0; t < tiles; ++t, ++job) {
              const int k0 = blk * block_k + t * BN;
              const int st = job % NS;
              mbar_wait(empty + 8 * st, ((job / NS) & 1) ^ 1);
              mbar_expect_tx(k_full + 8 * st, C::K_BYTES);
#pragma unroll
              for (int cc = 0; cc < QKC; ++cc)
                tma_load(sK + st * C::K_BYTES + cc * BN * 128, &tk, k_full + 8 * st,
                         cc * kQKCols, k0, h, b);
              if (with_v) {
                mbar_expect_tx(v_full + 8 * st, C::V_BYTES);
#pragma unroll
                for (int cc = 0; cc < DC; ++cc)
                  tma_load(sV + st * C::V_BYTES + cc * BN * 128, &tv, v_full + 8 * st, cc * 64,
                           k0, h, b);
              } else {
                mbar_arrive(v_full + 8 * st);  // keeps the stage's V phase in step
              }
            }
          }
        }
      }
    }
  } else {
    // ---- two consumer warpgroups ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegsConsumer));
    const int wg = warp / 4, w = warp % 4;
    const int my_tiles = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
    const int total_jobs = my_tiles * blocks * kSweeps * tiles;
    // ping-pong: warpgroup g issues its products after bar.sync on barrier
    // 1 + g, then lets the other go with bar.arrive on 2 - g; warpgroup 1
    // gives 0 the first turn and skips its last arrive, so both barriers
    // see as many arrivals as syncs
    if (wg == 1) named_arrive(1, kConsumerThreads);
    // the log2-domain multiplier of a score: c, or log2(e) for the int8
    // logits, which carry the scale in f
    const float cq = INT8 ? 1.4426950408889634f : c;
    const bool neg = cq < 0.f;
    const float cabs = fabsf(cq);
    const float masked = neg ? INFINITY : -INFINITY;

    int job = 0, local = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++local) {
      const int qt = tile % q_tiles, h = (tile / q_tiles) % H, b = tile / (q_tiles * H);
      const int qb = local & 1;
      const uint32_t qa = sQ + qb * C::Q_BYTES + wg * 64 * 128;  // this warpgroup's 64 rows
      float o[C::DPAD / 2];
#pragma unroll
      for (int i = 0; i < C::DPAD / 2; ++i) o[i] = 0.f;
      float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
      // the tile's query-group scale (int8): the tile lies in one group
      float s_q = 0.f;
      if (INT8) s_q = q_scales[((size_t)b * H + h) * (Sq / block_q) + qt * BM / block_q];
      mbar_wait(q_full + 8 * qb, (local >> 1) & 1);

      float s[BN / 2];              // the scores of a key tile, then its p in fp32
      uint32_t si[INT8 ? BN / 2 : 1];  // int8: the s32 scores of a key tile
      uint32_t p[BN / 16][4];       // p as bf16 pairs: P.V's A operand

      // Q.K of `jb`'s key tile into s (si): wait for K, take the tensor
      // cores' turn, issue and commit (the caller waits)
      auto issue_qk = [&](int jb) {
        const int st = jb % NS;
        const uint32_t kt = sK + st * C::K_BYTES;
        mbar_wait(k_full + 8 * st, (jb / NS) & 1);
        named_sync(1 + wg, kConsumerThreads);
        if constexpr (INT8) fence_regs(si);
        else fence_regs(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          const uint32_t off = (kk % 4) * 32;  // one k-step: 32 bytes of the 128-byte row
          const uint64_t da = sw128_desc(qa + (kk / 4) * BM * 128 + off, 16, 1024);
          const uint64_t db = sw128_desc(kt + (kk / 4) * BN * 128 + off, 16, 1024);
          if constexpr (INT8) wgmma_ss_s8<BN>(si, da, db, kk > 0);
          else wgmma_ss<BN>(s, da, db, kk > 0);
        }
        wgmma_commit();
      };
      // after the wait for Q.K: its registers settled; int8 scores become
      // the logits float(S) * f
      auto scores_ready = [&](float f) {
        if constexpr (INT8) {
          fence_regs(si);
#pragma unroll
          for (int i = 0; i < BN / 2; ++i)
            s[i] = __fmul_rn(__int_as_float((int)si[i] + 0x4B400000) - 12582912.f, f);
        } else {
          fence_regs(s);
        }
      };
      // ends the turn: the other warpgroup may issue
      auto end_turn = [&](int jb) {
        if (!(wg == 1 && jb == total_jobs - 1)) named_arrive(2 - wg, kConsumerThreads);
      };
      // O += P V of `jb`'s tile: issue and commit (the caller waits)
      auto issue_pv = [&](int jb) {
        const int st = jb % NS;
        const uint32_t vt = sV + st * C::V_BYTES;
        mbar_wait(v_full + 8 * st, (jb / NS) & 1);
#pragma unroll
        for (int j = 0; j < BN / 16; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(p[j][r])::"memory");
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < BN / 16; ++j)
          wgmma_rs<C::DPAD>(o, p[j], sw128_desc(vt + j * 16 * 128, BN * 128, 1024));
        wgmma_commit();
      };
      auto release = [&](int jb) {
        if (lane == 0) mbar_arrive(empty + 8 * (jb % NS));
      };
      // keys at or past nv (the block's or Sk's end) out of the max
      auto mask = [&](int nv) {
        if (nv < BN) {
#pragma unroll
          for (int i = 0; i < BN / 2; ++i)
            if (8 * (i / 4) + 2 * (lane % 4) + (i % 2) >= nv) s[i] = masked;
        }
      };
      // the running max (d-major: per tile; s-major: fixed for the block,
      // a = 1), then p = exp2(s c - m) into s and its fp32 sum into l
      auto softmax = [&](int nv, float& a0, float& a1) {
        mask(nv);
        a0 = a1 = 1.f;
        if (!SMAJOR) {
          float mx0 = -INFINITY, mx1 = -INFINITY;
          row_max(s, neg, mx0, mx1);
          const float mn0 = fmaxf(m0, quad_max(mx0) * cabs);
          const float mn1 = fmaxf(m1, quad_max(mx1) * cabs);
          a0 = ex2(m0 - mn0);
          a1 = ex2(m1 - mn1);
          m0 = mn0;
          m1 = mn1;
          l0 *= a0;
          l1 *= a1;
        }
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const bool hi = (i >> 1) & 1;
          float x = ex2(fmaf(s[i], cq, hi ? -m1 : -m0));
          if (nv < BN && 8 * (i / 4) + 2 * (lane % 4) + (i % 2) >= nv) x = 0.f;
          s[i] = x;
          if (hi) l1 += x;
          else l0 += x;
        }
      };
      auto rescale = [&](float a0, float a1) {
#pragma unroll
        for (int i = 0; i < C::DPAD / 2; ++i) o[i] *= ((i >> 1) & 1) ? a1 : a0;
      };
      auto pack = [&]() {
#pragma unroll
        for (int j = 0; j < BN / 16; ++j) {
          p[j][0] = pack_bf16(s[8 * j + 0], s[8 * j + 1]);
          p[j][1] = pack_bf16(s[8 * j + 2], s[8 * j + 3]);
          p[j][2] = pack_bf16(s[8 * j + 4], s[8 * j + 5]);
          p[j][3] = pack_bf16(s[8 * j + 6], s[8 * j + 7]);
        }
      };

      for (int blk = 0; blk < blocks; ++blk) {
        const int kb0 = blk * block_k, kb1 = kb0 + block_k;
        // int8: the block's logit factor (s_k * s_q) * scale, as the plain
        // version rounds it
        float f = 0.f;
        if (INT8) f = __fmul_rn(__fmul_rn(k_scales[((size_t)b * H + h) * blocks + blk], s_q), c);
        if (SMAJOR) {
          // sweep 1: the block's row max, Q.K only
          float bm0 = -INFINITY, bm1 = -INFINITY;
          if constexpr (INT8) {
            // the integer max of S, or its min where f < 0 (f * S is then
            // largest where S is least), two scores an instruction (the
            // DPX three-way max); masked keys take the identity
            const bool fneg = f < 0.f;
            const int ident = fneg ? INT_MAX : INT_MIN;
            int im0 = ident, im1 = ident;
            for (int t = 0; t < tiles; ++t, ++job) {
              issue_qk(job);
              end_turn(job);
              wgmma_wait<0>();
              fence_regs(si);
              const int nv = kb1 - kb0 - t * BN;
              if (nv < BN) {
#pragma unroll
                for (int i = 0; i < BN / 2; ++i)
                  if (8 * (i / 4) + 2 * (lane % 4) + (i % 2) >= nv) si[i] = (uint32_t)ident;
              }
              if (!fneg) {
#pragma unroll
                for (int i = 0; i < BN / 2; i += 4) {
                  im0 = __vimax3_s32(im0, (int)si[i], (int)si[i + 1]);
                  im1 = __vimax3_s32(im1, (int)si[i + 2], (int)si[i + 3]);
                }
              } else {
#pragma unroll
                for (int i = 0; i < BN / 2; i += 4) {
                  im0 = __vimin3_s32(im0, (int)si[i], (int)si[i + 1]);
                  im1 = __vimin3_s32(im1, (int)si[i + 2], (int)si[i + 3]);
                }
              }
              release(job);
            }
#pragma unroll
            for (int x = 1; x <= 2; x <<= 1) {
              const int o0 = __shfl_xor_sync(0xffffffffu, im0, x);
              const int o1 = __shfl_xor_sync(0xffffffffu, im1, x);
              im0 = fneg ? min(im0, o0) : max(im0, o0);
              im1 = fneg ? min(im1, o1) : max(im1, o1);
            }
            // key kb0 is valid: every row has a finite max
            bm0 = __fmul_rn((float)im0, f);
            bm1 = __fmul_rn((float)im1, f);
          } else {
            for (int t = 0; t < tiles; ++t, ++job) {
              issue_qk(job);
              end_turn(job);
              wgmma_wait<0>();
              fence_regs(s);
              mask(kb1 - kb0 - t * BN);
              row_max(s, neg, bm0, bm1);
              release(job);
            }
            bm0 = quad_max(bm0);
            bm1 = quad_max(bm1);
          }
          const float mn0 = fmaxf(m0, bm0 * cabs);
          const float mn1 = fmaxf(m1, bm1 * cabs);
          const float a0 = ex2(m0 - mn0), a1 = ex2(m1 - mn1);
          m0 = mn0;
          m1 = mn1;
          l0 *= a0;
          l1 *= a1;
          rescale(a0, a1);  // no P.V in flight: the last sweep waited for its own
        }
        // the P.V sweep, software-pipelined: tile t's Q.K is issued with
        // tile t - 1's P.V, and t's softmax runs while that P.V is in flight
        float a0, a1;
        issue_qk(job);
        end_turn(job);
        wgmma_wait<0>();
        scores_ready(f);
        softmax(kb1 - kb0, a0, a1);
        if (!SMAJOR) rescale(a0, a1);
        pack();
        for (int t = 1; t < tiles; ++t) {
          const int jb = job + t;
          issue_qk(jb);
          issue_pv(jb - 1);
          end_turn(jb);
          wgmma_wait<1>();  // Q.K done; P.V of the tile before may still run
          scores_ready(f);
          softmax(kb1 - kb0 - t * BN, a0, a1);
          wgmma_wait<0>();
          fence_regs(o);
          release(jb - 1);
          if (!SMAJOR) rescale(a0, a1);
          pack();
        }
        issue_pv(job + tiles - 1);
        wgmma_wait<0>();
        fence_regs(o);
        release(job + tiles - 1);
        job += tiles;
      }
      if (lane == 0) mbar_arrive(q_empty + 8 * qb);  // the producer may load the tile after next

      // ---- epilogue: O / l as bf16, rows inside Sq, columns inside D ----
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float inv0 = l0 == 0.f ? 1.f : 1.f / l0;
      const float inv1 = l1 == 0.f ? 1.f : 1.f / l1;
      const int row0 = qt * BM + wg * 64 + w * 16 + lane / 4, row1 = row0 + 8;
      bf16* ob = out + b * o_sb + h * o_sh;
#pragma unroll
      for (int g = 0; g < C::DPAD / 8; ++g) {
        const int col = 8 * g + 2 * (lane % 4);
        if (8 * g < D) {
          if (row0 < Sq)
            *reinterpret_cast<__nv_bfloat162*>(ob + row0 * o_ss + col) =
                __floats2bfloat162_rn(o[4 * g] * inv0, o[4 * g + 1] * inv0);
          if (row1 < Sq)
            *reinterpret_cast<__nv_bfloat162*>(ob + row1 * o_ss + col) =
                __floats2bfloat162_rn(o[4 * g + 2] * inv1, o[4 * g + 3] * inv1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host: cuTensorMapEncodeTiled, taken through the runtime's driver entry
// point (nothing links against libcuda); the sources that include this file
// encode their tensor maps with it
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &status);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a flash operand's map: (cols, S, H, B) of bf16 or 1-byte codes at the
// byte strides (s, h, b), boxes of 128 bytes of columns by `rows` rows,
// 128-byte swizzle, zeros out of bounds
inline bool encode_rows(EncodeTiled fn, CUtensorMap* map, bool bytes, const void* ptr, int cols,
                        int S, int H, int B, long long ss, long long sh, long long sb, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss, (cuuint64_t)sh, (cuuint64_t)sb};
  const cuuint32_t box[4] = {bytes ? 128u : 64u, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, bytes ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace fsm90
