// TMA + wgmma int8 matrix products for Hopper (sm_90a): one persistent,
// warp-specialised kernel template shared by three routes.
//
//   int8_gemm.cu, route 1:   out[m, n] = dequant(sum_k A[m, k] * Bt[n, k])
//   int8_conv.cu, route 2:   the same with A the im2col matrix of an NHWC
//                            image, never written to memory (TMA im2col mode)
//   int4_gemm.cu, route 1:   A may hold two int4 codes a byte; the epilogue
//                            adds a packed residual and requantizes
//
// A is [M, K] int8 as the loader presents it, Bt is [N, K] int8 row-major:
// both K-major, the only layout wgmma takes for 8-bit operands, and the
// layout in which the serving path holds them (a channels_last activation, a
// stored weight; a conv weight [O, KH, KW, C] is Bt with K running (kh, kw, c)).
//
// Design.  A persistent grid of blocks, each of two consumer warpgroups and
// one producer warp, walks 128 x BN output tiles (tile t, t + gridDim.x, ...).
// The producer's one thread keeps a ring of kStages shared-memory stages full:
// per stage one TMA load of the A tile (128 rows x BK bytes of K) and one of
// the Bt tile (BN rows x BK bytes), with the swizzle of a BK-byte row (BK =
// 128 or 64), the completion counted in bytes on the stage's `full`
// mbarrier.  TMA's out-of-bounds fill writes zeros, so ragged M, N and K need
// no masking in the main loop: a zero byte adds nothing to the exact int32
// sum.  Each consumer warpgroup owns 64 rows of the tile and runs BK / 32
// wgmma.mma_async.m64nBNk32.s32.s8.s8 per stage (the descriptor's start
// address advanced by 32 bytes inside the swizzle row), its int32 sums in
// registers; after the stage's wgmma group completes, one lane of each
// consumer warp arrives on the stage's `empty` mbarrier and the producer
// refills it.  The ring runs on across tiles, so the producer loads the next
// tile while the consumers run this tile's epilogue.
//
// The A loaders (how a K block of A reaches shared memory):
//   DenseA    a 2-D box of the row-major [M, K] matrix;
//   Im2colA   TMA's im2col mode on the 4-D [N, H, W, C] image: one load
//             fills 128 consecutive output pixels (across image rows and
//             images) with BK channels of one filter tap; padding is the
//             map's corners and TMA's zero fill (exact at zero point 0), the
//             stride the map's traversal stride;
//   PackedA   [M, K/2] bytes, two int4 codes a byte in the group-local
//             split-half layout (int4_gemm.cu): byte j of a 128-byte group
//             row holds code j of one 128-code K block in its low nibble and
//             code j of the next in its high nibble.  So one 128-byte box
//             with the 128-byte swizzle unpacks byte for byte into two K
//             blocks with the same swizzle: the producer loads it into the
//             second stage of a pair, each consumer warpgroup sign-extends
//             its 64 rows in place (low nibbles to the first stage, high to
//             the second), fences the generic-proxy writes for the async
//             proxy and runs wgmma.  Every packed byte is read once.
//
// BN (64, 128 or 256) and the ring are picked per route and shape at launch.
// The launch set-up that does not depend on the pointers (the card's SMs,
// the kernel's shared-memory attribute, its occupancy) is done once per
// kernel instance and device; the tensor maps hold the pointers and are
// encoded per call.
//
// Accumulator layout of wgmma m64nN with 32-bit sums (not mma.sync's 16 x 8
// tile per warp): warp w of the warpgroup holds rows 16w .. 16w + 15; lane l
// holds, for each 8-column slab j, d[4j + 0] at (row 16w + l/4, column
// 8j + 2(l%4)), d[4j + 1] one column right, d[4j + 2] and d[4j + 3] the same
// two columns eight rows down.
//
// The dequant epilogue (DequantOut, for the GEMM and the conv): dequant
// (int8_mma.cuh) per element, regrouped into 16-byte chunks: for float32 the
// two lanes of a pair swap one row's two values by a shuffle, so each lane
// holds four consecutive columns of one row; for bfloat16 the four lanes of a
// quad transpose their four 32-bit words (two slabs x two rows), so each lane
// holds eight consecutive columns of one row.  Where each output row is a
// multiple of 16 bytes and BN <= 128 (the memory-bound shapes, which write far
// more than they read), the chunks go to a staging buffer in shared memory
// and TMA stores write them out, clipped to M and N: the write-heavy shapes
// ran at a fraction of the memory rate with stores from the threads.
// Otherwise (BN = 256, or rows that are not a multiple of 16 bytes) each lane
// stores its chunks itself, element by element beyond N, and rows beyond M are
// not stored.  With a residual in (int8_mma.cuh), each value adds its code
// first.  With codes out, each lane requantizes its two columns of each row
// of a slab into one 16-bit pair; where the output rows are a multiple of 16
// bytes and BN <= 128, the pairs go into one staging box of 64 rows x BN bytes
// with the swizzle of that width and one TMA store writes them out, else each
// lane stores its pairs.  Codes out with a residual in load the residual's
// box of each tile by TMA a tile ahead, into one of two slots beside the
// staging box (an mbarrier each), so each lane reads its pair's residual
// codes from shared memory; without the box (ragged rows, a misaligned
// residual) each lane reads them from memory.  Both features take 64-column
// tiles (DequantOut::kColumnsFirst).
//
// Numerics as the mma.sync routes: exact int32 sums, __fmul_rn then __fadd_rn
// then fmaxf then the cast or the codes (rintf(__fdiv_rn(v, s)), clamped),
// built with --fmad=false.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder itself comes from the driver at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_mma.cuh"

namespace cnnq {
namespace wg {

constexpr int kBM = 128;                       // tile rows: two consumer warpgroups of 64
constexpr int kBK = 128;                       // bytes of K per stage: one 128-byte swizzle row
constexpr int kConsumerWarps = 8;
constexpr int kThreads = kConsumerWarps * 32 + 32;  // + the producer warp

constexpr int kMaxDevices = 64;

// A ring: the tile width, its stages, the blocks an SM it is built for and
// the bytes of K a stage holds (128, or 64 with the 64-byte swizzle)
template <int BN, int STAGES, int MIN_BLOCKS, int BK = kBK>
struct Ring {
  static constexpr int kBN = BN, kStages = STAGES, kMinBlocks = MIN_BLOCKS, kBK = BK;
};

// the int8 GEMM's and the conv's rings for each tile width; the narrow tiles
// leave room for two blocks an SM beside their staging buffers
template <int BN>
struct Tile;
template <>
struct Tile<64> : Ring<64, 3, 2> {};
template <>
struct Tile<128> : Ring<128, 2, 2> {};
template <>
struct Tile<256> : Ring<256, 4, 1> {};

// The output staging of one consumer warpgroup (BN <= 128, rows a multiple
// of 16 bytes): its 64 rows of the tile in passes of up to two TMA store
// boxes, each box 64 rows x 128 bytes with the 128-byte swizzle (16-byte
// chunk c of row r lies at chunk c ^ (r % 8)), written out by TMA stores.
template <int BN, typename OutT>
struct Staging {
  static constexpr bool kOn = BN <= 128;
  static constexpr int kBoxCols = 128 / static_cast<int>(sizeof(OutT));
  static constexpr int kPassCols = BN < 2 * kBoxCols ? BN : 2 * kBoxCols;
  static constexpr int kBoxes = kPassCols / kBoxCols;
  static constexpr int kPasses = BN / kPassCols;
  static constexpr int kBytes = kOn ? kBoxes * 64 * 128 : 0;
};

template <typename R, typename Epi>
constexpr size_t smem_bytes() {
  // the stages, the two warpgroups' staging buffers, two mbarriers a stage,
  // and slack to align the stages to the 1024-byte swizzle atom
  return static_cast<size_t>(R::kStages) * (kBM + R::kBN) * R::kBK +
         2 * static_cast<size_t>(Epi::template staging_bytes<R::kBN>()) + 16 * R::kStages + 32 + 1024;
}

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

// spin until the phase of parity `parity` has completed.  A wait of more
// than 2^34 cycles (seconds) can only be a deadlock: it traps, so the launch
// fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long start = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1LL << 34)) asm volatile("trap;");
  } while (!done);
}

// one 2-D box of `map` at (inner coordinate c0, row c1) into shared memory
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// one im2col box of a 4-D [N, H, W, C] map: 128 output pixels from the one
// at input position (n, h, w) on (the map's traversal stride apart), channels
// c .. c + BK - 1 of filter tap (kh, kw) = the offsets
__device__ __forceinline__ void tma_load_im2col_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                                   int c, int w, int h, int n, uint16_t off_w,
                                                   uint16_t off_h) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(w), "r"(h), "r"(n), "h"(off_w),
      "h"(off_h)
      : "memory");
}

// wgmma descriptor of a K-major tile written by TMA with the swizzle of a
// bk-byte row (bk = 128: SWIZZLE_128B, 8-row atoms of 1024 bytes; bk = 64:
// SWIZZLE_64B, 8-row atoms of 512 bytes), atoms stacked along M or N
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, int bk) {
  uint64_t d = (addr & 0x3FFFFu) >> 4;                         // start address, 16-byte units
  d |= static_cast<uint64_t>(1) << 16;                          // leading byte offset: unused here
  d |= static_cast<uint64_t>((8 * bk) >> 4) << 32;              // stride byte offset: the next atom
  d |= static_cast<uint64_t>(bk == 128 ? 1 : 2) << 62;          // layout: 128- or 64-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses to the sums across the asynchronous wgmma
template <int R>
__device__ __forceinline__ void fence_sums(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D (+)= A(64 x 32, K-major, shared) * B(32 x N, K-major, shared), s8 x s8 -> s32;
// scale_d = 0 overwrites D
__device__ __forceinline__ void wgmma_m64n64k32(int (&d)[32], uint64_t da, uint64_t db,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], uint64_t da, uint64_t db,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n256k32(int (&d)[128], uint64_t da, uint64_t db,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(int (&d)[BN / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (BN == 64) {
    wgmma_m64n64k32(d, da, db, scale_d);
  } else if constexpr (BN == 128) {
    wgmma_m64n128k32(d, da, db, scale_d);
  } else {
    wgmma_m64n256k32(d, da, db, scale_d);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Regroups one consumer warpgroup's sums of slabs j0 .. j1 - 1 (8 columns
// each; j0, j1 even) into 16-byte chunks of values val(sum, r, col) (r the row
// inside the warpgroup's 64, col the output column) and calls emit(row, col,
// chunk) for each chunk of this lane: row inside the warpgroup's 64, col the
// tile column of the chunk's first value.  float32: the two lanes of a pair
// swap one row's two values by a shuffle, so a lane holds four consecutive
// columns of one row; bfloat16: the four lanes of a quad transpose their four
// 32-bit words (two slabs x two rows), so a lane holds eight consecutive
// columns of one row.  Every lane must call it.
template <typename OutT, int BN, typename Val, typename Emit>
__device__ __forceinline__ void regroup(const int (&acc)[BN / 2], int n0, int j0, int j1, Val val,
                                        Emit emit) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int rl = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  if constexpr (sizeof(OutT) == 4) {
    const bool even = (t & 1) == 0;
#pragma unroll
    for (int j = j0; j < j1; ++j) {
      const int c = n0 + 8 * j + 2 * t;
      const float v0 = val(acc[4 * j + 0], rl, c);
      const float v1 = val(acc[4 * j + 1], rl, c + 1);
      const float v2 = val(acc[4 * j + 2], rl + 8, c);
      const float v3 = val(acc[4 * j + 3], rl + 8, c + 1);
      // the even lane keeps row rl and takes its partner's two columns of rl;
      // the odd lane keeps row rl + 8 and takes its partner's of rl + 8
      const float q0 = __shfl_xor_sync(0xffffffffu, even ? v2 : v0, 1);
      const float q1 = __shfl_xor_sync(0xffffffffu, even ? v3 : v1, 1);
      const float4 v = even ? make_float4(v0, v1, q0, q1) : make_float4(q0, q1, v2, v3);
      emit(even ? rl : rl + 8, 8 * j + 2 * t - (even ? 0 : 2),
           make_uint4(__float_as_uint(v.x), __float_as_uint(v.y), __float_as_uint(v.z),
                      __float_as_uint(v.w)));
    }
  } else {
#pragma unroll
    for (int j = j0; j < j1; j += 2) {
      // word k of this lane: (row rl + 8 (k & 1), slab j + (k >> 1)), its two columns
      uint32_t w[4];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int c = n0 + 8 * (j + s) + 2 * t;
        const int* a = &acc[4 * (j + s)];
        w[2 * s] = pack_bf16(val(a[0], rl, c), val(a[1], rl, c + 1));
        w[2 * s + 1] = pack_bf16(val(a[2], rl + 8, c), val(a[3], rl + 8, c + 1));
      }
      // lane t ends with word t of every lane of the quad, in column order
      uint32_t o[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int send = (t + s) & 3, from = (t - s) & 3;
        const uint32_t v = send == 0 ? w[0] : send == 1 ? w[1] : send == 2 ? w[2] : w[3];
        const uint32_t got = __shfl_sync(0xffffffffu, v, (lane & ~3) | from);
#pragma unroll
        for (int k = 0; k < 4; ++k) o[k] = from == k ? got : o[k];
      }
      emit(rl + 8 * (t & 1), 8 * (j + (t >> 1)), make_uint4(o[0], o[1], o[2], o[3]));
    }
  }
}

// The direct epilogue: each lane stores its chunks; rows beyond M are
// skipped, and a chunk reaching beyond N, or any chunk where `vec` is false
// (rows not a multiple of 16 bytes), goes element by element.
template <int BN, typename OutT, typename Val>
__device__ __forceinline__ void store_tile(const int (&acc)[BN / 2], OutT* out, Val val, int64_t row0,
                                           int n0, int64_t M, int N, bool vec) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(OutT));
  regroup<OutT, BN>(acc, n0, 0, BN / 8, val, [&](int r, int c, uint4 v) {
    const int64_t row = row0 + r;
    const int col = n0 + c;
    if (row >= M) return;
    OutT* p = out + row * N + col;
    if (vec && col + kPer <= N) {
      *reinterpret_cast<uint4*>(p) = v;
      return;
    }
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (col + i >= N) break;
      if constexpr (sizeof(OutT) == 4) {
        p[i] = __uint_as_float(w[i]);
      } else {
        p[i] = __ushort_as_bfloat16(static_cast<uint16_t>(w[i >> 1] >> (16 * (i & 1))));
      }
    }
  });
}

// the 128 threads of consumer warpgroup g meet at named barrier 1 + g
__device__ __forceinline__ void warpgroup_sync(int g) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + g) : "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1)
               : "memory");
}

// The staged epilogue, where every output row is a multiple of 16 bytes and
// BN <= 128: per pass the warpgroup writes its chunks into the staging boxes
// (16-byte chunk c of box row r at chunk c ^ (r % 8), the 128-byte swizzle),
// then one thread hands the boxes to TMA, which writes whole rows and clips
// rows beyond M and columns beyond N.  Before a pass overwrites the boxes,
// that thread waits until the previous pass's stores have read them.
template <int BN, typename OutT, typename Val>
__device__ __forceinline__ void store_tile_staged(const int (&acc)[BN / 2], const CUtensorMap* map,
                                                  Val val, int64_t row0, int n0, uint8_t* buf,
                                                  int g) {
  using S = Staging<BN, OutT>;
  const bool leader = (threadIdx.x & 127) == 0;
#pragma unroll
  for (int p = 0; p < S::kPasses; ++p) {
    if (leader) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    warpgroup_sync(g);
    regroup<OutT, BN>(acc, n0, p * S::kPassCols / 8, (p + 1) * S::kPassCols / 8, val,
                      [&](int r, int c, uint4 v) {
                        const int bytes = (c - p * S::kPassCols) * static_cast<int>(sizeof(OutT));
                        const int box = bytes >> 7, chunk = (bytes & 127) >> 4;
                        *reinterpret_cast<uint4*>(buf + box * (64 * 128) + r * 128 +
                                                  ((chunk ^ (r & 7)) << 4)) = v;
                      });
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    warpgroup_sync(g);
    if (leader) {
#pragma unroll
      for (int b = 0; b < S::kBoxes; ++b) {
        tma_store_2d(map, smem_u32(buf + b * 64 * 128), n0 + p * S::kPassCols + b * S::kBoxCols,
                     static_cast<int>(row0));
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
}

// ------------------------------------------------------------ the A loaders

// A as a row-major [M, K] int8 matrix: one 2-D box of 128 rows x bk bytes
struct DenseA {
  static constexpr bool kPacked = false;
  struct At {
    int m0;
  };
  __device__ __forceinline__ At at(int m0) const { return At{m0}; }
  __device__ __forceinline__ void load(uint32_t dst, const CUtensorMap* map, uint32_t bar, const At& t,
                                       int kb, int bk) const {
    tma_load_2d(dst, map, bar, kb * bk, t.m0);
  }
};

// A as [M, K/2] packed bytes (K % 256 == 0, bk = 128): the box of K blocks kb
// and kb + 1 (kb even) is the group row's 128 bytes
struct PackedA {
  static constexpr bool kPacked = true;
  struct At {
    int m0;
  };
  __device__ __forceinline__ At at(int m0) const { return At{m0}; }
  __device__ __forceinline__ void load(uint32_t dst, const CUtensorMap* map, uint32_t bar, const At& t,
                                       int kb, int /*bk*/) const {
    tma_load_2d(dst, map, bar, (kb >> 1) * kBK, t.m0);
  }
};

// A as the im2col matrix of an NHWC image, K running (kh, kw, c) as the
// weight does; C % bk == 0, so a K block lies inside one filter tap
struct Im2colA {
  static constexpr bool kPacked = false;
  int Ho, Wo, C, KW, sh, sw, ph, pw;
  struct At {
    int n, h, w;  // input position of filter tap (0, 0) of output pixel m0
  };
  __device__ __forceinline__ At at(int m0) const {
    const int wo = m0 % Wo, t = m0 / Wo;
    return At{t / Ho, (t % Ho) * sh - ph, wo * sw - pw};
  }
  __device__ __forceinline__ void load(uint32_t dst, const CUtensorMap* map, uint32_t bar, const At& t,
                                       int kb, int bk) const {
    const int k = kb * bk, tap = k / C, kh = tap / KW;
    tma_load_im2col_4d(dst, map, bar, k - tap * C, t.w, t.h, t.n, static_cast<uint16_t>(tap - kh * KW),
                       static_cast<uint16_t>(kh));
  }
};

// ------------------------------------------------------ the dequant epilogue

// out[m, n] = cast(relu?(float(acc) * alpha[n] + beta[n] [+ residual])), or
// that value's int8 codes (OutT = int8_t), [M, N] row-major; the value and the
// features as DequantEpilogue's (int8_mma.cuh)
template <typename OutT, bool RES = false>
struct DequantOut {
  static constexpr bool kSplitB = false;  // Bt's BN rows in one box from n0
  static constexpr bool kCodes = kIsCodes<OutT>;
  // codes out with a residual in: the residual's box of a tile comes by TMA
  // a tile ahead into one of two slots beside the staging box
  static constexpr bool kResidualBox = kCodes && RES;
  // codes out or a residual in: 64-column tiles (the epilogue's registers
  // beside 64 columns of sums spill at two blocks an SM), walked along N
  // first so that the blocks working on one row block at a time share its A
  // tiles in L2
  static constexpr bool kColumnsFirst = kCodes || RES;
  OutT* out;
  const float* alpha;
  const float* beta;  // may be null
  int M, N;
  int relu;
  int vec;  // rows a multiple of 16 bytes and out 16-byte aligned: map_out is set up
  int res_box;  // kResidualBox, staged, the residual 16-byte aligned: map_res is set up
  EpiArgs x;  // the codes' and the residual's operands

  // codes: one box of 64 rows x BN bytes a warpgroup
  template <int BN>
  __host__ __device__ static constexpr bool staged() {
    return BN <= 128;
  }
  template <int BN>
  __host__ __device__ static constexpr int staging_bytes() {
    if constexpr (kCodes) {
      return staged<BN>() ? (kResidualBox ? 3 : 1) * 64 * BN : 0;
    } else {
      return Staging<BN, OutT>::kBytes;
    }
  }

  // the warpgroup's residual box of a tile (64 rows x BN bytes from (row0,
  // n0), with the staging box's swizzle) into residual slot `slot` after the
  // staging box, its bytes completing on the slot's mbarrier bars + 8 * slot.
  // The slot's last reads (the epilogue two tiles back) ended at a
  // warpgroup barrier.
  template <int BN>
  __device__ __forceinline__ void prefetch(const CUtensorMap* map_res, int64_t row0, int n0,
                                           uint8_t* buf, uint32_t bars, int slot) const {
    if (res_box == 0 || (threadIdx.x & 127) != 0) return;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(bars + 8 * slot, 64 * BN);
    tma_load_2d(smem_u32(buf + (1 + slot) * 64 * BN), map_res, bars + 8 * slot, n0,
                static_cast<int>(row0));
  }

  // the warpgroup's k-th tile; bars: its residual slots' mbarriers
  template <int BN>
  __device__ __forceinline__ void store(const int (&acc)[BN / 2], const CUtensorMap* map_out,
                                        int64_t row0, int n0, uint8_t* buf, int g, uint32_t bars,
                                        int k) const {
    if constexpr (kCodes) {
      store_codes<BN>(acc, map_out, row0, n0, buf, g, bars, k);
    } else if constexpr (!RES) {
      const auto val = [&](int a, int, int c) {
        return c < N ? dequant(a, alpha[c], beta, c, relu != 0) : 0.f;
      };
      if constexpr (Staging<BN, OutT>::kOn) {
        if (vec != 0) {
          store_tile_staged<BN, OutT>(acc, map_out, val, row0, n0, buf, g);
          return;
        }
      }
      store_tile<BN, OutT>(acc, out, val, row0, n0, M, N, vec != 0);
    } else {
      // a float output with a residual in: the last conv of a block that
      // hands floats on (to the average pool)
      const float rs = *x.res_scale;
      const auto val = [&](int a, int r, int c) {
        const int64_t row = row0 + r;
        if (c >= N || row >= M) return 0.f;
        return epi_value(a, alpha[c], beta != nullptr ? beta[c] : 0.f, beta != nullptr,
                         relu != 0, true, std::is_same<OutT, __nv_bfloat16>::value,
                         x.res[row * N + c], rs);
      };
      if constexpr (Staging<BN, OutT>::kOn) {
        if (vec != 0) {
          store_tile_staged<BN, OutT>(acc, map_out, val, row0, n0, buf, g);
          return;
        }
      }
      store_tile<BN, OutT>(acc, out, val, row0, n0, M, N, vec != 0);
    }
  }

  // codes out: each lane's two columns of a slab in one row as a 16-bit pair,
  // into the staging box (16-byte chunk c of box row r at the swizzle of a
  // BN-byte row) or straight to memory.  With the residual's box in a slot,
  // each lane reads its pair's residual codes at the same place in the slot.
  // The quotients take div.rn's fast steps
  // (int8_mma.cuh); where one of a lane's operands leaves their range, the
  // lane runs its part of the tile again with __fdiv_rn.
  template <int BN>
  __device__ __forceinline__ void store_codes(const int (&acc)[BN / 2], const CUtensorMap* map_out,
                                              int64_t row0, int n0, uint8_t* buf, int g,
                                              uint32_t bars, int k) const {
    const bool leader = (threadIdx.x & 127) == 0;
    const bool stage = staged<BN>() && vec != 0, box = RES && res_box != 0;
    const uint8_t* slot = buf + (1 + (k & 1)) * 64 * BN;
    if (box) mbar_wait(bars + 8 * (k & 1), (k >> 1) & 1);
    if (stage) {
      // the previous tile's stores must have read the box
      if (leader) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      warpgroup_sync(g);
    }
    bool slow;
    if (stage) {
      if constexpr (RES) {
        slow = box ? codes_pass<BN, true, true, false>(acc, row0, n0, buf, slot)
                   : codes_pass<BN, true, false, false>(acc, row0, n0, buf, slot);
      } else {
        slow = codes_pass<BN, true, false, false>(acc, row0, n0, buf, slot);
      }
    } else {
      slow = codes_pass<BN, false, false, false>(acc, row0, n0, buf, slot);
    }
    if (slow) {
      if (stage) {
        codes_pass<BN, true, false, true>(acc, row0, n0, buf, slot);
      } else {
        codes_pass<BN, false, false, true>(acc, row0, n0, buf, slot);
      }
    }
    if (stage) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      warpgroup_sync(g);
      if (leader) {
        tma_store_2d(map_out, smem_u32(buf), n0, static_cast<int>(row0));
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
  }

  // One pass of the codes epilogue over this lane's part of the tile, its
  // choices fixed so that a slab is straight-line code: STAGE, into the
  // staging box (else to memory); BOX, the residual from the slot (else
  // from memory); EXACT, every quotient by __fdiv_rn (else by div.rn's
  // fast steps, returning whether an operand left their range).  Columns
  // beyond N compute with column N - 1's parameters and are not stored (TMA
  // clips them).
  template <int BN, bool STAGE, bool BOX, bool EXACT>
  __device__ __forceinline__ bool codes_pass(const int (&acc)[BN / 2], int64_t row0, int n0,
                                             uint8_t* buf, const uint8_t* slot) const {
    const int lane = threadIdx.x & 31, t = lane & 3;
    const int rl = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
    const bool bf16 = x.bf16 != 0, has_beta = beta != nullptr;
    const float rs = RES ? __ldg(x.res_scale) : 0.f;
    const Divisor d_all = divisor(x.os_vec != 0 ? 1.f : __ldg(x.out_scale));
    bool slow = !d_all.ok;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int tc = 8 * j + 2 * t, c = n0 + tc;
      const bool in0 = c < N, in1 = c + 1 < N;
      const int c0 = in0 ? c : N - 1, c1 = in1 ? c + 1 : N - 1;
      const float a0 = __ldg(alpha + c0), a1 = __ldg(alpha + c1);
      const float b0 = has_beta ? __ldg(beta + c0) : 0.f, b1 = has_beta ? __ldg(beta + c1) : 0.f;
      Divisor d0 = d_all, d1 = d_all;
      if (x.os_vec != 0) {
        d0 = divisor(__ldg(x.out_scale + c0));
        d1 = divisor(__ldg(x.out_scale + c1));
        slow = slow | !d0.ok | !d1.ok;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = rl + 8 * h;
        const int64_t row = row0 + r;
        const int* a = &acc[4 * j + 2 * h];
        int off = r * BN + tc;
        off ^= ((off >> 7) & (BN / 16 - 1)) << 4;
        int r0 = 0, r1 = 0;
        if constexpr (BOX) {
          const char2 p = *reinterpret_cast<const char2*>(slot + off);
          r0 = p.x;
          r1 = p.y;
        } else if constexpr (RES) {
          if (row < M && in0) load_pair(x.res + row * N + c, in1, r0, r1);
        }
        float v0 = epi_value(a[0], a0, b0, has_beta, relu != 0, RES, bf16, r0, rs);
        float v1 = epi_value(a[1], a1, b1, has_beta, relu != 0, RES, bf16, r1, rs);
        if (bf16) {
          v0 = round_bf16(v0);
          v1 = round_bf16(v1);
        }
        float quo0, quo1;
        if constexpr (EXACT) {
          quo0 = __fdiv_rn(v0, d0.s);
          quo1 = __fdiv_rn(v1, d1.s);
        } else {
          quo0 = fast_quotient(v0, d0);
          quo1 = fast_quotient(v1, d1);
          slow = slow | !in_quotient_range(v0) | !in_quotient_range(v1);
        }
        const int q0 = code_of(quo0, x.qmax), q1 = code_of(quo1, x.qmax);
        if constexpr (STAGE) {
          *reinterpret_cast<uint16_t*>(buf + off) =
              static_cast<uint16_t>((q0 & 0xFF) | ((q1 & 0xFF) << 8));
        } else if (row < M && in0) {
          store_pair(out + row * N + c, q0, q1, in1);
        }
      }
    }
    return slow;
  }
};

// four bytes' low or high nibbles, each sign extended to a byte
__device__ __forceinline__ uint32_t nibbles_to_bytes(uint32_t w, bool high) {
  const uint32_t x = (high ? (w >> 4) : w) & 0x0F0F0F0Fu;
  return __vsub4(x ^ 0x08080808u, 0x08080808u);
}

__device__ __forceinline__ uint4 unpack_chunk(uint4 w, bool high) {
  return make_uint4(nibbles_to_bytes(w.x, high), nibbles_to_bytes(w.y, high),
                    nibbles_to_bytes(w.z, high), nibbles_to_bytes(w.w, high));
}

// ---------------------------------------------------------------- the kernel

// R: the Ring; A: the A loader; Epi: the epilogue (staging_bytes<BN>() a
// warpgroup, store<BN>(acc, map_out, row0, n0, staging, g, bars, k) for the
// warpgroup's k-th tile, called by every thread of the warpgroup; with
// kSplitB, the Bt tile is two boxes of BN / 2 rows from b_row(n0, 0) and
// b_row(n0, 1); with kResidualBox, prefetch<BN>(map_res, row0, n0, staging,
// bars, slot) loads a tile's residual a tile ahead, slots alternating, each
// completing on its mbarrier of the warpgroup's two at bars).  K counts int8
// codes; the maps' boxes are R::kBK bytes of K wide, with the swizzle of that
// width.
// the origin (m0, n0) of tile t of num_m x num_n: M first, or N first where
// the epilogue asks for it
template <typename Epi>
__device__ __forceinline__ void tile_origin(int t, int num_m, int num_n, int bn, int& m0, int& n0) {
  if constexpr (Epi::kColumnsFirst) {
    m0 = (t / num_n) * kBM;
    n0 = (t % num_n) * bn;
  } else {
    m0 = (t % num_m) * kBM;
    n0 = (t / num_m) * bn;
  }
}

template <typename R, typename A, typename Epi>
__global__ void __launch_bounds__(kThreads, R::kMinBlocks)
wgmma_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
             const __grid_constant__ CUtensorMap map_out,
             const __grid_constant__ CUtensorMap map_res, const A loader, const Epi epi, int M,
             int N, int K) {
  constexpr int BN = R::kBN, kStages = R::kStages, BK = R::kBK;
  constexpr uint32_t kABytes = kBM * BK, kStageBytes = (kBM + BN) * BK;
  constexpr int kStaging = Epi::template staging_bytes<BN>();
  static_assert(!A::kPacked || (kStages % 2 == 0 && BK == kBK),
                "packed A fills pairs of 128-byte stages");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  // stage s at tiles0 + s * kStageBytes (A at its start, Bt at kABytes), then
  // the staging buffers, then kStages `full` mbarriers, kStages `empty` ones
  // and one for each consumer warpgroup's epilogue
  const uint32_t pad = (1024u - (base & 1023u)) & 1023u;
  const uint32_t tiles0 = base + pad;
  uint8_t* const stages = smem_raw + pad;
  uint8_t* const staging = stages + kStages * kStageBytes;
  const uint32_t full0 = tiles0 + kStages * kStageBytes + 2 * kStaging;
  const uint32_t empty0 = full0 + 8 * kStages;
  const uint32_t epi0 = empty0 + 8 * kStages;

  const int num_m = (M + kBM - 1) / kBM, num_n = (N + BN - 1) / BN;
  const int tiles = num_m * num_n;
  const int kblocks = (K + BK - 1) / BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    for (int b = 0; b < 4; ++b) mbar_init(epi0 + 8 * b, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // the producer: one thread issues every TMA load of the block
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int m0, n0;
        tile_origin<Epi>(tile, num_m, num_n, BN, m0, n0);
        const typename A::At at = loader.at(m0);
        for (int kb = 0; kb < kblocks; ++kb) {
          const uint32_t dst = tiles0 + stage * kStageBytes, bar = full0 + 8 * stage;
          if constexpr (A::kPacked) {
            if ((kb & 1) == 0) {
              // both stages of the pair; the packed box goes to the second's A
              mbar_wait(empty0 + 8 * stage, phase ^ 1);
              mbar_wait(empty0 + 8 * (stage + 1), phase ^ 1);
              mbar_expect_tx(bar, kABytes + BN * BK);
              loader.load(dst + kStageBytes, &map_a, bar, at, kb, BK);
            } else {
              mbar_expect_tx(bar, BN * BK);
            }
          } else {
            mbar_wait(empty0 + 8 * stage, phase ^ 1);  // a fresh barrier passes parity 1 at once
            mbar_expect_tx(bar, (kBM + BN) * BK);
            loader.load(dst, &map_a, bar, at, kb, BK);
          }
          if constexpr (Epi::kSplitB) {
            tma_load_2d(dst + kABytes, &map_b, bar, kb * BK, epi.b_row(n0, 0));
            tma_load_2d(dst + kABytes + (BN / 2) * BK, &map_b, bar, kb * BK, epi.b_row(n0, 1));
          } else {
            tma_load_2d(dst + kABytes, &map_b, bar, kb * BK, n0);
          }
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // the consumers: warpgroup g owns rows 64g .. 64g + 63 of each tile
  const int g = warp >> 2;
  const uint32_t epi_bars = epi0 + 16 * g;
  uint8_t* const buf = staging + g * kStaging;
  int acc[BN / 2];
  int stage = 0;
  uint32_t phase = 0;
  int k = 0;  // the warpgroup's tiles so far
  if constexpr (Epi::kResidualBox) {
    if (static_cast<int>(blockIdx.x) < tiles) {
      int m0, n0;
      tile_origin<Epi>(blockIdx.x, num_m, num_n, BN, m0, n0);
      epi.template prefetch<BN>(&map_res, static_cast<int64_t>(m0) + 64 * g, n0, buf, epi_bars, 0);
    }
  }
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int m0, n0;
    tile_origin<Epi>(tile, num_m, num_n, BN, m0, n0);
    if constexpr (Epi::kResidualBox) {
      const int next = tile + gridDim.x;
      if (next < tiles) {
        int m1, n1;
        tile_origin<Epi>(next, num_m, num_n, BN, m1, n1);
        epi.template prefetch<BN>(&map_res, static_cast<int64_t>(m1) + 64 * g, n1, buf, epi_bars,
                                  (k + 1) & 1);
      }
    }
    for (int kb = 0; kb < kblocks; ++kb) {
      mbar_wait(full0 + 8 * stage, phase);
      const uint32_t sa = tiles0 + stage * kStageBytes;
      if constexpr (A::kPacked) {
        if ((kb & 1) == 0) {
          // this warpgroup's 64 packed rows: low nibbles to this stage's A,
          // high nibbles in place (the same swizzled position in both)
          uint4* lo = reinterpret_cast<uint4*>(stages + stage * kStageBytes + g * 64 * BK);
          uint4* hi = reinterpret_cast<uint4*>(stages + (stage + 1) * kStageBytes + g * 64 * BK);
#pragma unroll
          for (int q = threadIdx.x & 127; q < 64 * BK / 16; q += 128) {
            const uint4 w = hi[q];
            lo[q] = unpack_chunk(w, false);
            hi[q] = unpack_chunk(w, true);
          }
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          warpgroup_sync(g);
        }
      }
      const uint64_t da = smem_desc(sa + g * 64 * BK, BK), db = smem_desc(sa + kABytes, BK);
      fence_sums(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) {
        wgmma_tile<BN>(acc, da + 2 * kk, db + 2 * kk, (kb > 0 || kk > 0) ? 1 : 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_sums(acc);
      if (lane == 0) mbar_arrive(empty0 + 8 * stage);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    epi.template store<BN>(acc, &map_out, static_cast<int64_t>(m0) + 64 * g, n0, buf, g, epi_bars,
                           k);
    ++k;
  }
  // the last TMA stores must have read shared memory before the block ends
  if ((threadIdx.x & 127) == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------- host side

// The tensor map encoders are driver-API functions and the build links only
// the CUDA runtime: their addresses come from the runtime's driver entry
// point query.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
using EncodeIm2colFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                    const cuuint64_t*, const cuuint64_t*, const int*, const int*,
                                    cuuint32_t, cuuint32_t, const cuuint32_t*, CUtensorMapInterleave,
                                    CUtensorMapSwizzle, CUtensorMapL2promotion,
                                    CUtensorMapFloatOOBfill);

inline void* driver_fn(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  const cudaError_t rc = cudaGetDriverEntryPointByVersion(name, &p, 12000, cudaEnableDefault, &found);
#else
  const cudaError_t rc = cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &found);
#endif
  return rc == cudaSuccess && found == cudaDriverEntryPointSuccess ? p : nullptr;
}

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = reinterpret_cast<EncodeTiledFn>(driver_fn("cuTensorMapEncodeTiled"));
  return fn;
}

inline EncodeIm2colFn encode_im2col() {
  static const EncodeIm2colFn fn =
      reinterpret_cast<EncodeIm2colFn>(driver_fn("cuTensorMapEncodeIm2col"));
  return fn;
}

inline CUtensorMapSwizzle swizzle_of(int box_bytes) {
  return box_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
         : box_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
}

// a row-major [rows, cols] matrix of `type` (elem bytes each), boxes of
// box_rows rows x box_bytes bytes (128, 64 or 32) with the swizzle of that
// width
inline bool make_map(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* base,
                     int64_t rows, int64_t cols, int box_rows, int box_bytes = 128) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols * elem)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_bytes / elem), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estride[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, estride,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(box_bytes),
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The im2col map of an [n, h, w, c] int8 image for a kh x kw filter at
// strides (sh, sw) and padding (ph, pw): boxes of 128 output pixels x bk
// channels.  The corners bound the filter's top-left tap (from -pad to
// size - 1 + pad - (filter - 1)); the traversal stride is the conv's.
inline bool make_im2col_map(CUtensorMap* map, const void* x, int n, int h, int w, int c, int kh,
                            int kw, int sh, int sw, int ph, int pw, int bk) {
  const EncodeIm2colFn encode = encode_im2col();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(w),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(w) * c,
                                 static_cast<cuuint64_t>(h) * w * c};
  const int lower[2] = {-pw, -ph};
  const int upper[2] = {pw - (kw - 1), ph - (kh - 1)};
  const cuuint32_t estride[4] = {1, static_cast<cuuint32_t>(sw), static_cast<cuuint32_t>(sh), 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(x), dims, strides, lower,
                upper, static_cast<cuuint32_t>(bk), static_cast<cuuint32_t>(kBM), estride,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(bk), CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline CUtensorMapDataType map_type(float*) { return CU_TENSOR_MAP_DATA_TYPE_FLOAT32; }
inline CUtensorMapDataType map_type(__nv_bfloat16*) { return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16; }
inline CUtensorMapDataType map_type(int8_t*) { return CU_TENSOR_MAP_DATA_TYPE_UINT8; }

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// What TMA can describe for the GEMM: every row stride a multiple of 16 bytes
// and both bases 16-byte aligned.  int_matmul.gemm_route is the same test in
// Python.
inline bool tma_describable(const void* a, const void* bt, int64_t K) {
  return K % 16 == 0 && aligned16(a) && aligned16(bt);
}

// What TMA's im2col mode can describe for the conv: one group, C a multiple
// of 64 (a K block of 64 or 128 bytes inside one filter tap), aligned bases,
// a traversal stride of at most 8 and corners and tap offsets inside the
// 4-D map's range (filter and padding at most 32).  int_conv.conv_route is
// the same test in Python.
inline bool im2col_describable(const void* x, const void* w, int c, int groups, int kh, int kw,
                               int sh, int sw, int ph, int pw) {
  return groups == 1 && c % 64 == 0 && aligned16(x) && aligned16(w) && sh <= 8 && sw <= 8 &&
         kh <= 32 && kw <= 32 && ph <= 32 && pw <= 32;
}

// the tile width for a GEMM shape: 64 for the memory-bound N <= 64, 256 where
// a long K makes the tensor-core rate the bound, else 128
inline int pick_bn(int64_t N, int64_t K) {
  if (N <= 64) return 64;
  if (N >= 256 && K >= 4096) return 256;
  return 128;
}

// One launch of the kernel over an M x N output with K codes of depth.  The
// set-up that does not depend on the pointers (SM count, shared-memory
// attribute, occupancy) runs once per kernel instance and device.  Returns
// -1 for a failed set-up or a grid that does not fit, else 0 (the caller
// reads cudaGetLastError).
template <typename R, typename A, typename Epi>
int launch(const CUtensorMap& map_a, const CUtensorMap& map_b, const CUtensorMap& map_out,
           const CUtensorMap& map_res, const A& loader, const Epi& epi, int64_t M, int64_t N,
           int64_t K, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<R, Epi>();
  auto kernel = wgmma_kernel<R, A, Epi>;
  static int slots[kMaxDevices] = {};  // SMs x resident blocks an SM; 0 = not set up, -1 = failed
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= kMaxDevices) return -1;
  if (slots[device] == 0) {
    int sms = 0, per_sm = 0;
    const bool ok =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) == cudaSuccess &&
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem)) == cudaSuccess &&
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem) == cudaSuccess &&
        per_sm >= 1;
    slots[device] = ok ? sms * per_sm : -1;
  }
  if (slots[device] < 0) return -1;
  const int64_t tiles = ((M + kBM - 1) / kBM) * ((N + R::kBN - 1) / R::kBN);
  if (tiles > 2147483647LL) return -1;
  const int grid = static_cast<int>(tiles < slots[device] ? tiles : slots[device]);
  kernel<<<grid, kThreads, smem, stream>>>(map_a, map_b, map_out, map_res, loader, epi,
                                           static_cast<int>(M), static_cast<int>(N),
                                           static_cast<int>(K));
  return 0;
}

// The dequant epilogue over [M, N], with its output map (staged stores)
// where the tile width stages and the rows are a multiple of 16 bytes;
// returns false on a failed encode.
template <int BN, typename OutT, bool RES>
bool dequant_out(const EpiArgs& args, int64_t M, int64_t N, DequantOut<OutT, RES>* epi,
                 CUtensorMap* map_out, CUtensorMap* map_res) {
  using Epi = DequantOut<OutT, RES>;
  OutT* out = static_cast<OutT*>(args.out);
  *epi = Epi{out, args.alpha, args.beta, static_cast<int>(M), static_cast<int>(N), args.relu, 0, 0,
             args};
  epi->vec = (N * static_cast<int64_t>(sizeof(OutT))) % 16 == 0 && aligned16(out);
  if (epi->vec == 0) return true;
  if constexpr (Epi::kCodes) {
    if (!Epi::template staged<BN>()) return true;
    if (Epi::kResidualBox && aligned16(args.res)) {
      epi->res_box = 1;
      if (!make_map(map_res, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, args.res, M, N, 64, BN)) return false;
    }
    return make_map(map_out, map_type(out), 1, out, M, N, 64, BN);
  } else {
    if (!Staging<BN, OutT>::kOn) return true;
    return make_map(map_out, map_type(out), static_cast<int>(sizeof(OutT)), out, M, N, 64);
  }
}

template <int BN, typename OutT, bool RES>
int launch_gemm_bn(const void* a, const void* bt, const EpiArgs& args, int64_t M, int64_t N, int64_t K,
                   cudaStream_t stream) {
  CUtensorMap map_a, map_b, map_out = {}, map_res = {};
  DequantOut<OutT, RES> epi;
  if (!make_map(&map_a, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a, M, K, kBM) ||
      !make_map(&map_b, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, bt, N, K, BN) ||
      !dequant_out<BN>(args, M, N, &epi, &map_out, &map_res)) {
    return -1;
  }
  return launch<Tile<BN>>(map_a, map_b, map_out, map_res, DenseA{}, epi, M, N, K, stream);
}

// The GEMM route's launch.  Returns -1 for a shape it does not take (the
// caller checks tma_describable first) or a failed set-up, else 0 (the caller
// reads cudaGetLastError).  Codes out or a residual in take 64-column tiles
// whatever N (DequantOut::kColumnsFirst).
template <typename OutT, bool RES>
int launch_int8_wgmma(const void* a, const void* bt, const EpiArgs& args, int64_t M, int64_t N,
                      int64_t K, cudaStream_t stream) {
  if (!tma_describable(a, bt, K) || M > 2147483647LL - kBM || N > 2147483647LL - 256 ||
      K > 2147483647LL - kBK) {
    return -1;
  }
  if constexpr (DequantOut<OutT, RES>::kColumnsFirst) {
    return launch_gemm_bn<64, OutT, RES>(a, bt, args, M, N, K, stream);
  } else {
    switch (pick_bn(N, K)) {
      case 64:
        return launch_gemm_bn<64, OutT, RES>(a, bt, args, M, N, K, stream);
      case 256:
        return launch_gemm_bn<256, OutT, RES>(a, bt, args, M, N, K, stream);
      default:
        return launch_gemm_bn<128, OutT, RES>(a, bt, args, M, N, K, stream);
    }
  }
}

// The conv's rings by tile width and K box: as deep as two blocks an SM
// leave room for beside their staging buffers (a ring of 5 stages at one
// block an SM ran slower at all but one ResNet-50 shape on the H100,
// PERF.md §6)
template <int BN, int BK>
struct ConvRing;
template <>
struct ConvRing<64, 64> : Ring<64, 6, 2, 64> {};
template <>
struct ConvRing<64, 128> : Ring<64, 3, 2, 128> {};
template <>
struct ConvRing<128, 64> : Ring<128, 4, 2, 64> {};
template <>
struct ConvRing<128, 128> : Ring<128, 2, 2, 128> {};

template <int BN, int BK, typename OutT, bool RES>
int launch_conv_bn(const void* x, const void* w, const EpiArgs& args, int n, int h, int wd, int c,
                   int o, int kh, int kw, int sh, int sw, int ph, int pw, int ho, int wo,
                   cudaStream_t stream) {
  const int64_t M = static_cast<int64_t>(n) * ho * wo, K = static_cast<int64_t>(kh) * kw * c;
  CUtensorMap map_a, map_b, map_out = {}, map_res = {};
  DequantOut<OutT, RES> epi;
  if (!make_im2col_map(&map_a, x, n, h, wd, c, kh, kw, sh, sw, ph, pw, BK) ||
      !make_map(&map_b, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, o, K, BN, BK) ||
      !dequant_out<BN>(args, M, o, &epi, &map_out, &map_res)) {
    return -1;
  }
  const Im2colA loader{ho, wo, c, kw, sh, sw, ph, pw};
  return launch<ConvRing<BN, BK>>(map_a, map_b, map_out, map_res, loader, epi, M, o, K, stream);
}

// The conv's TMA im2col route: out [n*ho*wo, o] row-major (NHWC).  Returns -1
// for a shape it does not take (the caller checks im2col_describable first)
// or a failed set-up, else 0 (the caller reads cudaGetLastError).
template <typename OutT, bool RES>
int launch_int8_conv_wgmma(const void* x, const void* w, const EpiArgs& args, int n, int h, int wd,
                           int c, int o, int kh, int kw, int sh, int sw, int ph, int pw, int ho,
                           int wo, cudaStream_t stream) {
  if (!im2col_describable(x, w, c, 1, kh, kw, sh, sw, ph, pw) ||
      static_cast<int64_t>(n) * ho * wo > 2147483647LL - kBM ||
      static_cast<int64_t>(kh) * kw * c > 2147483647LL - kBK) {
    return -1;
  }
  // K blocks of 128 bytes, or 64 where C is an odd multiple of 64; tiles
  // 128 x 64 for O <= 64 or codes out or a residual in, else 128 x 128
  const bool wide_k = c % 128 == 0;
  if constexpr (!DequantOut<OutT, RES>::kColumnsFirst) {
    if (o > 64) {
      return wide_k ? launch_conv_bn<128, 128, OutT, RES>(x, w, args, n, h, wd, c, o, kh, kw, sh,
                                                          sw, ph, pw, ho, wo, stream)
                    : launch_conv_bn<128, 64, OutT, RES>(x, w, args, n, h, wd, c, o, kh, kw, sh,
                                                         sw, ph, pw, ho, wo, stream);
    }
  }
  return wide_k ? launch_conv_bn<64, 128, OutT, RES>(x, w, args, n, h, wd, c, o, kh, kw, sh, sw, ph,
                                                     pw, ho, wo, stream)
                : launch_conv_bn<64, 64, OutT, RES>(x, w, args, n, h, wd, c, o, kh, kw, sh, sw, ph,
                                                    pw, ho, wo, stream);
}

}  // namespace wg
}  // namespace cnnq
