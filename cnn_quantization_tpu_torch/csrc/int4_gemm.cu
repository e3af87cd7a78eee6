// int8 matrix product whose left operand and output may hold two 4-bit codes
// to a byte, with a fused dequant + residual + ReLU + requant epilogue, for
// Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel in cnn_quantization_tpu/ops/kernels/
// int4_matmul.py: int4_matmul (:229-380) with its bodies _kernel (:161-189),
// _kernel_1step (:192-214), _epilogue (:103-158), _unpack_halves (:82-92) and
// _pack_bytes (:95-100).  One kernel covers the multi-step body, the
// single-step body and the row-paired call: those are devices of the TPU's
// 128-wide matrix unit and its VMEM accumulator; here the int32 sums live in
// registers and a K of 64 is one step of the K loop.
//
//   acc[m, n] = sum_k A[m, k] * Bt[n, k]                      int32, exact
//   v = float(acc) * alpha[n] + beta[n]                       two rounded f32 ops
//   v = v + float(unpack(res)[m, n]) * res_scale              if a residual is given
//   v = max(v, 0)                                             if relu
//   out = v                                                   float32 | bfloat16
//       | int8(clip(rint(v / out_scale), -qmax, qmax))        int8 codes
//       | pack(clip(rint(v / out_scale), -7, 7))              two codes to a byte
//
// A is [M, K] int8 codes, or [M, K/2] bytes in the "group-local split-half"
// layout: within each group of 256 channels, byte g*128 + j holds code
// g*256 + j in its low nibble and code g*256 + 128 + j in its high nibble
// (sign extended on unpack).  Bt is [N, K] int8 with K contiguous (a 1x1 OIHW
// weight as stored).  The residual is [M, N/2] packed bytes, the packed output
// likewise.  res_scale and out_scale are read from device memory: they are
// frozen scales that already live there, and a host copy would synchronise
// every launch.
//
// Bound: on the serving path every shape is bounded by the bytes it moves (A
// at half a byte a code when packed, the residual at half a byte, the output
// at its stored width), not by the int8 tensor-core rate.
//
// Two routes, chosen by the operands (int4_matmul.int4_route decides and
// passes `route`; this file checks the same condition and refuses route 1
// where it cannot take the operands; route 0 takes every call, so it is also
// taken where a caller asks for it to measure it beside route 1).  Hopper's tensor cores have no 4-bit integer type, so on both
// nibbles become int8 before the product.
//
// Route 1, TMA + wgmma, where TMA can describe every operand (packed A, or
// unpacked A with K % 16 == 0; all bases 16-byte aligned): the persistent
// warp-specialised kernel of int8_wgmma.cuh.  Packed A arrives as one
// 128-byte TMA box per packing group row and is unpacked in shared memory in
// place (PackedA there): each packed byte is read once.  Where the residual
// or the output is packed, a tile's 64 columns are 32 codes of a packing
// group's low half and the 32 codes 128 further (two Bt boxes), so the two
// nibbles of a byte meet in one thread of the wgmma accumulator and the
// epilogue (Int4WgEpilogue) needs neither renumbered columns nor transposes;
// byte outputs leave through shared memory and TMA stores, which overlap the
// next tile's loads.  At the stage-1 shapes (K = 64) a tile is one stage and
// the kernel streams A, the residual and the output.  What bounds it there is
// the epilogue's issue rate: a true division for each code (__fdiv_rn; a
// ReLU'd zero skips it, see code() below) and some 20 other instructions an
// output, so tiles are narrow and three blocks share an SM.
//
// Route 0, mma.sync, for the rest (a K that is no multiple of 16, a
// misaligned operand): int8_mma.cuh's block product (128 x 64 tiles,
// mma.sync.m16n8k32.s8), through two additions:
//
//   * a loader that unpacks: the 16 codes at k (a multiple of 16, so never
//     astride the two halves of a group) are the low (k % 256 < 128) or high
//     nibbles of the 16 bytes at (k / 256) * 128 + k % 128, sign extended
//     four to a 32-bit word.  Each byte is read twice, once per half, the
//     second time from cache;
//   * a group-structured epilogue.  A packed byte needs two columns 128
//     apart, while the fragment layout gives a thread columns c and c + 1.
//     So with a residual or a packed output the block's 64 tile columns stand
//     for 32 bytes: tile column c is column
//     (c / 2 / 128) * 256 + (c % 2) * 128 + (c / 2) % 128, which only
//     permutes the rows of Bt (and alpha, beta) that the block loads.  The
//     two sums a thread holds side by side are then the low and the high
//     nibble of one byte.  The four threads of a quad hold bytes 4 apart;
//     a 4 x 4 byte transpose by warp shuffles turns them into one aligned
//     32-bit word a thread, for the residual load and for the packed store.
//
// Numerics: each float operation is rounded on its own (__fmul_rn, __fadd_rn,
// __fdiv_rn; the build passes --fmad=false), the requant divides by the scale
// and rounds half to even (rintf) before it clamps: bit-identical to the
// plain PyTorch version's separate ops.  Multiplying by a reciprocal instead
// flips codes at ties, and on a +-7 grid a flipped code snowballs.

#include "int8_mma.cuh"
#include "int8_wgmma.cuh"

namespace {

constexpr int kGroup = 256;  // channels per packing group
constexpr int kHalf = 128;   // bytes per group

enum OutMode { kF32 = 0, kBF16 = 1, kInt8 = 2, kPacked = 3 };

using cnnq::wg::nibbles_to_bytes;

struct Int4A {
  const int8_t* a;
  int64_t M;
  int K;          // codes per row
  int row_bytes;  // K, or K / 2 when packed
  bool packed;    // needs K % 256 == 0 and a 16-byte aligned
  bool vec;       // unpacked: K % 16 == 0 and a 16-byte aligned

  struct Row {
    const int8_t* p;  // nullptr beyond M
  };

  __device__ __forceinline__ Row row(int64_t m, int /*group*/) const {
    return Row{m < M ? a + m * row_bytes : nullptr};
  }

  __device__ __forceinline__ uint4 chunk(const Row& r, int k) const {
    if (r.p == nullptr) return cnnq::zero_chunk();
    if (!packed) return cnnq::load_row_chunk(r.p, k, K, vec);
    if (k >= K) return cnnq::zero_chunk();
    const uint4 w = *reinterpret_cast<const uint4*>(r.p + (k >> 8) * kHalf + (k & (kHalf - 1)));
    const bool high = (k & kHalf) != 0;
    return make_uint4(nibbles_to_bytes(w.x, high), nibbles_to_bytes(w.y, high),
                      nibbles_to_bytes(w.z, high), nibbles_to_bytes(w.w, high));
  }
};

// result byte i of thread t = byte t of thread i's word, over the four
// threads of a quad (lanes 4q .. 4q + 3); every lane of the warp must call it
__device__ __forceinline__ uint32_t quad_transpose(uint32_t w, int tig) {
  uint32_t out = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int peer = tig ^ r;
    const uint32_t got = __shfl_xor_sync(0xffffffffu, (w >> (8 * peer)) & 0xffu, r);
    out |= got << (8 * peer);
  }
  return out;
}

__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int MODE>
struct OutType {
  using type = int8_t;
};
template <>
struct OutType<kF32> {
  using type = float;
};
template <>
struct OutType<kBF16> {
  using type = __nv_bfloat16;
};

// GROUPED: a residual or a packed output, N % 256 == 0, columns renumbered so
// that a thread's two neighbouring sums are the two nibbles of one byte.
template <int MODE, bool GROUPED>
struct Int4Epilogue {
  using OutT = typename OutType<MODE>::type;
  OutT* out;               // [M, N], or [M, N / 2] bytes when packed
  const float* alpha;      // [N]
  const float* beta;       // [N] or null
  const int8_t* res;       // [M, N / 2] packed bytes or null (GROUPED only)
  const float* res_scale;  // device scalar, read when res is given
  const float* out_scale;  // device scalar, read by the int8 and packed modes
  float qmax;
  int N;
  int relu;

  __device__ __forceinline__ void select_group(int, int) {}

  __device__ __forceinline__ int column(int c) const {
    if (!GROUPED) return c;
    const int byte = c >> 1;
    return (byte / kHalf) * kGroup + (c & 1) * kHalf + (byte % kHalf);
  }

  // dequant with the column's alpha a and beta b, + residual code r at scale
  // rs, ReLU
  __device__ __forceinline__ float value(int acc, float a, float b, bool has_res, int r,
                                         float rs) const {
    float v = __fmul_rn(__int2float_rn(acc), a);
    if (beta != nullptr) v = __fadd_rn(v, b);
    if (has_res) v = __fadd_rn(v, __fmul_rn(__int2float_rn(r), rs));
    if (relu != 0) v = fmaxf(v, 0.f);
    return v;
  }

  __device__ __forceinline__ int code(float v, float os, float q) const {
    return static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(v, os)), -q), q));
  }

  __device__ __forceinline__ void store(const int (&acc)[2][4][4], int64_t row0, int col0, int gid,
                                        int tig, int64_t M, int ncols) const {
    const float os = (MODE == kInt8 || MODE == kPacked) ? *out_scale : 1.f;
    const float q = MODE == kPacked ? 7.f : qmax;
    if constexpr (!GROUPED) {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = col0 + ni * 8 + tig * 2;
        if (col >= ncols) continue;
        const bool two = col + 1 < ncols;
        const float a0 = alpha[col], a1 = two ? alpha[col + 1] : 0.f;
        const float b0 = beta != nullptr ? beta[col] : 0.f;
        const float b1 = beta != nullptr && two ? beta[col + 1] : 0.f;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int64_t row = row0 + mi * 16 + gid + h * 8;
            if (row >= M) continue;
            const float v0 = value(acc[mi][ni][h * 2], a0, b0, false, 0, 0.f);
            const float v1 = two ? value(acc[mi][ni][h * 2 + 1], a1, b1, false, 0, 0.f) : 0.f;
            OutT* p = out + row * N + col;
            if constexpr (MODE == kInt8) {
              cnnq::store_pair(p, code(v0, os, q), code(v1, os, q), two);
            } else {
              cnnq::store_pair(p, v0, v1, two);
            }
          }
        }
      }
    } else {
      // tile columns col0 + ni * 8 + tig * 2 (+ 1) are the nibbles of byte
      // col0 / 2 + ni * 4 + tig of the row's N / 2 packed bytes
      const bool has_res = res != nullptr;
      const float rs = has_res ? *res_scale : 0.f;
      const int byte0 = col0 >> 1;
      const int64_t row_bytes = N >> 1;
      // the thread's eight columns and their alpha and beta, once for all rows
      int lo[4];
      float a_lo[4], a_hi[4], b_lo[4], b_hi[4];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int byte = byte0 + ni * 4 + tig;
        lo[ni] = (byte / kHalf) * kGroup + (byte % kHalf);
        a_lo[ni] = alpha[lo[ni]];
        a_hi[ni] = alpha[lo[ni] + kHalf];
        b_lo[ni] = beta != nullptr ? beta[lo[ni]] : 0.f;
        b_hi[ni] = beta != nullptr ? beta[lo[ni] + kHalf] : 0.f;
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int64_t row = row0 + mi * 16 + gid + h * 8;
          const bool ok = row < M;
          // a thread loads the residual word at bytes byte0 + tig * 4 .. + 3;
          // transposed, its byte ni is the residual of byte byte0 + ni * 4 + tig
          uint32_t rword = 0;
          if (has_res) {
            if (ok) {
              rword = *reinterpret_cast<const uint32_t*>(res + row * row_bytes + byte0 + tig * 4);
            }
            rword = quad_transpose(rword, tig);
          }
          uint32_t packed = 0;
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            const uint32_t rb = (rword >> (8 * ni)) & 0xffu;
            const int r_lo = static_cast<int8_t>((rb << 4) & 0xffu) >> 4;
            const int r_hi = static_cast<int8_t>(rb) >> 4;
            const float v0 = value(acc[mi][ni][h * 2], a_lo[ni], b_lo[ni], has_res, r_lo, rs);
            const float v1 = value(acc[mi][ni][h * 2 + 1], a_hi[ni], b_hi[ni], has_res, r_hi, rs);
            if constexpr (MODE == kPacked) {
              const uint32_t b = (static_cast<uint32_t>(code(v0, os, q)) & 0xFu) |
                                 ((static_cast<uint32_t>(code(v1, os, q)) & 0xFu) << 4);
              packed |= b << (8 * ni);
            } else if constexpr (MODE == kInt8) {
              if (ok) {
                out[row * N + lo[ni]] = static_cast<int8_t>(code(v0, os, q));
                out[row * N + lo[ni] + kHalf] = static_cast<int8_t>(code(v1, os, q));
              }
            } else {
              if (ok) {
                store_one(out + row * N + lo[ni], v0);
                store_one(out + row * N + lo[ni] + kHalf, v1);
              }
            }
          }
          if constexpr (MODE == kPacked) {
            // transposed back: one aligned 32-bit word of four bytes a thread
            const uint32_t word = quad_transpose(packed, tig);
            if (ok) {
              *reinterpret_cast<uint32_t*>(out + row * row_bytes + byte0 + tig * 4) = word;
            }
          }
        }
      }
    }
  }
};

struct Args {
  const void *bt, *alpha, *beta, *res, *res_scale, *out_scale;
  void* out;
  int64_t M, N, K;
  float qmax;
  int relu;
  cudaStream_t stream;
};

template <int MODE, bool GROUPED>
int run(const Int4A& A, const Args& g) {
  using Epi = Int4Epilogue<MODE, GROUPED>;
  const Epi epilogue{static_cast<typename Epi::OutT*>(g.out),
                     static_cast<const float*>(g.alpha),
                     static_cast<const float*>(g.beta),
                     static_cast<const int8_t*>(g.res),
                     static_cast<const float*>(g.res_scale),
                     static_cast<const float*>(g.out_scale),
                     g.qmax,
                     static_cast<int>(g.N),
                     g.relu};
  return cnnq::launch_int8_mma(A, g.bt, epilogue, g.M, g.N, g.K, 1, g.stream);
}

bool aligned(const void* p, uintptr_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

// ------------------------------------------------- the TMA + wgmma route

// The epilogue on wgmma's accumulator layout (int8_wgmma.cuh): a lane holds
// rows rl and rl + 8 of its warpgroup's 64, and in slab j the columns
// 8j + 2t and 8j + 2t + 1 (t = lane % 4).
//   Ungrouped (BN = 64 or 128): tile column c is column n0 + c.
//   Grouped (a residual or a packed output; the tile lies inside packing
//   group g0 = n0 - n0 % 256): the Bt tile is two boxes of BN / 2 rows, codes
//   j0 + i of the group's low half and j0 + 128 + i of its high half (j0 =
//   n0 % 256 / 2), so slab j < BN / 16 holds the low nibbles of packed bytes
//   b = j0 + 8j + 2t and b + 1 and slab j + BN / 16 their high nibbles: both
//   nibbles of a byte lie in one thread, with no renumbering of the columns
//   and no transposes.  The residual is read as those two bytes.
// Values and codes are Int4Epilogue's value() and code(), unchanged; a value
// of 0 (the ReLU's) takes code 0 without the division, which is what the
// division gives for any scale > 0.  int8 and packed outputs are written as
// 16-bit pairs into a staging buffer with the swizzle of the store map (boxes
// of 64 rows x 32 or 64 bytes) and written out by TMA stores, clipped to
// M and N, where the output rows are a multiple of 16 bytes; float outputs,
// and bytes otherwise, are stored by the lanes.
template <int MODE, bool GROUPED>
struct Int4WgEpilogue {
  using OutT = typename Int4Epilogue<MODE, GROUPED>::OutT;
  static constexpr bool kSplitB = GROUPED;
  static constexpr bool kResidualBox = false, kColumnsFirst = false;
  static constexpr bool kBytes = MODE == kInt8 || MODE == kPacked;
  Int4Epilogue<MODE, GROUPED> e;
  int M;
  int staged;  // byte output written through map_out

  // bytes of a tile row of the output, and of one store box
  template <int BN>
  __host__ __device__ static constexpr int row_bytes() {
    return MODE == kPacked ? BN / 2 : BN;
  }
  template <int BN>
  __host__ __device__ static constexpr int box_bytes() {
    return GROUPED ? BN / 2 : BN;
  }
  template <int BN>
  __host__ __device__ static constexpr int staging_bytes() {
    return kBytes ? 64 * row_bytes<BN>() : 0;
  }

  // grouped: the first Bt row of the tile's low (half 0) or high half
  __device__ __forceinline__ static int b_row(int n0, int half) {
    return (n0 & ~(kGroup - 1)) + half * kHalf + ((n0 & (kGroup - 1)) >> 1);
  }

  // the staging offset of byte `col` of tile row r: 16-byte chunk c of a box
  // row at c ^ ((r / 2) % 4) (64-byte swizzle) or c ^ ((r / 4) % 2) (32-byte)
  template <int BN>
  __device__ __forceinline__ static int at(int r, int col) {
    constexpr int bb = box_bytes<BN>();
    static_assert(bb == 64 || bb == 32, "store boxes of 64 or 32 bytes");
    const int box = col / bb, in = col % bb, chunk = in >> 4;
    const int swz = bb == 64 ? chunk ^ ((r >> 1) & 3) : chunk ^ ((r >> 2) & 1);
    return box * 64 * bb + r * bb + (swz << 4) + (in & 15);
  }

  __device__ __forceinline__ int code(float v, float os, float q) const {
    return v == 0.f && os > 0.f ? 0 : e.code(v, os, q);
  }

  __device__ __forceinline__ uint32_t nibble_pair(float lo, float hi, float os) const {
    return (static_cast<uint32_t>(code(lo, os, 7.f)) & 0xFu) |
           ((static_cast<uint32_t>(code(hi, os, 7.f)) & 0xFu) << 4);
  }

  __device__ __forceinline__ uint16_t byte_pair(float v0, float v1, float os) const {
    return static_cast<uint16_t>((code(v0, os, e.qmax) & 0xFF) | ((code(v1, os, e.qmax) & 0xFF) << 8));
  }

  template <int BN>
  __device__ __forceinline__ void store(const int (&acc)[BN / 2], const CUtensorMap* map_out,
                                        int64_t row0, int n0, uint8_t* buf, int g, uint32_t,
                                        int) const {
    const int lane = threadIdx.x & 31, t = lane & 3;
    const int rl = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
    const bool leader = (threadIdx.x & 127) == 0;
    const bool stage_out = kBytes && staged != 0;
    if (stage_out) {
      // the previous tile's stores must have read the buffer
      if (leader) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      cnnq::wg::warpgroup_sync(g);
    }
    const float os = kBytes ? *e.out_scale : 1.f;
    const int N = e.N;
    if constexpr (!GROUPED) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = n0 + 8 * j + 2 * t;
        const bool in0 = c < N, in1 = c + 1 < N;
        const float a0 = in0 ? e.alpha[c] : 0.f, a1 = in1 ? e.alpha[c + 1] : 0.f;
        const float b0 = in0 && e.beta != nullptr ? e.beta[c] : 0.f;
        const float b1 = in1 && e.beta != nullptr ? e.beta[c + 1] : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rl + 8 * h;
          const int64_t row = row0 + r;
          const float v0 = e.value(acc[4 * j + 2 * h], a0, b0, false, 0, 0.f);
          const float v1 = e.value(acc[4 * j + 2 * h + 1], a1, b1, false, 0, 0.f);
          if constexpr (MODE == kInt8) {
            if (stage_out) {
              *reinterpret_cast<uint16_t*>(buf + at<BN>(r, 8 * j + 2 * t)) = byte_pair(v0, v1, os);
            } else if (row < M && in0) {
              cnnq::store_pair(e.out + row * N + c, code(v0, os, e.qmax), code(v1, os, e.qmax), in1);
            }
          } else if (row < M && in0) {
            cnnq::store_pair(e.out + row * N + c, v0, v1, in1);
          }
        }
      }
    } else {
      constexpr int kSlabs = BN / 16;  // slabs of each half
      const bool has_res = e.res != nullptr;
      const float rs = has_res ? *e.res_scale : 0.f;
      const int64_t half_n = N >> 1;
      const int g0 = n0 & ~(kGroup - 1), j0 = (n0 & (kGroup - 1)) >> 1;
#pragma unroll
      for (int j = 0; j < kSlabs; ++j) {
        const int tb = 8 * j + 2 * t;   // byte of the tile's row
        const int b = j0 + tb;          // byte of the group's row
        const int lo = g0 + b, hi = lo + kHalf;
        const float alo0 = e.alpha[lo], alo1 = e.alpha[lo + 1];
        const float ahi0 = e.alpha[hi], ahi1 = e.alpha[hi + 1];
        const bool bt = e.beta != nullptr;
        const float blo0 = bt ? e.beta[lo] : 0.f, blo1 = bt ? e.beta[lo + 1] : 0.f;
        const float bhi0 = bt ? e.beta[hi] : 0.f, bhi1 = bt ? e.beta[hi + 1] : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rl + 8 * h;
          const int64_t row = row0 + r;
          const bool ok = row < M;
          uint32_t rw = 0;  // residual bytes b (low 8 bits) and b + 1
          if (has_res && ok) {
            rw = *reinterpret_cast<const uint16_t*>(e.res + row * half_n + (g0 >> 1) + b);
          }
          const int rlo0 = static_cast<int8_t>((rw << 4) & 0xFFu) >> 4;
          const int rhi0 = static_cast<int8_t>(rw & 0xFFu) >> 4;
          const int rlo1 = static_cast<int8_t>((rw >> 4) & 0xF0u) >> 4;
          const int rhi1 = static_cast<int8_t>((rw >> 8) & 0xFFu) >> 4;
          const int* a_lo = &acc[4 * j + 2 * h];
          const int* a_hi = &acc[4 * (j + kSlabs) + 2 * h];
          const float vlo0 = e.value(a_lo[0], alo0, blo0, has_res, rlo0, rs);
          const float vlo1 = e.value(a_lo[1], alo1, blo1, has_res, rlo1, rs);
          const float vhi0 = e.value(a_hi[0], ahi0, bhi0, has_res, rhi0, rs);
          const float vhi1 = e.value(a_hi[1], ahi1, bhi1, has_res, rhi1, rs);
          if constexpr (MODE == kPacked) {
            const uint16_t word =
                static_cast<uint16_t>(nibble_pair(vlo0, vhi0, os) | (nibble_pair(vlo1, vhi1, os) << 8));
            if (stage_out) {
              *reinterpret_cast<uint16_t*>(buf + at<BN>(r, tb)) = word;
            } else if (ok) {
              *reinterpret_cast<uint16_t*>(e.out + row * half_n + (g0 >> 1) + b) = word;
            }
          } else if constexpr (MODE == kInt8) {
            const uint16_t wlo = byte_pair(vlo0, vlo1, os), whi = byte_pair(vhi0, vhi1, os);
            if (stage_out) {
              *reinterpret_cast<uint16_t*>(buf + at<BN>(r, tb)) = wlo;
              *reinterpret_cast<uint16_t*>(buf + at<BN>(r, BN / 2 + tb)) = whi;
            } else if (ok) {
              *reinterpret_cast<uint16_t*>(e.out + row * N + lo) = wlo;
              *reinterpret_cast<uint16_t*>(e.out + row * N + hi) = whi;
            }
          } else if (ok) {
            cnnq::store_pair(e.out + row * N + lo, vlo0, vlo1, true);
            cnnq::store_pair(e.out + row * N + hi, vhi0, vhi1, true);
          }
        }
      }
    }
    if (stage_out) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      cnnq::wg::warpgroup_sync(g);
      if (leader) {
        constexpr int bb = box_bytes<BN>();
        const int g0 = n0 & ~(kGroup - 1), j0 = (n0 & (kGroup - 1)) >> 1;
#pragma unroll
        for (int box = 0; box < row_bytes<BN>() / bb; ++box) {
          // the box's first output byte: packed, the group's bytes from j0;
          // int8 grouped, the low or the high half's codes from j0
          const int col = !GROUPED ? n0 + box * bb
                          : MODE == kPacked ? (g0 >> 1) + j0
                                            : g0 + box * kHalf + j0;
          cnnq::wg::tma_store_2d(map_out, cnnq::wg::smem_u32(buf + box * 64 * bb), col,
                                 static_cast<int>(row0));
        }
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
  }
};

// The route's tiles are 128 x 64 in every mode, three blocks an SM: the
// epilogue (a true division for each int8 or packed code) bounds every
// serving shape, and 64 columns keep a lane's sums at 32 registers, so 24
// consumer warps an SM share the card's issue slots: tiles of 128 and 256
// columns at one or two blocks an SM ran slower on the H100 (PERF.md §6).
// Packed A fills the stages in pairs, so the count at 128-byte boxes is
// even.
constexpr int kInt4BN = 64;
template <int BK>
struct Int4Ring;
template <>
struct Int4Ring<128> : cnnq::wg::Ring<kInt4BN, 2, 3, 128> {};
template <>
struct Int4Ring<64> : cnnq::wg::Ring<kInt4BN, 4, 3, 64> {};

// What the TMA + wgmma route takes: packed A with K % 256 == 0 (always, see
// below) or unpacked A with K % 16 == 0, every operand 16-byte aligned.
// int4_matmul.int4_route is the same test in Python.
bool wgmma_describable(const void* a, const void* bt, const void* residual, const void* out, int64_t K,
                       bool a_packed) {
  using cnnq::wg::aligned16;
  return (a_packed ? K % kGroup == 0 : K % 16 == 0) && aligned16(a) && aligned16(bt) &&
         (residual == nullptr || aligned16(residual)) && aligned16(out);
}

template <int MODE, bool GROUPED, int BK, typename A>
int run_wgmma(const void* a, const Args& g) {
  constexpr int BN = kInt4BN;
  using Epi = Int4WgEpilogue<MODE, GROUPED>;
  using cnnq::wg::make_map;
  constexpr CUtensorMapDataType kU8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  Epi epi{{static_cast<typename Epi::OutT*>(g.out), static_cast<const float*>(g.alpha),
           static_cast<const float*>(g.beta), static_cast<const int8_t*>(g.res),
           static_cast<const float*>(g.res_scale), static_cast<const float*>(g.out_scale), g.qmax,
           static_cast<int>(g.N), g.relu},
          static_cast<int>(g.M),
          0};
  CUtensorMap map_a, map_b, map_out = {};
  bool ok = A::kPacked ? make_map(&map_a, kU8, 1, a, g.M, g.K / 2, cnnq::wg::kBM)
                       : make_map(&map_a, kU8, 1, a, g.M, g.K, cnnq::wg::kBM, BK);
  ok = ok && make_map(&map_b, kU8, 1, g.bt, g.N, g.K, GROUPED ? BN / 2 : BN, BK);
  if constexpr (Epi::kBytes) {
    const int64_t cols = MODE == kPacked ? g.N / 2 : g.N;
    epi.staged = cols % 16 == 0 && cnnq::wg::aligned16(g.out);
    if (ok && epi.staged != 0) {
      ok = make_map(&map_out, kU8, 1, g.out, g.M, cols, 64, Epi::template box_bytes<BN>());
    }
  }
  if (!ok) return -1;
  return cnnq::wg::launch<Int4Ring<BK>>(map_a, map_b, map_out, CUtensorMap{}, A{}, epi, g.M, g.N,
                                        g.K, g.stream);
}

// packed A: 128-byte boxes; unpacked A: 64-byte boxes for a K of at most 64
template <int MODE, bool GROUPED>
int run_wgmma_a(const void* a, bool a_packed, const Args& g) {
  if (a_packed) return run_wgmma<MODE, GROUPED, 128, cnnq::wg::PackedA>(a, g);
  if (g.K <= 64) return run_wgmma<MODE, GROUPED, 64, cnnq::wg::DenseA>(a, g);
  return run_wgmma<MODE, GROUPED, 128, cnnq::wg::DenseA>(a, g);
}

int run_wgmma_mode(const void* a, bool a_packed, int out_mode, bool grouped, const Args& g) {
  if (grouped) {
    switch (out_mode) {
      case kF32: return run_wgmma_a<kF32, true>(a, a_packed, g);
      case kBF16: return run_wgmma_a<kBF16, true>(a, a_packed, g);
      case kInt8: return run_wgmma_a<kInt8, true>(a, a_packed, g);
      default: return run_wgmma_a<kPacked, true>(a, a_packed, g);
    }
  }
  switch (out_mode) {
    case kF32: return run_wgmma_a<kF32, false>(a, a_packed, g);
    case kBF16: return run_wgmma_a<kBF16, false>(a, a_packed, g);
    default: return run_wgmma_a<kInt8, false>(a, a_packed, g);
  }
}

}  // namespace

// a: [M, K] int8 codes, or [M, K/2] packed bytes when a_packed (K % 256 == 0).
// bt: [N, K] int8.  out_mode: 0 = float32, 1 = bfloat16, 2 = int8 codes
// clipped to +-out_qmax, 3 = packed codes clipped to +-7 ([M, N/2] bytes).
// beta, residual ([M, N/2] packed bytes) may be null; a residual or a packed
// output needs N % 256 == 0.  res_scale and out_scale point to one float32
// each in device memory.  route: 1 = TMA + wgmma, only where
// wgmma_describable; 0 = mma.sync, any operands.  Returns
// cudaGetLastError() after the launch, or -1 for arguments the kernel does
// not take; the caller raises on any non-zero code.
extern "C" int cnnq_int4_gemm(const void* a, const void* bt, void* out, const void* alpha,
                              const void* beta, const void* residual, const void* res_scale,
                              const void* out_scale, int64_t M, int64_t N, int64_t K, int a_packed,
                              int relu, int out_mode, float out_qmax, int route, void* stream) {
  if (M < 0 || N < 0 || K <= 0 || out_mode < kF32 || out_mode > kPacked) return -1;
  if (N > 2147483647LL || K > 2147483647LL - 64) return -1;
  const bool grouped = residual != nullptr || out_mode == kPacked;
  if (a_packed && (K % kGroup != 0 || !aligned(a, 16))) return -1;
  if (grouped && N % kGroup != 0) return -1;
  if (residual != nullptr && (res_scale == nullptr || !aligned(residual, 4))) return -1;
  if ((out_mode == kInt8 || out_mode == kPacked) && out_scale == nullptr) return -1;
  if (out_mode == kPacked && !aligned(out, 4)) return -1;
  if (route != 0 && (route != 1 || !wgmma_describable(a, bt, residual, out, K, a_packed != 0))) {
    return -1;
  }
  if (M == 0 || N == 0) return 0;
  (void)cudaGetLastError();  // what this call returns is its own launch's error
  const int8_t* ap = static_cast<const int8_t*>(a);
  const Int4A A{ap,
                M,
                static_cast<int>(K),
                static_cast<int>(a_packed ? K / 2 : K),
                a_packed != 0,
                (K % 16 == 0) && aligned(a, 16)};
  const Args g{bt, alpha, beta, residual, res_scale, out_scale, out,
               M,  N,     K,    out_qmax, relu,      static_cast<cudaStream_t>(stream)};
  int rc;
  if (route == 1) {
    if (M > 2147483647LL - cnnq::wg::kBM) return -1;
    rc = run_wgmma_mode(a, a_packed != 0, out_mode, grouped, g);
    if (rc != 0) return rc;
    return static_cast<int>(cudaGetLastError());
  }
  switch (out_mode * 2 + (grouped ? 1 : 0)) {
    case kF32 * 2: rc = run<kF32, false>(A, g); break;
    case kF32 * 2 + 1: rc = run<kF32, true>(A, g); break;
    case kBF16 * 2: rc = run<kBF16, false>(A, g); break;
    case kBF16 * 2 + 1: rc = run<kBF16, true>(A, g); break;
    case kInt8 * 2: rc = run<kInt8, false>(A, g); break;
    case kInt8 * 2 + 1: rc = run<kInt8, true>(A, g); break;
    default: rc = run<kPacked, true>(A, g); break;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
