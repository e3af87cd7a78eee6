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
// Design.  The block product is int8_mma.cuh's (128 x 64 tiles,
// mma.sync.m16n8k32.s8; Hopper's tensor cores have no 4-bit integer type, so
// nibbles become int8 before the product), through two additions:
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

namespace {

constexpr int kGroup = 256;  // channels per packing group
constexpr int kHalf = 128;   // bytes per group

enum OutMode { kF32 = 0, kBF16 = 1, kInt8 = 2, kPacked = 3 };

// four bytes' low or high nibbles, each sign extended to a byte
__device__ __forceinline__ uint32_t nibbles_to_bytes(uint32_t w, bool high) {
  const uint32_t x = (high ? (w >> 4) : w) & 0x0F0F0F0Fu;
  return __vsub4(x ^ 0x08080808u, 0x08080808u);
}

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

__device__ __forceinline__ void store_pair(int8_t* p, int c0, int c1, bool two) {
  if (two && (reinterpret_cast<uintptr_t>(p) & 1u) == 0) {
    *reinterpret_cast<char2*>(p) = make_char2(static_cast<signed char>(c0),
                                              static_cast<signed char>(c1));
  } else {
    p[0] = static_cast<int8_t>(c0);
    if (two) p[1] = static_cast<int8_t>(c1);
  }
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
              store_pair(p, code(v0, os, q), code(v1, os, q), two);
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

}  // namespace

// a: [M, K] int8 codes, or [M, K/2] packed bytes when a_packed (K % 256 == 0).
// bt: [N, K] int8.  out_mode: 0 = float32, 1 = bfloat16, 2 = int8 codes
// clipped to +-out_qmax, 3 = packed codes clipped to +-7 ([M, N/2] bytes).
// beta, residual ([M, N/2] packed bytes) may be null; a residual or a packed
// output needs N % 256 == 0.  res_scale and out_scale point to one float32
// each in device memory.  Returns cudaGetLastError() after the launch, or -1
// for arguments the kernel does not take; the caller raises on any non-zero
// code.
extern "C" int cnnq_int4_gemm(const void* a, const void* bt, void* out, const void* alpha,
                              const void* beta, const void* residual, const void* res_scale,
                              const void* out_scale, int64_t M, int64_t N, int64_t K, int a_packed,
                              int relu, int out_mode, float out_qmax, void* stream) {
  if (M < 0 || N < 0 || K <= 0 || out_mode < kF32 || out_mode > kPacked) return -1;
  if (N > 2147483647LL || K > 2147483647LL - 64) return -1;
  const bool grouped = residual != nullptr || out_mode == kPacked;
  if (a_packed && (K % kGroup != 0 || !aligned(a, 16))) return -1;
  if (grouped && N % kGroup != 0) return -1;
  if (residual != nullptr && (res_scale == nullptr || !aligned(residual, 4))) return -1;
  if ((out_mode == kInt8 || out_mode == kPacked) && out_scale == nullptr) return -1;
  if (out_mode == kPacked && !aligned(out, 4)) return -1;
  if (M == 0 || N == 0) return 0;
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
