// int8 convolution as an implicit GEMM with a fused dequant epilogue for Hopper
// (sm_90a), with a plain C interface.
//
// Takes the place of XLA's native int8 convolution, which the TPU package
// reaches through cnn_quantization_tpu/ops/kernels/int_conv.py: int8_conv
// (:63-108); PyTorch on CUDA has no integer convolution.
//
//   out[n, ho, wo, o] = cast(relu?(float(acc) * alpha[o] + bias[o]))
//   acc = sum_{kh, kw, c} x[n, ho*sh - ph + kh, wo*sw - pw + kw, g*Cg + c]
//                         * w[o, kh, kw, c]            (int32, exact)
//
// x is [N, H, W, C] int8 (an NCHW tensor in channels_last memory), w is
// [O, KH, KW, Cg] int8 (an OIHW weight in channels_last memory, Cg = C /
// groups), out is [N, Ho, Wo, O] float32 or bfloat16, g = o / (O / groups).
// Positions outside the image contribute 0: zero padding in the integer
// domain, exact at zero point 0.
//
// Per group this is the product of int8_mma.cuh with M = N*Ho*Wo rows,
// O / groups columns and K = KH*KW*Cg: the weight already is the transposed
// right operand with K running (kh, kw, c) contiguously, and the left operand
// is never written to memory: the loader below resolves an output row to its
// image position once and gathers each 16-byte piece of K from the image when
// the tile is staged.  With Cg a multiple of 16 a piece lies inside one filter
// tap and is one aligned 16-byte load; otherwise (the space-to-depth stem with
// Cg = 12, grouped and depthwise convolutions) each byte is located and
// guarded on its own, a generic loop that is correct for any groups.
//
// Bound: a 3x3 conv of ResNet-50 does 2*9*C operations per output, which
// costs one int8 byte read and four float32 bytes written: up to C = 128 the
// memory rate bounds it, from C = 256 on the int8 tensor-core rate.

#include "int8_mma.cuh"

namespace {

struct ConvA {
  const int8_t* x;
  int64_t M;
  int H, W, C, Cg, KW, sh, sw, ph, pw, Ho, Wo, K;
  bool vec;  // Cg % 16 == 0 and x is 16-byte aligned

  struct Row {
    const int8_t* p;  // image n, first channel of the group; nullptr beyond M
    int hi0, wi0;     // input position of filter tap (0, 0)
  };

  __device__ __forceinline__ Row row(int64_t m, int group) const {
    if (m >= M) return Row{nullptr, 0, 0};
    const int wo = static_cast<int>(m % Wo);
    const int64_t t = m / Wo;
    const int ho = static_cast<int>(t % Ho);
    const int64_t n = t / Ho;
    return Row{x + n * H * W * C + static_cast<int64_t>(group) * Cg, ho * sh - ph, wo * sw - pw};
  }

  // the address of element k = (kh*KW + kw)*Cg + c of the row, or nullptr in
  // the padding
  __device__ __forceinline__ const int8_t* at(const Row& r, int k) const {
    const int tap = k / Cg, c = k - tap * Cg;
    const int kh = tap / KW, kw = tap - kh * KW;
    const int hi = r.hi0 + kh, wi = r.wi0 + kw;
    if (static_cast<unsigned>(hi) >= static_cast<unsigned>(H) ||
        static_cast<unsigned>(wi) >= static_cast<unsigned>(W)) {
      return nullptr;
    }
    return r.p + (static_cast<int64_t>(hi) * W + wi) * C + c;
  }

  __device__ __forceinline__ uint4 chunk(const Row& r, int k) const {
    if (r.p == nullptr || k >= K) return cnnq::zero_chunk();
    if (vec) {
      const int8_t* p = at(r, k);
      return p == nullptr ? cnnq::zero_chunk() : *reinterpret_cast<const uint4*>(p);
    }
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (k + j < K) {
        const int8_t* p = at(r, k + j);
        if (p != nullptr) w[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(*p)) << (8 * (j & 3));
      }
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

}  // namespace

// out_dtype: 0 = float32, 1 = bfloat16.  bias may be null.  Returns
// cudaGetLastError() after the launch, or -1 for arguments the kernel does
// not take; the caller raises on any non-zero code.
extern "C" int cnnq_int8_conv(const void* x, const void* w, void* out, const void* alpha,
                              const void* bias, int n, int h, int wd, int c, int o, int kh, int kw,
                              int sh, int sw, int ph, int pw, int groups, int relu, int out_dtype,
                              void* stream) {
  if (n < 0 || h <= 0 || wd <= 0 || c <= 0 || o <= 0 || kh <= 0 || kw <= 0 || sh <= 0 || sw <= 0 ||
      ph < 0 || pw < 0 || groups <= 0 || c % groups != 0 || o % groups != 0) {
    return -1;
  }
  const int ho = (h + 2 * ph - kh) / sh + 1, wo = (wd + 2 * pw - kw) / sw + 1;
  if (h + 2 * ph < kh || wd + 2 * pw < kw) return -1;
  const int64_t M = static_cast<int64_t>(n) * ho * wo;
  if (M == 0) return 0;
  const int cg = c / groups;
  const int64_t K = static_cast<int64_t>(kh) * kw * cg;
  if (K > 2147483647LL - 64) return -1;
  const int8_t* xp = static_cast<const int8_t*>(x);
  const ConvA A{xp, M, h, wd, c, cg, kw, sh, sw, ph, pw, ho, wo, static_cast<int>(K),
                (cg % 16 == 0) && (reinterpret_cast<uintptr_t>(xp) % 16 == 0)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (out_dtype == 0) {
    rc = cnnq::launch_int8_mma<ConvA, float>(A, w, out, alpha, bias, M, o / groups, K, o, groups,
                                             relu, s);
  } else if (out_dtype == 1) {
    rc = cnnq::launch_int8_mma<ConvA, __nv_bfloat16>(A, w, out, alpha, bias, M, o / groups, K, o,
                                                     groups, relu, s);
  } else {
    return -1;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
