// int8 x int8 -> int32 matrix product with a fused dequant epilogue for Hopper
// (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel in cnn_quantization_tpu/ops/kernels/
// int_matmul.py: int8_matmul_dequant (:58-101) with its body _matmul_kernel
// (:29-46).
//
//   out[m, n] = cast(relu?(float(sum_k a[m, k] * bt[n, k]) * alpha[n] + beta[n]
//                          [+ float(res[m, n]) * res_scale]))
//             | the int8 codes of that value at out_scale
//
// a is [M, K] int8 row-major (an NHWC activation seen as [N*H*W, C]), bt is
// [N, K] int8 row-major, i.e. the right operand transposed (a 1x1 OIHW conv
// weight or an [out, in] linear weight as stored), out is [M, N] float32 or
// bfloat16, or int8 codes where out_scale is given (the next layer's input,
// so a serving block hands codes from kernel to kernel); res, where given, is
// [M, N] int8 codes (a block's identity).
//
// Two routes, chosen by shape, never by error (int_matmul.gemm_route decides
// and passes `route`; this file checks the same condition and refuses a
// mismatch):
//   route 1, K % 16 == 0 and a, bt 16-byte aligned: the TMA + wgmma pipeline
//     of int8_wgmma.cuh (every GEMM of ResNet-50's serving path);
//   route 0, everything else (MobileNet-v2's K = 24): the mma.sync block
//     product of int8_mma.cuh, which masks ragged M, N and K itself (the TPU
//     kernel pads all three to 256 instead).
// Both compute the same exact int32 sums and the same epilogue, bit for bit.
//
// Bound at the serving path's shapes: the 1x1 convs of ResNet-50's first
// stages move far more bytes (an output row per input row, four bytes an
// output in float32, one as codes) than they multiply, so memory bounds them;
// the late stages and large K are bounded by the int8 tensor-core rate.

#include "int8_mma.cuh"
#include "int8_wgmma.cuh"

namespace {

struct DenseA {
  const int8_t* a;
  int64_t M;
  int K;
  bool vec;  // K % 16 == 0 and a is 16-byte aligned

  struct Row {
    const int8_t* p;  // nullptr beyond M
  };

  __device__ __forceinline__ Row row(int64_t m, int /*group*/) const {
    return Row{m < M ? a + m * K : nullptr};
  }

  __device__ __forceinline__ uint4 chunk(const Row& r, int k) const {
    if (r.p == nullptr) return cnnq::zero_chunk();
    return cnnq::load_row_chunk(r.p, k, K, vec);
  }
};

template <typename OutT, bool RES>
int gemm(int route, const void* a, const void* bt, const cnnq::EpiArgs& args, int64_t M, int64_t N,
         int64_t K, cudaStream_t s) {
  if (route == 1) return cnnq::wg::launch_int8_wgmma<OutT, RES>(a, bt, args, M, N, K, s);
  const int8_t* ap = static_cast<const int8_t*>(a);
  const DenseA A{ap, M, static_cast<int>(K),
                 (K % 16 == 0) && (reinterpret_cast<uintptr_t>(ap) % 16 == 0)};
  return cnnq::launch_int8_dequant<DenseA, OutT, RES>(A, bt, args, M, N, K, N, 1, s);
}

}  // namespace

// out_dtype: 0 = float32, 1 = bfloat16: the output's type, or with codes out
// the type the value travels in.  beta may be null (no addition).  out_scale:
// null for a float output, else one float32 in device memory (os_vec 0) or
// one a column (os_vec 1), and out is int8 codes clamped to +-out_qmax.  res:
// null, or [M, N] int8 codes added at the float32 res_scale before the ReLU.
// route: 1 = TMA + wgmma, 0 = mma.sync; it must be the route the shape takes.
// Returns cudaGetLastError() after the launch, or -1 for arguments the kernel
// does not take; the caller raises on any non-zero code.
extern "C" int cnnq_int8_gemm(const void* a, const void* bt, void* out, const void* alpha,
                              const void* beta, const void* out_scale, const void* res,
                              const void* res_scale, int64_t M, int64_t N, int64_t K, int relu,
                              int out_dtype, int os_vec, float out_qmax, int route, void* stream) {
  if (M < 0 || N < 0 || K <= 0 || out_dtype < 0 || out_dtype > 1) return -1;
  if (res != nullptr && res_scale == nullptr) return -1;
  if (route != (cnnq::wg::tma_describable(a, bt, K) ? 1 : 0)) return -1;
  if (M == 0 || N == 0) return 0;
  if (K > 2147483647LL - 64) return -1;
  (void)cudaGetLastError();  // what this call returns is its own launch's error
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cnnq::EpiArgs args{out, static_cast<const float*>(alpha), static_cast<const float*>(beta),
                           relu, out_dtype, static_cast<const float*>(out_scale), os_vec, out_qmax,
                           static_cast<const int8_t*>(res), static_cast<const float*>(res_scale)};
  const bool r = res != nullptr;
  int rc;
  if (out_scale != nullptr) {
    rc = r ? gemm<int8_t, true>(route, a, bt, args, M, N, K, s)
           : gemm<int8_t, false>(route, a, bt, args, M, N, K, s);
  } else if (out_dtype == 0) {
    rc = r ? gemm<float, true>(route, a, bt, args, M, N, K, s)
           : gemm<float, false>(route, a, bt, args, M, N, K, s);
  } else {
    rc = r ? gemm<__nv_bfloat16, true>(route, a, bt, args, M, N, K, s)
           : gemm<__nv_bfloat16, false>(route, a, bt, args, M, N, K, s);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
