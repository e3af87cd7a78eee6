// int8 x int8 -> int32 matrix product with a fused dequant epilogue for Hopper
// (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel in cnn_quantization_tpu/ops/kernels/
// int_matmul.py: int8_matmul_dequant (:58-101) with its body _matmul_kernel
// (:29-46).
//
//   out[m, n] = cast(relu?(float(sum_k a[m, k] * bt[n, k]) * alpha[n] + beta[n]))
//
// a is [M, K] int8 row-major (an NHWC activation seen as [N*H*W, C]), bt is
// [N, K] int8 row-major, i.e. the right operand transposed (a 1x1 OIHW conv
// weight or an [out, in] linear weight as stored), out is [M, N] float32 or
// bfloat16.  The block-level product, the masking of ragged M, N and K (the
// TPU kernel pads all three to 256 instead) and the epilogue are in
// int8_mma.cuh.
//
// Bound at the serving path's shapes: the 1x1 convs of ResNet-50's first
// stages move far more bytes (a float32 output row per input row) than they
// multiply, so memory bounds them; the late stages and large K are bounded by
// the int8 tensor-core rate.

#include "int8_mma.cuh"

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

}  // namespace

// out_dtype: 0 = float32, 1 = bfloat16.  beta may be null (no addition).
// Returns cudaGetLastError() after the launch, or -1 for arguments the kernel
// does not take; the caller raises on any non-zero code.
extern "C" int cnnq_int8_gemm(const void* a, const void* bt, void* out, const void* alpha,
                              const void* beta, int64_t M, int64_t N, int64_t K, int relu,
                              int out_dtype, void* stream) {
  if (M < 0 || N < 0 || K <= 0) return -1;
  if (M == 0 || N == 0) return 0;
  if (K > 2147483647LL - 64) return -1;
  const int8_t* ap = static_cast<const int8_t*>(a);
  const DenseA A{ap, M, static_cast<int>(K),
                 (K % 16 == 0) && (reinterpret_cast<uintptr_t>(ap) % 16 == 0)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (out_dtype == 0) {
    rc = cnnq::launch_int8_mma<DenseA, float>(A, bt, out, alpha, beta, M, N, K, N, 1, relu, s);
  } else if (out_dtype == 1) {
    rc = cnnq::launch_int8_mma<DenseA, __nv_bfloat16>(A, bt, out, alpha, beta, M, N, K, N, 1, relu,
                                                      s);
  } else {
    return -1;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
