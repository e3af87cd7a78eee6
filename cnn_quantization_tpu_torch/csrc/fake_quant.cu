// Fused affine fake-quant for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel in cnn_quantization_tpu/ops/kernels/fake_quant.py:
// _fake_quant_2d (:63-105) with both of its bodies, _kernel (:29-37) and
// _kernel_stochastic (:40-56), behind the host entry fake_quant_fused (:108-144).
//
// Computes, for every element i of x seen in memory order as [outer, C, inner]
// (channel of i = (i / inner) % C):
//   mode 0, affine:      q = rint(clamp(x/scale[c] + zp[c], 0, qmax[c]))
//   mode 1, stochastic:  the same with u in [-0.5, 0.5) added before the clamp;
//                        u = (w >> 8) * 2^-24 - 0.5, w = word 0 of
//                        Philox4x32-10(key = seed, counter = i)
//   both:                out = (q - zp[c]) * scale[c]
//   mode 2, reference-CUDA per-tensor semantics (quant_math.
//                        fake_quant_kernel_semantics): from delta and offset,
//                        pass-through when delta <= 0, no 1e-8 scale floor, a
//                        rounded zero point only when the range straddles 0.
// scale/zp and qmax are each one value (stride 0) or one per channel
// (stride 1); a per-channel qmax is how bit allocation applies.  One index
// rule covers channels_last activations (inner = 1), OIHW weights (outer = 1,
// inner = I*KH*KW), per-sample rows (C = N) and per-tensor (C = 1).
//
// Bound: memory.  Each element is read once and written once, (4 + 4) bytes in
// fp32, at 3.35 TB/s on an H100 SXM; a handful of flops per element is far
// below the compute roof.  Design: a grid-stride loop in which each thread
// issues four independent coalesced loads before computing (bytes in flight
// without alignment requirements), the per-tensor constants of mode 2 hoisted
// out of the loop, and the channel index computed only when a parameter is
// per-channel.
//
// Numerics are bit-identical to the plain PyTorch version: rintf (half to
// even, as torch.round), true IEEE division, and every product and sum through
// __fmul_rn/__fadd_rn/__fsub_rn so nothing is contracted into an FMA (the
// build adds --fmad=false as well and never --use_fast_math).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kAffine = 0;
constexpr int kStochastic = 1;
constexpr int kMinMax = 2;

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr unsigned kMaxBlocks = 16384;

__device__ __forceinline__ uint32_t philox4x32_10_word0(uint64_t seed, uint64_t ctr) {
  uint32_t c0 = static_cast<uint32_t>(ctr), c1 = static_cast<uint32_t>(ctr >> 32);
  uint32_t c2 = 0u, c3 = 0u;
  uint32_t k0 = static_cast<uint32_t>(seed), k1 = static_cast<uint32_t>(seed >> 32);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return c0;
}

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// clamp to [0, qmax]; a NaN passes through as in torch.clamp and jnp.clip
__device__ __forceinline__ float clamp_q(float q, float qmax) {
  return q < 0.f ? 0.f : (q > qmax ? qmax : q);
}

struct MinMaxParams {
  float safe_scale, shift, qmax;
  bool straddles, pass;
};

__device__ __forceinline__ MinMaxParams minmax_params(float delta, float offset, float qmax) {
  MinMaxParams p;
  const float scale = __fdiv_rn(delta, qmax);
  p.safe_scale = delta > 0.f ? scale : 1.f;
  const float zero_point = rintf(__fdiv_rn(-offset, p.safe_scale));
  p.straddles = (__fadd_rn(offset, delta) > 0.f) && (offset < 0.f);
  p.shift = p.straddles ? zero_point : -offset;
  p.qmax = qmax;
  p.pass = !(delta > 0.f);
  return p;
}

__device__ __forceinline__ float minmax_fq(float x, const MinMaxParams& p) {
  float q = p.straddles ? __fadd_rn(__fdiv_rn(x, p.safe_scale), p.shift)
                        : __fdiv_rn(__fadd_rn(x, p.shift), p.safe_scale);
  q = rintf(clamp_q(q, p.qmax));
  const float deq = p.straddles ? __fmul_rn(__fsub_rn(q, p.shift), p.safe_scale)
                                : __fsub_rn(__fmul_rn(q, p.safe_scale), p.shift);
  return p.pass ? x : deq;
}

template <typename T, typename Idx, int MODE>
__global__ void __launch_bounds__(kThreads)
fake_quant_kernel(const T* __restrict__ x, T* __restrict__ out, Idx n, Idx channels, Idx inner,
                  const float* __restrict__ p0, const float* __restrict__ p1,
                  const float* __restrict__ qmax, Idx p_stride, Idx q_stride, uint64_t seed) {
  MinMaxParams mm;
  if (MODE == kMinMax) mm = minmax_params(p0[0], p1[0], qmax[0]);
  const bool per_channel = (p_stride | q_stride) != 0;
  const Idx step = static_cast<Idx>(gridDim.x) * kThreads * kUnroll;
  for (Idx base = static_cast<Idx>(blockIdx.x) * kThreads * kUnroll + threadIdx.x; base < n;
       base += step) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const Idx i = base + static_cast<Idx>(u) * kThreads;
      v[u] = i < n ? load_f32(x + i) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const Idx i = base + static_cast<Idx>(u) * kThreads;
      if (i >= n) break;
      float r;
      if (MODE == kMinMax) {
        r = minmax_fq(v[u], mm);
      } else {
        const Idx c = per_channel ? (i / inner) % channels : 0;
        const float s = p0[c * p_stride], z = p1[c * p_stride], qm = qmax[c * q_stride];
        float q = __fadd_rn(__fdiv_rn(v[u], s), z);
        if (MODE == kStochastic) {
          const uint32_t w = philox4x32_10_word0(seed, static_cast<uint64_t>(i));
          const float noise = __fsub_rn(__fmul_rn(static_cast<float>(w >> 8), 5.9604644775390625e-08f), 0.5f);
          q = __fadd_rn(q, noise);
        }
        q = rintf(clamp_q(q, qm));
        r = __fmul_rn(__fsub_rn(q, z), s);
      }
      store_f32(out + i, r);
    }
  }
}

template <typename T, typename Idx>
void launch_typed(const void* x, void* out, int64_t n, int64_t channels, int64_t inner,
                  const void* p0, const void* p1, const void* qmax, int64_t p_stride,
                  int64_t q_stride, int mode, uint64_t seed, cudaStream_t stream) {
  const int64_t per_block = static_cast<int64_t>(kThreads) * kUnroll;
  int64_t blocks = (n + per_block - 1) / per_block;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const dim3 grid(static_cast<unsigned>(blocks));
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  const float* a = static_cast<const float*>(p0);
  const float* b = static_cast<const float*>(p1);
  const float* q = static_cast<const float*>(qmax);
  switch (mode) {
    case kAffine:
      fake_quant_kernel<T, Idx, kAffine><<<grid, kThreads, 0, stream>>>(
          xp, op, n, channels, inner, a, b, q, p_stride, q_stride, seed);
      break;
    case kStochastic:
      fake_quant_kernel<T, Idx, kStochastic><<<grid, kThreads, 0, stream>>>(
          xp, op, n, channels, inner, a, b, q, p_stride, q_stride, seed);
      break;
    default:
      fake_quant_kernel<T, Idx, kMinMax><<<grid, kThreads, 0, stream>>>(
          xp, op, n, channels, inner, a, b, q, p_stride, q_stride, seed);
      break;
  }
}

template <typename T>
void launch_indexed(const void* x, void* out, int64_t n, int64_t channels, int64_t inner,
                    const void* p0, const void* p1, const void* qmax, int64_t p_stride,
                    int64_t q_stride, int mode, uint64_t seed, cudaStream_t stream) {
  // 32-bit indices while base + step cannot overflow them
  const int64_t step = static_cast<int64_t>(kMaxBlocks) * kThreads * kUnroll;
  if (n + step < (int64_t{1} << 32)) {
    launch_typed<T, uint32_t>(x, out, n, channels, inner, p0, p1, qmax, p_stride, q_stride, mode,
                              seed, stream);
  } else {
    launch_typed<T, uint64_t>(x, out, n, channels, inner, p0, p1, qmax, p_stride, q_stride, mode,
                              seed, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  mode: 0 affine, 1 stochastic, 2 reference
// per-tensor semantics (p0 = delta, p1 = offset).  Returns cudaGetLastError()
// after the launch; the caller raises on any non-zero code.
extern "C" int cnnq_fake_quant(const void* x, void* out, int64_t n, int64_t channels,
                               int64_t inner, const void* p0, const void* p1, const void* qmax,
                               int64_t p_stride, int64_t q_stride, int mode, int dtype,
                               uint64_t seed, void* stream) {
  if (n <= 0) return 0;
  if (channels <= 0 || inner <= 0 || mode < kAffine || mode > kMinMax) return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_indexed<float>(x, out, n, channels, inner, p0, p1, qmax, p_stride, q_stride, mode, seed,
                          s);
  } else if (dtype == 1) {
    launch_indexed<__nv_bfloat16>(x, out, n, channels, inner, p0, p1, qmax, p_stride, q_stride,
                                  mode, seed, s);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
