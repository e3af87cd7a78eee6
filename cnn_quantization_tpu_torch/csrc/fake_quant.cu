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
//
// The same library holds the serving path's float hand-off, which replaces no
// TPU kernel (XLA fuses it into the producer there): the int8 codes of float
// activations, int_matmul.quantize_sym_codes on a CUDA tensor,
//   code[i] = clamp(rint(x[i] / scale[c]), -qmax, qmax), 0 where the quotient
//             is NaN (what PyTorch's float-to-int8 cast gives),
// with one scale or one per channel, channel c as above.  Bound: memory, 4 (or
// 2) bytes read and 1 written an element.  Design: 16-byte loads of x, four in
// flight a thread, the codes of one load stored at once; a scalar head up to
// x's first 16-byte boundary and a ragged tail; one block a resident slot,
// walking the tensor.  The quotient is cnnq::quotient (int8_mma.cuh): div.rn's
// result bit for bit from a reciprocal made once a scale (per-channel scales'
// in shared memory, or made again an element past kCodeMaxChannels), so no
// full division per element bounds the instruction rate.
// The kernel's name holds "elementwise_kernel": profiles class it with the
// elementwise passes it replaces.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_mma.cuh"

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

namespace cnnq {

constexpr int kCodeThreads = 256;
constexpr int kCodeUnroll = 4;           // 16-byte loads in flight a thread
constexpr int kCodeMaxChannels = 4096;   // per-channel divisors held in shared memory: 48 KB

// rint(v / s) clamped to +-q; 0 where the quotient is NaN, as the cast gives
__device__ __forceinline__ int8_t code_at(float v, const Divisor& d, float q) {
  const float quo = quotient(v, d);
  return static_cast<int8_t>(quo != quo ? 0 : code_of(quo, q));
}

// the floats of one 16-byte load: 4 float32, or 8 bfloat16 widened (a
// bfloat16 is the upper half of its float32)
__device__ __forceinline__ void widen(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}

__device__ __forceinline__ void widen(const uint4& r, float (&f)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(w[k] << 16);
    f[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ uint32_t pack4(const int8_t* c) {
  return static_cast<uint32_t>(static_cast<uint8_t>(c[0])) |
         static_cast<uint32_t>(static_cast<uint8_t>(c[1])) << 8 |
         static_cast<uint32_t>(static_cast<uint8_t>(c[2])) << 16 |
         static_cast<uint32_t>(static_cast<uint8_t>(c[3])) << 24;
}

// V codes to p: one 4- or 8-byte store where `vec` (p aligned to V), else bytes
template <int V>
__device__ __forceinline__ void store_codes(int8_t* p, const int8_t (&c)[V], bool vec) {
  if (vec) {
    if constexpr (V == 4) {
      *reinterpret_cast<uint32_t*>(p) = pack4(c);
    } else {
      *reinterpret_cast<uint2*>(p) = make_uint2(pack4(c), pack4(c + 4));
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) p[k] = c[k];
  }
}

// x [n] in memory order (float32 or bfloat16) -> out [n] int8 codes.  The
// head (elements before x + head, 16-byte aligned) and the tail (after the
// last whole 16-byte group) are fewer than V each and take one thread an
// element; the groups between take 16-byte loads.  `vec_out`: out + head is
// aligned for a V-byte store.
// how an element finds its scale's divisor: one for all, a table of the
// channels' in shared memory, or (past kCodeMaxChannels) its channel's made
// again an element
enum CodeScales { kOneScale, kScaleTable, kScaleEach };

template <typename T, typename Idx, int SCALES>
__global__ void __launch_bounds__(kCodeThreads)
quantize_codes_elementwise_kernel(const T* __restrict__ x, int8_t* __restrict__ out, Idx n,
                                  Idx head, Idx channels, Idx inner,
                                  const float* __restrict__ scale, float q, bool vec_out) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char codes_smem[];
  Divisor* divs = reinterpret_cast<Divisor*>(codes_smem);
  Divisor d_all{};
  if constexpr (SCALES == kScaleTable) {
    for (Idx c = threadIdx.x; c < channels; c += kCodeThreads) divs[c] = divisor(__ldg(scale + c));
    __syncthreads();
  } else if constexpr (SCALES == kOneScale) {
    d_all = divisor(__ldg(scale));
  }
  auto div_of = [&](Idx c) {
    if constexpr (SCALES == kScaleTable) {
      return divs[c];
    } else if constexpr (SCALES == kScaleEach) {
      return divisor(__ldg(scale + c));
    } else {
      return d_all;
    }
  };
  const Idx groups = (n - head) / V;
  const Idx tail = head + groups * V;
  const Idx tid = static_cast<Idx>(blockIdx.x) * kCodeThreads + threadIdx.x;
  if (tid < head + (n - tail)) {
    const Idx i = tid < head ? tid : tail + (tid - head);
    out[i] = code_at(load_f32(x + i), div_of((i / inner) % channels), q);
  }
  const Idx step = static_cast<Idx>(gridDim.x) * kCodeThreads * kCodeUnroll;
  for (Idx g0 = static_cast<Idx>(blockIdx.x) * kCodeThreads * kCodeUnroll + threadIdx.x;
       g0 < groups; g0 += step) {
    uint4 raw[kCodeUnroll];
#pragma unroll
    for (int u = 0; u < kCodeUnroll; ++u) {
      const Idx g = g0 + static_cast<Idx>(u) * kCodeThreads;
      if (g < groups) raw[u] = *reinterpret_cast<const uint4*>(x + head + g * V);
    }
#pragma unroll
    for (int u = 0; u < kCodeUnroll; ++u) {
      const Idx g = g0 + static_cast<Idx>(u) * kCodeThreads;
      if (g >= groups) break;
      const Idx e = head + g * V;
      float f[V];
      widen(raw[u], f);
      int8_t c[V];
      if constexpr (SCALES != kOneScale) {
        // element e's channel, then the next element's by counting
        Idx ch = (e / inner) % channels, r = e % inner;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          c[k] = code_at(f[k], div_of(ch), q);
          if (++r == inner) {
            r = 0;
            if (++ch == channels) ch = 0;
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) c[k] = code_at(f[k], d_all, q);
      }
      store_codes<V>(out + e, c, vec_out);
    }
  }
}

// blocks that fit on the card at once (2048 threads an SM), per device
inline int64_t resident_blocks() {
  static int sms[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 1024;
  if (sms[dev] == 0) cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int64_t>(sms[dev]) * (2048 / kCodeThreads);
}

template <typename T, typename Idx>
void launch_codes(const void* x, void* out, int64_t n, int64_t channels, int64_t inner,
                  const float* scale, bool per_channel, float q, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  int64_t head = static_cast<int64_t>((16 - reinterpret_cast<uintptr_t>(x) % 16) % 16 / sizeof(T));
  if (head > n) head = n;
  const bool vec_out = (reinterpret_cast<uintptr_t>(out) + head) % V == 0;
  const int64_t per_block = static_cast<int64_t>(kCodeThreads) * kCodeUnroll;
  int64_t blocks = ((n - head) / V + per_block - 1) / per_block;
  const int64_t most = resident_blocks();
  if (blocks > most) blocks = most;
  if (blocks < 1) blocks = 1;   // the head and the tail
  const T* xp = static_cast<const T*>(x);
  int8_t* op = static_cast<int8_t*>(out);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (!per_channel) {
    quantize_codes_elementwise_kernel<T, Idx, kOneScale><<<grid, kCodeThreads, 0, stream>>>(
        xp, op, n, head, channels, inner, scale, q, vec_out);
  } else if (channels <= kCodeMaxChannels) {
    quantize_codes_elementwise_kernel<T, Idx, kScaleTable>
        <<<grid, kCodeThreads, channels * sizeof(Divisor), stream>>>(
            xp, op, n, head, channels, inner, scale, q, vec_out);
  } else {
    quantize_codes_elementwise_kernel<T, Idx, kScaleEach><<<grid, kCodeThreads, 0, stream>>>(
        xp, op, n, head, channels, inner, scale, q, vec_out);
  }
}

}  // namespace cnnq

// The int8 codes of x (n elements in memory order, float32 or bfloat16 by
// dtype as above) on the grid scale * [-qmax, qmax]: scale is one float32 in
// device memory, or one a channel where per_channel (channel of i = (i /
// inner) % channels).  out is n int8 in x's order.  Returns -1 for a
// malformed call, else cudaGetLastError() after the launch; the caller raises
// on any non-zero code.
extern "C" int cnnq_quantize_codes(const void* x, void* out, int64_t n, int64_t channels,
                                   int64_t inner, const void* scale, int per_channel, float qmax,
                                   int dtype, void* stream) {
  if (n <= 0) return 0;
  if (channels <= 0 || inner <= 0) return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const bool pc = per_channel != 0;
  // 32-bit indices while an index plus a step of the walk cannot overflow them
  const bool narrow = n < (int64_t{1} << 31);
  if (dtype == 0) {
    if (narrow) cnnq::launch_codes<float, uint32_t>(x, out, n, channels, inner, sc, pc, qmax, s);
    else cnnq::launch_codes<float, uint64_t>(x, out, n, channels, inner, sc, pc, qmax, s);
  } else if (dtype == 1) {
    if (narrow) {
      cnnq::launch_codes<__nv_bfloat16, uint32_t>(x, out, n, channels, inner, sc, pc, qmax, s);
    } else {
      cnnq::launch_codes<__nv_bfloat16, uint64_t>(x, out, n, channels, inner, sc, pc, qmax, s);
    }
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
