// int8 convolution as an implicit GEMM with a fused dequant epilogue for Hopper
// (sm_90a), with a plain C interface.
//
// Takes the place of XLA's native int8 convolution, which the TPU package
// reaches through cnn_quantization_tpu/ops/kernels/int_conv.py: int8_conv
// (:63-108); PyTorch on CUDA has no integer convolution.
//
//   out[n, ho, wo, o] = cast(relu?(float(acc) * alpha[o] + bias[o]
//                                  [+ float(res[n, ho, wo, o]) * res_scale]))
//                     | the int8 codes of that value at out_scale
//   acc = sum_{kh, kw, c} x[n, ho*sh - ph + kh, wo*sw - pw + kw, g*Cg + c]
//                         * w[o, kh, kw, c]            (int32, exact)
//
// x is [N, H, W, C] int8 (an NCHW tensor in channels_last memory), w is
// [O, KH, KW, Cg] int8 (an OIHW weight in channels_last memory, Cg = C /
// groups), out is [N, Ho, Wo, O] float32 or bfloat16, or int8 codes where
// out_scale is given, g = o / (O / groups); res, where given, is int8 codes
// in out's layout.  Codes out and the residual are the tensor-core routes'
// (the epilogues of int8_mma.cuh and int8_wgmma.cuh); the depthwise route has
// neither, and int_conv composes them in PyTorch there.
// Positions outside the image contribute 0: zero padding in the integer
// domain, exact at zero point 0.
//
// Three routes, chosen by shape (int_conv.conv_route decides and passes
// `route`; this file checks the same condition and refuses a route that
// cannot take the shape).  Route 0 computes every shape, so it is also taken
// where a caller asks for it to measure it beside the route the shape takes:
//
// Route 1, depthwise (groups == C == O, any KH x KW, stride and padding): a
// direct kernel without tensor cores.  A thread owns 16 consecutive channels
// of one output position: one 16-byte load per filter tap (C % 16 == 0 and an
// aligned x; otherwise byte by byte, masked), the block's weights staged once
// in shared memory as 4-tap words, four 16-byte stores of float32 (two of
// bfloat16) along C.  The arithmetic is counted in instructions, not bytes: 9
// MACs an output at one sign extension and one IMAD a byte would cost ~2
// instructions a MAC, more than the byte bound allows at [128,144,56,56].
// So the taps go in groups of four (the
// last group padded with zero weights): the four 16-byte tap vectors of a
// group are transposed word by word with __byte_perm (eight a 4 x 4 block)
// so that each word holds four taps of one channel, and one __dp4a sums them:
// 12 instructions for 16 MACs.  Memory bounds what is left: the float32
// output is four times the int8 input, so the stores are what to get right.
//
// Route 2, TMA im2col + wgmma (one group, C a multiple of 64, aligned bases,
// im2col_describable in int8_wgmma.cuh: every 3x3 conv and strided 1x1
// downsample of the ResNet family): the persistent warp-specialised kernel of
// int8_wgmma.cuh with the Im2colA loader.  The left operand is never written
// to memory: for each filter tap and each 128-byte (64-byte at C = 64) slice
// of C, one TMA load in im2col mode fills a tile of 128 consecutive output
// pixels, crossing image rows and images; TMA's zero fill is the padding
// (exact at zero point 0) and its traversal stride the conv's stride.  The
// K order (kh, kw, c) is the weight's, so the weight is the plain 2-D Bt map
// of the GEMM route, and the output [N*Ho*Wo, O] is the GEMM route's output
// with the same epilogue and TMA stores.  Tiles of 128 x 64 for O <= 64,
// else 128 x 128.
//
// Route 0, every other conv (the space-to-depth stem with Cg = 12, grouped
// convolutions, depthwise with a multiplier): the product of int8_mma.cuh with M =
// N*Ho*Wo rows, O / groups columns and K = KH*KW*Cg: the weight already is
// the transposed right operand with K running (kh, kw, c) contiguously, and
// the left operand
// is never written to memory: the loader below resolves an output row to its
// image position once and gathers each 16-byte piece of K from the image when
// the tile is staged.  With Cg a multiple of 16 a piece lies inside one filter
// tap and is one aligned 16-byte load; otherwise (the space-to-depth stem with
// Cg = 12, grouped convolutions, depthwise with a multiplier) each byte is
// located and guarded on its own, a generic loop that is correct for any
// groups.
//
// Bound: a 3x3 conv of ResNet-50 does 2*9*C operations per output, which
// costs one int8 byte read and four float32 bytes written: up to C = 128 the
// memory rate bounds it, from C = 256 on the int8 tensor-core rate.

#include "int8_mma.cuh"
#include "int8_wgmma.cuh"

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

// ------------------------------------------------ the direct depthwise route

constexpr int kDwThreads = 256;
constexpr int kDwMaxSmem = 48 * 1024;

// 16 bytes of channels c0 .. c0 + 15 at p (p points at channel c0); channels
// at or beyond C read as 0.  `vec`: C % 16 == 0 and x is 16-byte aligned.
__device__ __forceinline__ uint4 load_channels(const int8_t* __restrict__ p, int left, bool vec) {
  if (vec) return *reinterpret_cast<const uint4*>(p);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (j < left) w[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(p[j])) << (8 * (j & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void store_channels(float* p, const float (&v)[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    reinterpret_cast<float4*>(p)[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  }
}

__device__ __forceinline__ void store_channels(__nv_bfloat16* p, const float (&v)[16]) {
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  reinterpret_cast<uint4*>(p)[0] = make_uint4(w[0], w[1], w[2], w[3]);
  reinterpret_cast<uint4*>(p)[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

// Block (blockDim.x groups of 16 channels, blockDim.y output positions), grid
// (position blocks, channel blocks); a block walks the positions with a
// stride of gridDim.x * blockDim.y, so the weights it stages in shared memory
// serve many positions.  Shared memory: s_w[g * cb + c] = taps 4g .. 4g + 3
// of the block's channel c as one word, byte j for tap 4g + j, zero beyond the
// filter.
template <typename OutT>
__global__ void __launch_bounds__(kDwThreads)
int8_depthwise_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                      OutT* __restrict__ out, const float* __restrict__ alpha,
                      const float* __restrict__ bias, int64_t positions, int H, int W, int C,
                      int KH, int KW, int sh, int sw, int ph, int pw, int Ho, int Wo, int relu,
                      int vec_in, int vec_out) {
  extern __shared__ uint32_t s_w[];
  const int taps = KH * KW, groups4 = (taps + 3) / 4;
  const int cb = blockDim.x * 16, c_base = blockIdx.y * cb;
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < groups4 * cb; i += nthreads) {
    const int g = i / cb, c = c_base + i % cb;
    uint32_t word = 0u;
    for (int j = 0; j < 4 && c < C && 4 * g + j < taps; ++j) {
      word |= static_cast<uint32_t>(static_cast<uint8_t>(w[static_cast<int64_t>(c) * taps + 4 * g + j]))
              << (8 * j);
    }
    s_w[i] = word;
  }
  __syncthreads();

  const int c0 = c_base + threadIdx.x * 16, left = C - c0;
  if (left <= 0) return;
  float al[16], be[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    al[i] = i < left ? alpha[c0 + i] : 0.f;
    be[i] = (i < left && bias != nullptr) ? bias[c0 + i] : 0.f;
  }
  const uint4* wv0 = reinterpret_cast<const uint4*>(s_w + threadIdx.x * 16);

  for (int64_t pos = static_cast<int64_t>(blockIdx.x) * blockDim.y + threadIdx.y; pos < positions;
       pos += static_cast<int64_t>(gridDim.x) * blockDim.y) {
    int acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0;
    const int wo = static_cast<int>(pos % Wo);
    const int64_t t = pos / Wo;
    const int ho = static_cast<int>(t % Ho);
    const int64_t n = t / Ho;
    const int8_t* xn = x + n * H * W * C + c0;
    const int hi0 = ho * sh - ph, wi0 = wo * sw - pw;
    int kh = 0, kw = 0;  // the filter tap of slot j of group g: 4g + j = kh * KW + kw
    for (int g = 0; g < groups4; ++g) {
      uint4 v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = make_uint4(0u, 0u, 0u, 0u);
        if (4 * g + j < taps) {
          const int hi = hi0 + kh, wi = wi0 + kw;
          if (static_cast<unsigned>(hi) < static_cast<unsigned>(H) &&
              static_cast<unsigned>(wi) < static_cast<unsigned>(W)) {
            v[j] = load_channels(xn + (static_cast<int64_t>(hi) * W + wi) * C, left, vec_in != 0);
          }
          if (++kw == KW) {
            kw = 0;
            ++kh;
          }
        }
      }
      const uint4* wv = wv0 + g * (cb / 4);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // word q of each tap vector holds channels 4q .. 4q + 3; transpose
        // the 4 x 4 bytes so that word k holds the four taps of channel 4q + k
        const uint32_t x0 = (&v[0].x)[q], x1 = (&v[1].x)[q], x2 = (&v[2].x)[q],
                       x3 = (&v[3].x)[q];
        const uint32_t lo01 = __byte_perm(x0, x1, 0x5140), hi01 = __byte_perm(x0, x1, 0x7362);
        const uint32_t lo23 = __byte_perm(x2, x3, 0x5140), hi23 = __byte_perm(x2, x3, 0x7362);
        const uint4 wq = wv[q];
        acc[4 * q + 0] = __dp4a(static_cast<int>(__byte_perm(lo01, lo23, 0x5410)),
                                static_cast<int>(wq.x), acc[4 * q + 0]);
        acc[4 * q + 1] = __dp4a(static_cast<int>(__byte_perm(lo01, lo23, 0x7632)),
                                static_cast<int>(wq.y), acc[4 * q + 1]);
        acc[4 * q + 2] = __dp4a(static_cast<int>(__byte_perm(hi01, hi23, 0x5410)),
                                static_cast<int>(wq.z), acc[4 * q + 2]);
        acc[4 * q + 3] = __dp4a(static_cast<int>(__byte_perm(hi01, hi23, 0x7632)),
                                static_cast<int>(wq.w), acc[4 * q + 3]);
      }
    }

    // the dequant epilogue of int8_mma.cuh, with this thread's alpha and bias
    float v[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      float y = __fmul_rn(__int2float_rn(acc[i]), al[i]);
      if (bias != nullptr) y = __fadd_rn(y, be[i]);
      v[i] = relu != 0 ? fmaxf(y, 0.f) : y;
    }
    OutT* o = out + pos * C + c0;
    if (vec_out != 0 && left >= 16) {
      store_channels(o, v);
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        if (i < left) cnnq::store_pair(o + i, v[i], 0.f, false);
      }
    }
  }
}

template <typename OutT>
int launch_depthwise(const void* x, const void* w, void* out, const void* alpha, const void* bias,
                     int64_t positions, int h, int wd, int c, int kh, int kw, int sh, int sw, int ph,
                     int pw, int ho, int wo, int relu, cudaStream_t stream) {
  if (static_cast<int64_t>(kh) * kw > 2147483647LL / 64) return -1;
  const int64_t groups4 = (static_cast<int64_t>(kh) * kw + 3) / 4;
  const int vectors = (c + 15) / 16;
  // up to 16 channel vectors a block, fewer where the staged weights would
  // not fit in 48 KB (a filter of thousands of taps)
  int bx = vectors < 16 ? vectors : 16;
  while (bx > 1 && groups4 * bx * 64 > kDwMaxSmem) --bx;
  const int by = kDwThreads / bx;
  const int64_t smem = groups4 * bx * 64;
  if (smem > kDwMaxSmem) return -1;
  const int64_t need = (positions + by - 1) / by;
  const int gx = static_cast<int>(need < 4096 ? need : 4096);
  const int gy = (vectors + bx - 1) / bx;
  if (gy > 65535) return -1;
  const bool vec_in = c % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_out = (static_cast<int64_t>(c) * sizeof(OutT)) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  int8_depthwise_kernel<OutT><<<dim3(gx, gy), dim3(bx, by), static_cast<size_t>(smem), stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), static_cast<OutT*>(out),
      static_cast<const float*>(alpha), static_cast<const float*>(bias), positions, h, wd, c, kh, kw,
      sh, sw, ph, pw, ho, wo, relu, vec_in, vec_out);
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT, bool RES>
int conv(int route, const void* x, const cnnq::EpiArgs& args, const void* w, int n, int h, int wd,
         int c, int o, int kh, int kw, int sh, int sw, int ph, int pw, int groups, int ho, int wo,
         cudaStream_t s) {
  if (route == 2) {
    return cnnq::wg::launch_int8_conv_wgmma<OutT, RES>(x, w, args, n, h, wd, c, o, kh, kw, sh, sw,
                                                       ph, pw, ho, wo, s);
  }
  const int cg = c / groups;
  const int64_t K = static_cast<int64_t>(kh) * kw * cg;
  if (K > 2147483647LL - 64) return -1;
  const int8_t* xp = static_cast<const int8_t*>(x);
  const ConvA A{xp, static_cast<int64_t>(n) * ho * wo, h, wd, c, cg, kw, sh, sw, ph, pw, ho, wo,
                static_cast<int>(K), (cg % 16 == 0) && (reinterpret_cast<uintptr_t>(xp) % 16 == 0)};
  return cnnq::launch_int8_dequant<ConvA, OutT, RES>(A, w, args, A.M, o / groups, K, o, groups, s);
}

}  // namespace

// out_dtype: 0 = float32, 1 = bfloat16: the output's type, or with codes out
// the type the value travels in.  bias may be null.  out_scale: null for a
// float output, else one float32 in device memory (os_vec 0) or one an output
// channel (os_vec 1), and out is int8 codes clamped to +-out_qmax.  res: null,
// or int8 codes in out's layout added at the float32 res_scale before the
// ReLU.  Neither on route 1.  route: 2 = TMA im2col + wgmma, 1 = direct
// depthwise, 0 = implicit GEMM on mma.sync; 1 and 2 must be the route the
// shape takes, 0 takes any shape.  Returns cudaGetLastError() after the
// launch, or -1 for arguments the kernel does not take; the caller raises on
// any non-zero code.
extern "C" int cnnq_int8_conv(const void* x, const void* w, void* out, const void* alpha,
                              const void* bias, const void* out_scale, const void* res,
                              const void* res_scale, int n, int h, int wd, int c, int o, int kh,
                              int kw, int sh, int sw, int ph, int pw, int groups, int relu,
                              int out_dtype, int os_vec, float out_qmax, int route, void* stream) {
  if (n < 0 || h <= 0 || wd <= 0 || c <= 0 || o <= 0 || kh <= 0 || kw <= 0 || sh <= 0 || sw <= 0 ||
      ph < 0 || pw < 0 || groups <= 0 || c % groups != 0 || o % groups != 0 || out_dtype < 0 ||
      out_dtype > 1) {
    return -1;
  }
  if (res != nullptr && res_scale == nullptr) return -1;
  const int want = (groups == c && c == o)
                       ? 1
                       : cnnq::wg::im2col_describable(x, w, c, groups, kh, kw, sh, sw, ph, pw) ? 2 : 0;
  if (route != want && route != 0) return -1;
  if (route == 1 && (out_scale != nullptr || res != nullptr)) return -1;
  const int ho = (h + 2 * ph - kh) / sh + 1, wo = (wd + 2 * pw - kw) / sw + 1;
  if (h + 2 * ph < kh || wd + 2 * pw < kw) return -1;
  const int64_t M = static_cast<int64_t>(n) * ho * wo;
  if (M == 0) return 0;
  (void)cudaGetLastError();  // what this call returns is its own launch's error
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    return out_dtype == 0 ? launch_depthwise<float>(x, w, out, alpha, bias, M, h, wd, c, kh, kw, sh,
                                                    sw, ph, pw, ho, wo, relu, s)
                          : launch_depthwise<__nv_bfloat16>(x, w, out, alpha, bias, M, h, wd, c, kh,
                                                            kw, sh, sw, ph, pw, ho, wo, relu, s);
  }
  const cnnq::EpiArgs args{out, static_cast<const float*>(alpha), static_cast<const float*>(bias),
                           relu, out_dtype, static_cast<const float*>(out_scale), os_vec, out_qmax,
                           static_cast<const int8_t*>(res), static_cast<const float*>(res_scale)};
  const bool r = res != nullptr;
  int rc;
  if (out_scale != nullptr) {
    rc = r ? conv<int8_t, true>(route, x, args, w, n, h, wd, c, o, kh, kw, sh, sw, ph, pw, groups, ho,
                                wo, s)
           : conv<int8_t, false>(route, x, args, w, n, h, wd, c, o, kh, kw, sh, sw, ph, pw, groups,
                                 ho, wo, s);
  } else if (out_dtype == 0) {
    rc = r ? conv<float, true>(route, x, args, w, n, h, wd, c, o, kh, kw, sh, sw, ph, pw, groups, ho,
                               wo, s)
           : conv<float, false>(route, x, args, w, n, h, wd, c, o, kh, kw, sh, sw, ph, pw, groups, ho,
                                wo, s);
  } else {
    rc = r ? conv<__nv_bfloat16, true>(route, x, args, w, n, h, wd, c, o, kh, kw, sh, sw, ph, pw,
                                       groups, ho, wo, s)
           : conv<__nv_bfloat16, false>(route, x, args, w, n, h, wd, c, o, kh, kw, sh, sw, ph, pw,
                                        groups, ho, wo, s);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
