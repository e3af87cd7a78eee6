// Streaming int8 copy with a device-side scalar added and per-block partial
// sums, for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel of the throughput bench's memory-rate probe,
// bench.py:_dma_probe._copy_kernel (:315-326, reached by pl.pallas_call at
// :331).
//
//   out[i]  = (int8)((int32)a[i] + s)         two's-complement wrap: 127 + 1 -> -128
//   psum[b] = sum over block b's elements of ((int32)a[i] + s), BEFORE narrowing,
//             in wrapping int32 arithmetic
//
// a and out are n int8 values in memory order (the probe's [M, C] tensor is
// elementwise, so its shape does not matter here); s is one int32 read through
// a device pointer, so a chain of steps never waits for the host.  The next
// step's scalar is derived from the total of ALL partial sums, which makes it
// depend on every block of this step: consecutive steps can neither overlap
// nor be folded.
//
// Partial-sum layout: ONE int32 per thread block, psum[gridDim.x].  The TPU
// kernel wrote an 8-row block per grid step with the column sums in row 0;
// that was Mosaic's sublane rule and has no counterpart here.  Only the total
// of the partial sums is part of the contract.
//
// Bound: memory.  Every byte is read once and written once (2n bytes at
// 3.35 TB/s on an H100 SXM; the partial sums are a few kilobytes); one byte-wise
// add and a quarter of a dp4a per element are far below any compute roof.
// Design: a grid-stride loop over 16-byte vectors, four independent loads in
// flight per thread, __vadd4 for the wrapping per-byte add, __dp4a against
// 0x01010101 for the sum of a word's four signed bytes, a warp-shuffle then
// shared-memory reduction, one store per block.  A buffer that is not 16-byte
// aligned, and the last n % 16 elements, take a byte-wise path.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kVecBytes = 16;
// 16 blocks of 256 threads fill each of the 132 SMs' 2048 thread slots twice over
constexpr int64_t kMaxBlocks = 132 * 16;

__host__ __device__ inline int64_t blocks_for(int64_t n) {
  const int64_t per_block = static_cast<int64_t>(kThreads) * kUnroll * kVecBytes;
  int64_t blocks = (n + per_block - 1) / per_block;
  if (blocks < 1) blocks = 1;
  return blocks > kMaxBlocks ? kMaxBlocks : blocks;
}

// one 32-bit word = four int8: the wrapped bytes and the sum of the four
// signed bytes (s is added to the sum once per element by the caller)
__device__ __forceinline__ uint32_t add_word(uint32_t w, uint32_t s_bytes, uint32_t& acc) {
  acc += static_cast<uint32_t>(__dp4a(static_cast<int>(w), 0x01010101, 0));
  return __vadd4(w, s_bytes);
}

__global__ void __launch_bounds__(kThreads)
stream_copy_kernel(const int8_t* __restrict__ a, const int32_t* __restrict__ s_ptr,
                   int8_t* __restrict__ out, int32_t* __restrict__ psum, int64_t n, int vec) {
  const int32_t s = *s_ptr;
  const uint32_t s_byte = static_cast<uint32_t>(s) & 0xFFu;
  const uint32_t s_bytes = s_byte * 0x01010101u;
  // unsigned arithmetic: the int32 wrap is defined behaviour
  uint32_t acc = 0;       // sum of the int8 values this thread read
  uint32_t count = 0;     // how many it read (s is added count times at the end)

  const int64_t n_vec = vec ? n / kVecBytes : 0;
  const uint4* a4 = reinterpret_cast<const uint4*>(a);
  uint4* o4 = reinterpret_cast<uint4*>(out);
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads * kUnroll;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads * kUnroll + threadIdx.x;
       base < n_vec; base += step) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + static_cast<int64_t>(u) * kThreads;
      v[u] = i < n_vec ? a4[i] : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + static_cast<int64_t>(u) * kThreads;
      if (i >= n_vec) break;
      uint4 r;
      r.x = add_word(v[u].x, s_bytes, acc);
      r.y = add_word(v[u].y, s_bytes, acc);
      r.z = add_word(v[u].z, s_bytes, acc);
      r.w = add_word(v[u].w, s_bytes, acc);
      o4[i] = r;
      count += kVecBytes;
    }
  }
  // what the vectors did not cover, byte by byte
  const int64_t threads = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = n_vec * kVecBytes + static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += threads) {
    const int32_t x = a[i];
    acc += static_cast<uint32_t>(x);
    out[i] = static_cast<int8_t>(static_cast<uint8_t>((static_cast<uint32_t>(x) + s_byte) & 0xFFu));
    count += 1;
  }
  acc += count * static_cast<uint32_t>(s);

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xFFFFFFFFu, acc, off);
  __shared__ uint32_t warp_sums[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
    psum[blockIdx.x] = static_cast<int32_t>(total);
  }
}

}  // namespace

// The number of partial sums (= thread blocks) a launch over n elements
// writes; the caller allocates psum with this many int32.
extern "C" int64_t cnnq_stream_copy_blocks(int64_t n) { return blocks_for(n); }

// Returns cudaGetLastError() after the launch, or -1 for arguments the kernel
// does not take; the caller raises on any non-zero code.
extern "C" int cnnq_stream_copy(const void* a, const void* s, void* out, void* psum, int64_t n,
                                void* stream) {
  if (n < 0 || a == nullptr || s == nullptr || out == nullptr || psum == nullptr) return -1;
  const int vec = (reinterpret_cast<uintptr_t>(a) % kVecBytes == 0) &&
                  (reinterpret_cast<uintptr_t>(out) % kVecBytes == 0);
  const dim3 grid(static_cast<unsigned>(blocks_for(n)));
  stream_copy_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int32_t*>(s), static_cast<int8_t*>(out),
      static_cast<int32_t*>(psum), n, vec);
  return static_cast<int>(cudaGetLastError());
}
