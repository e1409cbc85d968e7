// Bitmap popcounts.
//
// popcount_planes replaces the Pallas kernel popcount_planes_pallas /
// _popcount_kernel (src/repro/kernels/popcount/popcount.py:50 and :22), the
// per-plane frontier counter of the density oracle.  The TPU kernel writes
// (B, W/1024) int32 partials that XLA sums; here the planes' totals come out
// directly as (B,) int32.
//
// Bound: bytes.  Every word is read once and B int32 are written; __popc is
// one instruction per word, so the SWAR sequence of the TPU kernel is not
// needed.
//
// Design: each thread sums __popc over a grid-strided run of its plane
// (blockIdx.y), warp shuffles and one shared-memory pass reduce the block,
// and one integer atomicAdd per block adds it to the plane's total -- exact,
// whatever the order.  The x-grid is sized so about four blocks per SM are in
// flight over all planes together, so a small B still fills the card.
//
// popcount_blocks replaces popcount_blocks_pallas / _popcount_kernel
// (popcount.py:32 and :22): (W,) words -> (ceil(W/1024),) int32 partials, one
// per 1024-word block, the last block zero-padded.  Same bound: every word
// read once, one int32 written per block.  One thread block per 1024-word
// block: each of its 256 threads sums four words with a stride of 256 (so a
// warp's loads are contiguous), and warp shuffles plus one shared-memory pass
// reduce them to the block's partial, written by one thread -- no atomics.
//
// popcount_words is the elementwise per-word count (the port's counterpart of
// the oracle repro/kernels/popcount/ref.py:popcount_words).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void popcount_planes_kernel(const uint32_t* __restrict__ words,
                                       int* __restrict__ out, int64_t w) {
  const uint32_t* row = words + static_cast<int64_t>(blockIdx.y) * w;
  int acc = 0;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < w;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x)
    acc += __popc(__ldg(row + i));
  acc = rt::warp_sum(acc);
  __shared__ int partial[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) partial[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = rt::warp_sum(lane < kThreads / 32 ? partial[lane] : 0);
    if (lane == 0 && acc) atomicAdd(out + blockIdx.y, acc);
  }
}

constexpr int kBlockWords = 1024;  // words per partial, as the TPU kernel

__global__ void popcount_blocks_kernel(const uint32_t* __restrict__ words,
                                       int* __restrict__ out, int64_t w) {
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kBlockWords;
  int acc = 0;
#pragma unroll
  for (int k = 0; k < kBlockWords / kThreads; ++k) {
    const int64_t i = first + k * kThreads + threadIdx.x;
    if (i < w) acc += __popc(__ldg(words + i));
  }
  acc = rt::warp_sum(acc);
  __shared__ int partial[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) partial[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = rt::warp_sum(lane < kThreads / 32 ? partial[lane] : 0);
    if (lane == 0) out[blockIdx.x] = acc;
  }
}

__global__ void popcount_words_kernel(const uint32_t* __restrict__ words,
                                      int* __restrict__ out, int64_t n) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x)
    out[i] = __popc(__ldg(words + i));
}

}  // namespace

// words: (planes, w) uint32; out: (planes,) int32, zeroed by the caller.
RT_API int rt_popcount_planes(const void* words, void* out, long long w, int planes,
                              void* stream) {
  constexpr long long kTargetBlocks = 132 * 4;  // ~4 resident blocks per H100 SM
  const long long by_work = (w + kThreads * 4 - 1) / (kThreads * 4);
  const long long by_card = (kTargetBlocks + planes - 1) / planes;
  const long long bx = by_work < by_card ? by_work : by_card;
  const dim3 grid(static_cast<unsigned>(bx > 0 ? bx : 1), static_cast<unsigned>(planes));
  popcount_planes_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<int*>(out), w);
  return rt::launch_status();
}

// words: (w,) uint32; out: (ceil(w / 1024),) int32.
RT_API int rt_popcount_blocks(const void* words, void* out, long long w, void* stream) {
  const long long blocks = (w + kBlockWords - 1) / kBlockWords;
  popcount_blocks_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<int*>(out), w);
  return rt::launch_status();
}

// words: (n,) uint32; out: (n,) int32.
RT_API int rt_popcount_words(const void* words, void* out, long long n, void* stream) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  popcount_words_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<int*>(out), n);
  return rt::launch_status();
}
