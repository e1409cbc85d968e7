// Bitmap popcounts.
//
// popcount_planes replaces the Pallas kernel popcount_planes_pallas /
// _popcount_kernel (src/repro/kernels/popcount/popcount.py:50 and :22), the
// per-plane frontier counter of the density oracle.  The TPU kernel writes
// (B, W/1024) int32 partials that XLA sums; here the planes' totals come out
// directly as (B,) int32, in one launch and with nothing zeroed first.
//
// Bound: bytes.  Every word is read once and B int32 are written; __popc is
// one instruction per word, so the SWAR sequence of the TPU kernel is not
// needed.  At the oracle's shapes (B = 8 planes of 32,768 to 131,072 words,
// 1 to 4 MB) the bound is a fraction of a microsecond, so what counts is the
// fixed cost of the launch and of the cross-block sum.
//
// Design: words are read as 16-byte vectors (four __popc each), neighbouring
// threads on neighbouring vectors, over a grid sized to the card, (slices,
// B); each block sums its share in shared memory.  The cross-block sum is a
// ticket: each block adds (1 << 40) + its count to its plane's 64-bit word
// with one atomicAdd, so the high bits count the blocks done and the low 40
// bits the plane's bits so far.  The block whose add finds slices - 1 blocks
// done is the plane's last; it writes out[p] from the sum and sets the word
// back to 0 for the next call.  One atomic round trip a block, no fence, no
// second pass over partials, and the sum is exact.  The words must be 0 when
// a call starts and no other call may use them until it ends: the wrapper
// keeps one zeroed buffer per (device, stream), so calls on one stream run
// in order and calls on two streams never share it.
// A thread-block cluster per plane (8 or 16 CTAs, the partials summed by
// CTA rank 0 through distributed shared memory after cluster.sync()) was
// measured beside the ticket on an H100: the ticket took 2.46-2.55 us of
// device time at (8, 131,072), 2.01-2.03 us at (8, 32,768) and 1.95-1.97 us
// at (1, 131,072); a cluster of 8 took 4.08-4.14, 3.26-3.28 and 3.90-3.93 us,
// one of 16 4.28-4.30, 3.60-3.61 and 3.54 us.  The cluster's launch and its
// two barriers cost more than one atomic round trip, so only the ticket is
// kept.
// Two routes: the 16-byte loads need w % 4 == 0 and a 16-byte aligned base;
// otherwise the same kernel loads scalar words.
//
// popcount_blocks replaces popcount_blocks_pallas / _popcount_kernel
// (popcount.py:32 and :22): (W,) words -> (ceil(W/1024),) int32 partials, one
// per 1024-word block, the last block zero-padded.  Its caller is the
// density oracle's local_count (one packed frontier plane, the frontier study
// of repro_torch.bench.frontier_stats): at scale 22 that is 131,072 words.
//
// Bound: bytes, every word read once and one int32 written a block: 0.157 us
// at 131,072 words and 2.51 us at 2,097,152 (the scale-26 plane) at 3.35 TB/s.
// At the oracle's shapes the input is one DRAM (or L2) round trip, so the
// time is the launch's fixed cost plus that trip, and what the design can do
// is keep every load of a block in flight at once.
//
// Design: one warp per 1024-word block.  Lane l issues its eight 16-byte
// loads through the read-only path (words 4 l + 128 k, k < 8: each is one
// contiguous 512-byte warp load) before its first __popc, sums with warp
// shuffles, and lane 0 writes the partial: no shared memory, no barrier, no
// atomics.  CTAs of 8 warps over a grid sized to the card (at most
// kBlocksCtasPerSm CTAs a SM) stride over the blocks, so a large input costs
// no more CTAs than the card holds.  A base that is not 16-byte aligned takes
// 32 scalar loads a lane a block, all issued before the first __popc, in the
// same kernel (the kVec = false instance); the ragged last block of either
// instance takes scalar loads bounded by W.
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W limit (profiler device time
// a call, inputs resident in L2; an empty kernel takes 0.88-0.93 us), in two
// runs beside variants since removed, at 1,024 / 131,072 / 2,097,152 words:
// this kernel 1.63-1.65 / 1.74-1.78 / 2.62-2.77 us; with streaming loads
// (ld.global.cs) 1.63-1.65 / 1.79-1.83 / 3.54-3.72; with
// ld.global.nc.L1::no_allocate 1.63-1.64 / 1.80-1.82 / 3.57-3.65; with
// one-warp CTAs 1.47-1.54 / 1.59-1.61 / 3.19-3.25; with eight 16-byte
// cp.async copies a lane into shared memory 1.46 / 1.76-1.79 / 2.77-2.79;
// with one TMA bulk copy of the block a warp 1.54-1.58 / 1.87-1.89 /
// 2.85-2.91; the earlier kernel (a 256-thread CTA a block, four 4-byte loads
// a thread, a shared-memory sum) 1.30-1.33 / 1.41-1.47 / 3.00-3.22.  A warp
// that reads its 4 KB alone waits longer than eight warps reading 512 bytes
// each, so at one and at 128 blocks the earlier layout stays 0.3 us ahead;
// at 2,048 blocks the 16-byte loads win by 0.3-0.5 us.
//
// popcount_words is the elementwise per-word count (the port's counterpart of
// the oracle repro/kernels/popcount/ref.py:popcount_words).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTicketBlocksPerSm = 4;
constexpr int kLoadsPerThread = 2;  // the grid: about this many loads a thread

// The sum of `v` over the block, valid in thread 0.
__device__ __forceinline__ int block_sum(int v) {
  __shared__ int partial[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = rt::warp_sum(v);
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  return warp == 0 ? rt::warp_sum(lane < kThreads / 32 ? partial[lane] : 0) : 0;
}

// Bits set in the 16-byte vectors (kVec) or words i, i + stride, ... of a row
// of w words.
template <bool kVec>
__device__ __forceinline__ int popc_strided(const uint32_t* __restrict__ row, int64_t w,
                                            int64_t i, int64_t stride) {
  int acc = 0;
  if (kVec) {
    const uint4* v = reinterpret_cast<const uint4*>(row);
#pragma unroll 4
    for (const int64_t nv = w >> 2; i < nv; i += stride) {
      const uint4 q = __ldg(v + i);
      acc += __popc(q.x) + __popc(q.y) + __popc(q.z) + __popc(q.w);
    }
  } else {
#pragma unroll 4
    for (; i < w; i += stride) acc += __popc(__ldg(row + i));
  }
  return acc;
}

// acc: (planes,) uint64, 0 between calls: a plane's blocks done so far in the
// bits from kSumBits up, their bit count below.
constexpr int kSumBits = 40;

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    popcount_planes_ticket_kernel(const uint32_t* __restrict__ words, int* __restrict__ out,
                                  unsigned long long* __restrict__ acc, int64_t w) {
  const int64_t plane = blockIdx.y;
  const int sum = block_sum(popc_strided<kVec>(
      words + plane * w, w, static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x,
      static_cast<int64_t>(gridDim.x) * blockDim.x));
  if (threadIdx.x == 0) {
    const unsigned long long mine = (1ull << kSumBits) | static_cast<unsigned>(sum);
    const unsigned long long seen = atomicAdd(acc + plane, mine);
    if ((seen >> kSumBits) == gridDim.x - 1) {  // the ticket of the plane's last block
      out[plane] = static_cast<int>((seen + mine) & ((1ull << kSumBits) - 1));
      acc[plane] = 0;  // every other block of the plane has added: ready for the next call
    }
  }
}

template <bool kVec>
int launch_ticket(const void* words, void* out, void* acc, long long w, int planes,
                  cudaStream_t stream) {
  const long long units = kVec ? w / 4 : w;  // loads a plane
  const long long per_block = static_cast<long long>(kThreads) * kLoadsPerThread;
  const long long by_work = (units + per_block - 1) / per_block;
  const long long by_card = static_cast<long long>(rt::sm_count()) * kTicketBlocksPerSm / planes;
  long long slices = by_work < by_card ? by_work : by_card;
  if (slices < 1) slices = 1;
  popcount_planes_ticket_kernel<kVec>
      <<<dim3(static_cast<unsigned>(slices), static_cast<unsigned>(planes)), kThreads, 0,
         stream>>>(static_cast<const uint32_t*>(words), static_cast<int*>(out),
                   static_cast<unsigned long long*>(acc), w);
  return rt::launch_status();
}

constexpr int kBlockWords = 1024;  // words per partial, as the TPU kernel
constexpr int kBlocksWarps = 8;    // warps (so blocks in flight) a CTA
constexpr int kBlocksCtasPerSm = 4;

// Bits set in the 1024 words of a whole block, lane's share.
template <bool kVec>
__device__ __forceinline__ int popc_block(const uint32_t* __restrict__ block, int lane) {
  int acc = 0;
  if (kVec) {
    const uint4* v = reinterpret_cast<const uint4*>(block) + lane;
    uint4 q[kBlockWords / 128];
#pragma unroll
    for (int k = 0; k < kBlockWords / 128; ++k) q[k] = __ldg(v + 32 * k);
#pragma unroll
    for (int k = 0; k < kBlockWords / 128; ++k)
      acc += __popc(q[k].x) + __popc(q[k].y) + __popc(q[k].z) + __popc(q[k].w);
  } else {
    uint32_t q[kBlockWords / 32];
#pragma unroll
    for (int k = 0; k < kBlockWords / 32; ++k) q[k] = __ldg(block + 32 * k + lane);
#pragma unroll
    for (int k = 0; k < kBlockWords / 32; ++k) acc += __popc(q[k]);
  }
  return acc;
}

template <bool kVec>
__global__ void __launch_bounds__(kBlocksWarps * 32)
    popcount_blocks_kernel(const uint32_t* __restrict__ words, int* __restrict__ out,
                           int64_t w, int64_t blocks) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kBlocksWarps;
  for (int64_t b = static_cast<int64_t>(blockIdx.x) * kBlocksWarps + (threadIdx.x >> 5);
       b < blocks; b += stride) {  // warp-uniform: every lane of a warp takes one block
    const int64_t first = b * kBlockWords;
    int acc = 0;
    if (first + kBlockWords <= w) {
      acc = popc_block<kVec>(words + first, lane);
    } else {  // the ragged last block
      for (int64_t i = first + lane; i < w; i += 32) acc += __popc(__ldg(words + i));
    }
    acc = rt::warp_sum(acc);
    if (lane == 0) out[b] = acc;
  }
}

__global__ void popcount_words_kernel(const uint32_t* __restrict__ words,
                                      int* __restrict__ out, int64_t n) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x)
    out[i] = __popc(__ldg(words + i));
}

}  // namespace

// words: (planes, w) uint32; out: (planes,) int32, every entry written; acc:
// (>= planes) uint64 that are 0 (and are left 0).  vec: w % 4 == 0 and words
// 16-byte aligned.
RT_API int rt_popcount_planes(const void* words, void* out, void* acc, long long w, int planes,
                              int vec, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return vec ? launch_ticket<true>(words, out, acc, w, planes, s)
             : launch_ticket<false>(words, out, acc, w, planes, s);
}

// words: (w,) uint32, w > 0; out: (ceil(w / 1024),) int32.  vec: words is
// 16-byte aligned.
RT_API int rt_popcount_blocks(const void* words, void* out, long long w, int vec,
                              void* stream) {
  const long long blocks = (w + kBlockWords - 1) / kBlockWords;
  const long long by_work = (blocks + kBlocksWarps - 1) / kBlocksWarps;
  const long long by_card = static_cast<long long>(rt::sm_count()) * kBlocksCtasPerSm;
  const unsigned ctas = static_cast<unsigned>(by_work < by_card ? by_work : by_card);
  auto s = static_cast<cudaStream_t>(stream);
  auto in = static_cast<const uint32_t*>(words);
  if (vec)
    popcount_blocks_kernel<true><<<ctas, kBlocksWarps * 32, 0, s>>>(in, static_cast<int*>(out),
                                                                    w, blocks);
  else
    popcount_blocks_kernel<false><<<ctas, kBlocksWarps * 32, 0, s>>>(in, static_cast<int*>(out),
                                                                     w, blocks);
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
