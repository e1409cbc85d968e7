// Shared helpers of the repro_torch CUDA kernels (plain C interface, sm_90a).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define RT_API extern "C" __attribute__((visibility("default")))

namespace rt {

constexpr int kInf = 0x7fffffff;  // int32 max: "no candidate"
constexpr int kChunk = 1024;      // values per vertical packing chunk

// Bit `i` of a vertical width-1 bitmap.  Value i of its 1024-value chunk
// sits in word i % 32 of the chunk's 32 words, at bit (i % 1024) / 32 -- not
// LSB-first (repro/kernels/spmv/ref.py:frontier_bit).  Loads go through the
// read-only path: the bitmaps are small enough to stay in the 50 MB L2.
__device__ __forceinline__ uint32_t bitmap_bit(const uint32_t* __restrict__ words,
                                               int64_t i) {
  const int64_t within = i & (kChunk - 1);
  return (__ldg(words + ((i >> 10) << 5) + (within & 31)) >> (within >> 5)) & 1u;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// The card's SM count (the device current at first call), for grids sized
// to the card rather than to the work; 0 if the query failed, which makes
// the launch fail and report it.
inline int sm_count() {
  static const int count = [] {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms;
  }();
  return count;
}

// Every C entry point returns this right after its launch: a launch that
// was refused never runs, and a later synchronize would not report it.
inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

}  // namespace rt
