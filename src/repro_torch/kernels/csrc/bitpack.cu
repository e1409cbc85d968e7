// Vertical bit packing and unpacking over 1024-value chunks.
//
// pack replaces the Pallas kernel pack_pallas / _pack_kernel
// (src/repro/kernels/bitpack/bitpack.py:50 and :28); unpack replaces
// unpack_pallas / _unpack_kernel (bitpack.py:72 and :39).  In each chunk, word j
// (0 <= j < 32b) holds chunk[k*32b + j] at bit k*b for k < 32/b; at b = 1,
// value i of a chunk sits in word i % 32, bit i / 32.
//
// Bound: bytes.  Each value is read once (1 byte for bool/uint8 membership
// planes, 4 for uint32 values) and each word written once; the arithmetic is
// one shift and one OR per value.
//
// Design: one thread per output word, looping over its 32/b values at stride
// 32b.  Neighbouring threads own neighbouring j, so each step of the loop is
// one contiguous run of loads per warp.  The (B, n) planes are read in place
// with positions >= n masked here, so no padded uint32 copy of the membership
// planes (repro/core/expand.py:72-76) is materialized.  The TPU's 4096-value
// grid step is not kept: a block is 256 words of one plane, the plane is
// blockIdx.y.
//
// unpack is the inverse, bound by bytes as well: each word is read once and
// its 32/b values written once (1 byte each for b = 1 membership planes, 4
// bytes otherwise).  One thread per packed word: thread j of a chunk loads its
// word once and writes value k*32b + j for k < 32/b, so for a fixed k
// neighbouring threads store neighbouring values and both the loads and the
// stores coalesce.  b = 1 writes uint8 (read as bool) so that a received
// bitmap needs no cast pass; the TPU's (32, 128) output tile is not kept.
#include "common.cuh"

namespace {

template <typename T>
__global__ void pack_kernel(const T* __restrict__ values, uint32_t* __restrict__ out,
                            int64_t n, int64_t words_per_plane, int b) {
  const int64_t w = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (w >= words_per_plane) return;
  const int64_t plane = blockIdx.y;
  const int wc = 32 * b;
  const int64_t first = (w / wc) * rt::kChunk + (w % wc);
  const T* v = values + plane * n;
  uint32_t word = 0;
  for (int k = 0; k < 32 / b; ++k) {
    const int64_t i = first + static_cast<int64_t>(k) * wc;
    if (i < n) word |= static_cast<uint32_t>(v[i]) << (k * b);
  }
  out[plane * words_per_plane + w] = word;
}

template <typename T>
int launch_pack(const void* values, void* out, long long n, long long words_per_plane,
                int planes, int b, void* stream) {
  constexpr int kThreads = 256;
  const dim3 grid(static_cast<unsigned>((words_per_plane + kThreads - 1) / kThreads),
                  static_cast<unsigned>(planes));
  pack_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(values), static_cast<uint32_t*>(out), n, words_per_plane, b);
  return rt::launch_status();
}

template <typename T>
__global__ void unpack_kernel(const uint32_t* __restrict__ words, T* __restrict__ out,
                              int64_t words_per_plane, int b) {
  const int64_t w = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (w >= words_per_plane) return;
  const int64_t plane = blockIdx.y;
  const int wc = 32 * b;
  const int64_t first = (w / wc) * rt::kChunk + (w % wc);
  const uint32_t word = __ldg(words + plane * words_per_plane + w);
  const uint32_t mask = (1u << b) - 1u;  // b < 32: width 32 never launches
  T* o = out + plane * (words_per_plane * (32 / b));
  for (int k = 0; k < 32 / b; ++k)
    o[first + static_cast<int64_t>(k) * wc] = static_cast<T>((word >> (k * b)) & mask);
}

template <typename T>
int launch_unpack(const void* words, void* out, long long words_per_plane, int planes, int b,
                  void* stream) {
  constexpr int kThreads = 256;
  const dim3 grid(static_cast<unsigned>((words_per_plane + kThreads - 1) / kThreads),
                  static_cast<unsigned>(planes));
  unpack_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<T*>(out), words_per_plane, b);
  return rt::launch_status();
}

}  // namespace

// values: (planes, n) uint8/bool; out: (planes, words_per_plane) uint32.
RT_API int rt_pack_u8(const void* values, void* out, long long n, long long words_per_plane,
                      int planes, int b, void* stream) {
  return launch_pack<uint8_t>(values, out, n, words_per_plane, planes, b, stream);
}

// values: (planes, n) uint32 (int32 bit patterns); out as above.
RT_API int rt_pack_u32(const void* values, void* out, long long n, long long words_per_plane,
                       int planes, int b, void* stream) {
  return launch_pack<uint32_t>(values, out, n, words_per_plane, planes, b, stream);
}

// words: (planes, words_per_plane) uint32, b = 1; out: (planes, 32 * words_per_plane)
// uint8 (0/1, a bool tensor).
RT_API int rt_unpack_u8(const void* words, void* out, long long words_per_plane, int planes,
                        int b, void* stream) {
  return launch_unpack<uint8_t>(words, out, words_per_plane, planes, b, stream);
}

// words as above, b in {2, 4, 8, 16}; out: (planes, words_per_plane * 32 / b) int32.
RT_API int rt_unpack_u32(const void* words, void* out, long long words_per_plane, int planes,
                         int b, void* stream) {
  return launch_unpack<uint32_t>(words, out, words_per_plane, planes, b, stream);
}
