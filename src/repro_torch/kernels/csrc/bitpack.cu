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
// a few instructions per value, far below the card's integer rate.
//
// pack, b = 1 over bytes (the membership planes: the main path's (8, n) bool
// frontiers).  One warp takes one 1024-value chunk at a time, walking the
// (plane, chunk) pairs in a grid-stride loop over a grid sized to the card.
// Lane L loads bytes 16L..16L+15 and 512+16L..512+16L+15 of the chunk as two
// 16-byte streaming loads (__ldcs: every byte is read once), neighbouring
// lanes on neighbouring addresses, so a chunk is two load instructions of
// 512 bytes each.  The index map: value i = 16L + t (first vector) is row
// k = i / 32 = L / 2, column j = i % 32 = 16(L & 1) + t, and the second
// vector holds rows 16 + L/2 of the same columns.  Word j of the chunk is
// column j read down the 32 rows, so the warp transposes a 32 x 32 bit
// matrix whose rows are spread over lane pairs.  Each lane squeezes its
// vectors to 16 bits each, one __shfl_xor_sync(1) makes lane 2m hold row m
// and lane 2m + 1 row 16 + m, a five-stage __shfl_xor_sync transpose gives
// lane j column j with bit l = row r(l), and a perfect unshuffle puts row k
// at bit k.  One __ballot_sync per byte position was measured beside it on
// an H100: at (8, 4,194,304) the shuffle took 13.1-13.3 us of device time
// and the ballot 15.1-15.9 us (32 votes and 32 selects a lane against some 60
// ALU operations and 6 shuffles), against a bound of 11.27 us, so only the
// shuffle is kept.  Lane j then holds word j, and the warp stores the chunk's
// 32 words as one 128-byte store, an ordinary one: the oracle's popcount and
// the ELL mask read them next, from L2.  A byte that is not 0 packs as 1, on
// both routes and in the plain version alike (bool, and every uint8 caller,
// passes 0/1).
//
// pack over int32 values (the id streams of comm/formats.py at b in {1, 2,
// 4, 8, 16}): one thread builds 4 consecutive words j..j+3 of a chunk from
// 32/b 16-byte loads of values k*32b + j..j+3, ORs them in at bit k*b and
// writes one 16-byte store; b is a template argument, so the loop unrolls
// and all 32/b loads are in flight together.  Values are ORed in unmasked,
// as the plain version does.  b = 32 is the identity and launches nothing.
//
// Both packs have two routes, chosen by the wrapper: the 16-byte loads need
// every plane to start 16-byte aligned (n % 16 == 0 for bytes, n % 4 == 0
// for int32, and an aligned base pointer); otherwise the same kernel loads
// scalars (bytes: lane j reads values k*32 + j, one coalesced byte a lane,
// and needs no transpose).  Positions >= n read as zero in both, so the
// (B, n) planes are read in place and no padded copy
// (repro/core/expand.py:72-76) is materialized.
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

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // 2048 resident threads an SM at 256 a block

// Grid of a grid-stride loop over `threads` threads' worth of items: enough
// to cover them, at most one full residency of the card.
unsigned stride_grid(long long threads) {
  const long long need = (threads + kThreads - 1) / kThreads;
  const long long card = static_cast<long long>(rt::sm_count()) * kBlocksPerSm;
  return static_cast<unsigned>(need < card ? need : card);
}

// Even bits to the low half (bit 2k -> k), odd bits to the high half
// (2k + 1 -> 16 + k): the inverse perfect shuffle (Hacker's Delight 7-2).
__device__ __forceinline__ uint32_t unshuffle(uint32_t x) {
  uint32_t t;
  t = (x ^ (x >> 1)) & 0x22222222u; x ^= t ^ (t << 1);
  t = (x ^ (x >> 2)) & 0x0C0C0C0Cu; x ^= t ^ (t << 2);
  t = (x ^ (x >> 4)) & 0x00F000F0u; x ^= t ^ (t << 4);
  t = (x ^ (x >> 8)) & 0x0000FF00u; x ^= t ^ (t << 8);
  return x;
}

// Bit e of the result is 1 where byte e of `w` is not 0 (e < 4): the high
// bit of each byte flags a nonzero byte, and one multiply gathers bits 7,
// 15, 23, 31 into bits 28..31 with no carries.
__device__ __forceinline__ uint32_t nonzero_nibble(uint32_t w) {
  const uint32_t t = (((w & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | w) & 0x80808080u;
  return (t * 0x00204081u) >> 28;
}

__device__ __forceinline__ uint32_t nonzero_bits16(const uint4& v) {
  return nonzero_nibble(v.x) | nonzero_nibble(v.y) << 4 | nonzero_nibble(v.z) << 8 |
         nonzero_nibble(v.w) << 12;
}

// Lane L holds bytes 16L.. (lo) and 512 + 16L.. (hi) of a chunk; returns
// word L of the chunk.  See the head note for the index map.
__device__ __forceinline__ uint32_t transpose_shuffle(const uint4& lo, const uint4& hi,
                                                      int lane) {
  const uint32_t h0 = nonzero_bits16(lo), h1 = nonzero_bits16(hi);
  // even lane 2m: h0, h1 = columns 0..15 of rows m, 16 + m; odd: columns 16..31
  const bool odd = lane & 1;
  const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? h0 : h1, 1);
  uint32_t x = odd ? (got | (h1 << 16)) : (h0 | (got << 16));  // row m or 16 + m
  const uint32_t masks[5] = {0x0000FFFFu, 0x00FF00FFu, 0x0F0F0F0Fu, 0x33333333u,
                             0x55555555u};
#pragma unroll
  for (int stage = 0; stage < 5; ++stage) {
    const int s = 16 >> stage;
    const uint32_t m = masks[stage];
    const uint32_t y = __shfl_xor_sync(0xffffffffu, x, s);
    x = (lane & s) ? ((x & ~m) | ((y >> s) & m)) : ((x & m) | ((y & m) << s));
  }
  return unshuffle(x);  // bit 2m = row m, bit 2m + 1 = row 16 + m -> bit k = row k
}

__device__ __forceinline__ uint4 load16_or_zero(const uint8_t* p, int64_t i, int64_t n) {
  return i < n ? __ldcs(reinterpret_cast<const uint4*>(p + i)) : make_uint4(0, 0, 0, 0);
}

// b = 1 over bytes: one warp per (plane, chunk) item, see the head note.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    pack_bytes_kernel(const uint8_t* __restrict__ values, uint32_t* __restrict__ out,
                      int64_t n, int64_t chunks, int64_t items) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t item = (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5;
       item < items; item += warps) {  // warp-uniform: the votes see all 32 lanes
    const int64_t plane = item / chunks;
    const int64_t first = (item - plane * chunks) * rt::kChunk;
    const uint8_t* v = values + plane * n;
    uint32_t word = 0;
    if (kVec) {
      const uint4 lo = load16_or_zero(v, first + 16 * lane, n);
      const uint4 hi = load16_or_zero(v, first + 512 + 16 * lane, n);
      word = transpose_shuffle(lo, hi, lane);
    } else {
#pragma unroll 8
      for (int k = 0; k < 32; ++k) {
        const int64_t i = first + 32 * k + lane;
        if (i < n && __ldcs(v + i)) word |= 1u << k;
      }
    }
    out[item * 32 + lane] = word;  // plane * chunks * 32 + chunk * 32 + lane
  }
}

template <bool kVec>
__device__ __forceinline__ uint4 load4_or_zero(const uint32_t* p, int64_t i, int64_t n) {
  if (kVec)
    return i < n ? __ldcs(reinterpret_cast<const uint4*>(p + i)) : make_uint4(0, 0, 0, 0);
  return make_uint4(i < n ? __ldcs(p + i) : 0u, i + 1 < n ? __ldcs(p + i + 1) : 0u,
                    i + 2 < n ? __ldcs(p + i + 2) : 0u, i + 3 < n ? __ldcs(p + i + 3) : 0u);
}

// uint32 values at width B: one thread per 4 consecutive words of a chunk.
template <int B, bool kVec>
__global__ void __launch_bounds__(kThreads)
    pack_words_kernel(const uint32_t* __restrict__ values, uint32_t* __restrict__ out,
                      int64_t n, int64_t quads_per_plane, int64_t items) {
  constexpr int kWc = 32 * B;  // words per chunk
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t item = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       item < items; item += stride) {
    const int64_t plane = item / quads_per_plane;
    const int64_t w = 4 * (item - plane * quads_per_plane);  // word within the plane
    const int64_t first = (w / kWc) * rt::kChunk + (w % kWc);
    const uint32_t* v = values + plane * n;
    uint4 acc = make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int k = 0; k < 32 / B; ++k) {
      const uint4 x = load4_or_zero<kVec>(v, first + k * kWc, n);
      acc.x |= x.x << (k * B);
      acc.y |= x.y << (k * B);
      acc.z |= x.z << (k * B);
      acc.w |= x.w << (k * B);
    }
    *reinterpret_cast<uint4*>(out + 4 * item) = acc;  // plane * 4 * quads + w
  }
}

template <bool kVec>
int launch_pack_bytes(const void* values, void* out, long long n, long long chunks,
                      int planes, cudaStream_t stream) {
  const long long items = chunks * planes;
  pack_bytes_kernel<kVec><<<stride_grid(items * 32), kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(values), static_cast<uint32_t*>(out), n, chunks, items);
  return rt::launch_status();
}

template <int B>
int launch_pack_words(const void* values, void* out, long long n, long long words_per_plane,
                      int planes, int vec, cudaStream_t stream) {
  const long long quads = words_per_plane / 4;  // 32b words a chunk: a multiple of 4
  const long long items = quads * planes;
  const unsigned grid = stride_grid(items);
  const auto* v = static_cast<const uint32_t*>(values);
  auto* o = static_cast<uint32_t*>(out);
  if (vec)
    pack_words_kernel<B, true><<<grid, kThreads, 0, stream>>>(v, o, n, quads, items);
  else
    pack_words_kernel<B, false><<<grid, kThreads, 0, stream>>>(v, o, n, quads, items);
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
  const dim3 grid(static_cast<unsigned>((words_per_plane + kThreads - 1) / kThreads),
                  static_cast<unsigned>(planes));
  unpack_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<T*>(out), words_per_plane, b);
  return rt::launch_status();
}

}  // namespace

// values: (planes, n) uint8/bool, b = 1; out: (planes, words_per_plane) uint32,
// words_per_plane = 32 * chunks.  vec: every plane starts 16-byte aligned.
RT_API int rt_pack_u8(const void* values, void* out, long long n, long long words_per_plane,
                      int planes, int vec, void* stream) {
  const long long chunks = words_per_plane / 32;
  auto s = static_cast<cudaStream_t>(stream);
  return vec ? launch_pack_bytes<true>(values, out, n, chunks, planes, s)
             : launch_pack_bytes<false>(values, out, n, chunks, planes, s);
}

// values: (planes, n) uint32 (int32 bit patterns), b in {1, 2, 4, 8, 16}; out as
// above.  vec: every plane starts 16-byte aligned.
RT_API int rt_pack_u32(const void* values, void* out, long long n, long long words_per_plane,
                       int planes, int b, int vec, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (b) {
    case 1: return launch_pack_words<1>(values, out, n, words_per_plane, planes, vec, s);
    case 2: return launch_pack_words<2>(values, out, n, words_per_plane, planes, vec, s);
    case 4: return launch_pack_words<4>(values, out, n, words_per_plane, planes, vec, s);
    case 8: return launch_pack_words<8>(values, out, n, words_per_plane, planes, vec, s);
    case 16: return launch_pack_words<16>(values, out, n, words_per_plane, planes, vec, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
