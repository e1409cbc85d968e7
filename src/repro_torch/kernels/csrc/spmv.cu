// ELL frontier expansion, push and pull, over B frontier planes, and the
// plane-interleaved frontier mask both ELL kernels probe.
//
// Replaces the Pallas kernels spmv_min_planes_pallas / _spmv_planes_kernel
// (src/repro/kernels/spmv/spmv.py:171 and :59) and
// spmv_pull_min_planes_pallas / _pull_planes_kernel
// (src/repro/kernels/spmv/pull.py:89 and :60), and their single-plane forms
// spmv_min_pallas (spmv.py:203) and spmv_pull_min_pallas (pull.py:122), which
// the wrappers launch as the same kernel with planes = 1:
//
//   out[p, r] = min { c = nbr[r, d] : c < n_cols and bit c of frontier p }
//
// or INF when no slot hits.  Pull also masks row r to INF when its bit in
// plane p's unreached bitmap is clear.  Pad slots hold a sentinel >= the real
// column count, whose bit is never set.  Slab entries are in [0, n_cols].
//
// Bound: bytes.  The slab is read once (R*K*4 bytes; in pull only the rows
// still unreached in some plane), each plane's frontier bitmap once
// (n_cols/8 bytes), the unreached bitmaps once, and the (B, R) int32 output
// written once.  The work is a handful of integer operations per slot.  At
// scale 22 the slab and the output are 134 MB each and the bitmaps 4 MB, so
// the card's floor is the slab stream plus the output stream.
//
// What held the first one-thread-per-row design at 2.8x that floor: each
// real slot probed bit c of every plane, up to B = 8 words lying n_cols/32
// words apart (8 L2 sectors for 8 bits).  In stages at the densest level of a
// scale-22 batch (B = 8; throw-away stage builds, PERF.md): slab loads and
// output stores 93 us, the probes +129 us.
//
// Design.  (1) frontier_mask_kernel transposes the packed (B, n_cols/32)
// words into a (ceil(B/8), n_cols) byte mask, bit q of byte [g, c] = plane
// 8g + q's bit c: one byte per column holds all 8 planes of a pass, 4 MB at
// scale 22 and B = 8, which stays in L2.  The bitmaps are in the vertical
// layout (value i of a 1024-value chunk in word i % 32, bit (i % 1024) / 32),
// so one source word holds 32 columns lying 32 apart.  One warp takes a
// chunk of a group of 8 planes (more groups on blockIdx.y, planes past B
// read as clear): lane w loads word w of each of the 8 planes, 8 coalesced
// 128-byte loads a warp, and holds columns w + 32 b at bit b.  Its 32 mask
// bytes are four 8 x 8 bit transposes: eight byte permutes gather byte j of
// the 8 words into one 64-bit value (row q = plane q), and three delta swaps
// transpose it, so byte i is the mask byte of column w + 32 (8j + i).  That
// is ~3 instructions a column where a bit-at-a-time gather took ~40 (8
// shared loads, shifts, ands and ors a byte): that first design issued
// ~5.3 M warp instructions at (8, 4,194,304), about 5.5 us across 132 SMs,
// for 8.4 MB (2.50 us) of bytes, and took 7.11 us of device time.  The
// lane writes its bytes to the warp's 1 KB of shared memory at their
// column's offset (bytes of one word from different lanes do not
// conflict), and the warp writes the chunk as two 16-byte stores a lane.
// It takes 3.22 us of device time at (8, 4,194,304), 78% of its bound
// (chip_smoke.py on an H100 80GB HBM3 at 700 W, PERF.md).  (2) One thread
// per row loads its slots 4 at a time, as one 16-byte evict-first vector
// when K % 4 == 0 and the slab is 16-byte aligned, as scalars otherwise
// (kVec); the state fits 38
// registers at B > 1 with vector loads (ptxas -v), 48 of an SM's 64 warp
// slots.  A sentinel slot is dropped by one compare; a real slot costs one
// mask byte ANDed with the live planes (every plane of the pass in push; in
// pull, those where the row is unreached), and a zero byte skips it.  The per-plane mins stay in
// registers; the (B, R) output is written coalesced per plane with
// evict-first stores.  Passes of 8 planes (one mask byte) re-read the slab
// for B > 8.  There is no early exit.  The per-plane check c < best[q] can
// skip a slot's byte load only when it fails for every live plane, that is
// when c >= the live planes' largest min; past that it only drops min
// updates that change nothing.  That check measured slower (ELL 160 against
// 136 us at the densest level, a throw-away variant, PERF.md): with one byte
// per slot for all planes a slot costs too little to skip.  (3) At B = 1 the mask
// would be 8x the bitmap and cost a launch for one bit per column, while the
// bitmap probe is one word from a 512 KB array: the wrappers pass no mask
// there and the kernel probes the bitmap (kMask = false; 70 us against 99
// us plus the mask's 7 us at scale 22).  No ROW_TILE / DEG_CHUNK padding is
// needed: the grid masks its ragged edge.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;      // rows per block of the ELL kernels
constexpr int kTileThreads = 256;  // the interleave kernel's block
constexpr int kInterleaveCols = 4;  // columns a thread of the interleave kernel (one int4)
constexpr int kPlanesPerPass = 8;  // the bits of one mask byte
constexpr int kMaskWarps = 8;      // 1024-column chunks per mask block, one a warp
static_assert(kInterleaveCols == 4, "the interleave kernel loads a plane's columns as one int4");
constexpr int kEllSlots = 4;       // slab slots per step (one int4)
constexpr int kGatherSlots = 8;    // in the value gather (two int4)

// Bytes j of a0..a3 -> b[j] (byte q of b[j] is byte j of a_q): a 4 x 4
// byte transpose in eight byte permutes.
__device__ __forceinline__ void transpose_bytes(uint32_t a0, uint32_t a1, uint32_t a2,
                                                uint32_t a3, uint32_t (&b)[4]) {
  const uint32_t t0 = __byte_perm(a0, a1, 0x5140), t1 = __byte_perm(a0, a1, 0x7362);
  const uint32_t t2 = __byte_perm(a2, a3, 0x5140), t3 = __byte_perm(a2, a3, 0x7362);
  b[0] = __byte_perm(t0, t2, 0x5410);
  b[1] = __byte_perm(t0, t2, 0x7632);
  b[2] = __byte_perm(t1, t3, 0x5410);
  b[3] = __byte_perm(t1, t3, 0x7632);
}

// Transpose of the 8 x 8 bit matrix whose row r is byte r of (hi:lo), column
// c its bit c: three delta swaps (Hacker's Delight 7-3) on the two halves;
// the first two stay within a half, the third crosses them.
__device__ __forceinline__ void transpose_bits8(uint32_t& lo, uint32_t& hi) {
  uint32_t t;
  t = (lo ^ (lo >> 7)) & 0x00AA00AAu; lo ^= t ^ (t << 7);
  t = (hi ^ (hi >> 7)) & 0x00AA00AAu; hi ^= t ^ (t << 7);
  t = (lo ^ (lo >> 14)) & 0x0000CCCCu; lo ^= t ^ (t << 14);
  t = (hi ^ (hi >> 14)) & 0x0000CCCCu; hi ^= t ^ (t << 14);
  t = (lo ^ (hi << 4)) & 0xF0F0F0F0u; lo ^= t; hi ^= t >> 4;
}

// f: (planes, wf) vertical words, wf = n_cols / 32; mask: (groups, n_cols)
// bytes.  Warp w of block (x, g) takes chunk kMaskWarps x + w of group g;
// see the head note.
__global__ void __launch_bounds__(kMaskWarps * 32)
    frontier_mask_kernel(const uint32_t* __restrict__ f, uint8_t* __restrict__ mask,
                         int planes, int64_t wf, int64_t n_cols) {
  __shared__ __align__(16) uint8_t stage[kMaskWarps][rt::kChunk];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t chunk = static_cast<int64_t>(blockIdx.x) * kMaskWarps + warp;
  if (chunk >= n_cols / rt::kChunk) return;  // warp-uniform
  const int g = blockIdx.y;
  uint32_t w[kPlanesPerPass];  // lane: columns lane + 32 b of the chunk at bit b
#pragma unroll
  for (int q = 0; q < kPlanesPerPass; ++q) {
    const int p = g * kPlanesPerPass + q;
    w[q] = p < planes ? __ldg(f + p * wf + chunk * 32 + lane) : 0u;
  }
  uint32_t lo[4], hi[4];  // [j]: byte j of every plane, planes 0-3 / 4-7
  transpose_bytes(w[0], w[1], w[2], w[3], lo);
  transpose_bytes(w[4], w[5], w[6], w[7], hi);
  uint8_t* s = stage[warp];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    transpose_bits8(lo[j], hi[j]);  // byte i: the mask byte of column lane + 32 (8j + i)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[(8 * j + i) * 32 + lane] = static_cast<uint8_t>(lo[j] >> (8 * i));
      s[(8 * j + 4 + i) * 32 + lane] = static_cast<uint8_t>(hi[j] >> (8 * i));
    }
  }
  __syncwarp();
  uint4* dst = reinterpret_cast<uint4*>(mask + g * n_cols + chunk * rt::kChunk);
  const uint4* src = reinterpret_cast<const uint4*>(s);
  dst[lane] = src[lane];
  dst[32 + lane] = src[32 + lane];
}

// Slots d .. d + kN - 1 of a row; -1 (dropped by the unsigned column
// compare) past its end.  The slab is read once: evict-first loads keep it
// from pushing the mask (and the values) out of L2.
template <int kN, bool kVec>
__device__ __forceinline__ void load_slots(const int* __restrict__ row, int d, int k,
                                           int (&c)[kN]) {
  if (kVec) {
#pragma unroll
    for (int v = 0; v < kN; v += 4) {
      if (v == 0 || d + v < k) {
        const int4 a = __ldcs(reinterpret_cast<const int4*>(row + d + v));
        c[v] = a.x; c[v + 1] = a.y; c[v + 2] = a.z; c[v + 3] = a.w;
      } else {
        c[v] = c[v + 1] = c[v + 2] = c[v + 3] = -1;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kN; ++j) c[j] = d + j < k ? __ldcs(row + d + j) : -1;
  }
}

// The planes of this pass whose frontier holds column c: the mask byte, or
// (one plane, no mask) the bitmap bit.
template <bool kMask>
__device__ __forceinline__ uint32_t slot_planes(const uint8_t* __restrict__ mask,
                                                const uint32_t* __restrict__ f, int c) {
  if (kMask) return __ldg(mask + c);
  return rt::bitmap_bit(f, c);
}

// Bit q: plane p0 + q reads this row (every plane of the pass in push; in
// pull, those where the row is unreached).
__device__ __forceinline__ uint32_t live_planes(const uint32_t* __restrict__ u, int64_t wu,
                                                int p0, int np, int r) {
  uint32_t live = 0;
#pragma unroll
  for (int q = 0; q < kPlanesPerPass; ++q)
    if (q < np && (u == nullptr || rt::bitmap_bit(u + (p0 + q) * wu, r))) live |= 1u << q;
  return live;
}

template <bool kVec, bool kMask>
__global__ void __launch_bounds__(kThreads)
    ell_min_planes_kernel(const int* __restrict__ nbr, const uint8_t* __restrict__ mask,
                          const uint32_t* __restrict__ f, const uint32_t* __restrict__ u,
                          int* __restrict__ out, int n_rows, int k, int n_cols, int planes,
                          int64_t wu) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  const int* row = nbr + static_cast<int64_t>(r) * k;
  for (int p0 = 0; p0 < planes; p0 += kPlanesPerPass) {
    const int np = min(kPlanesPerPass, planes - p0);
    const uint8_t* m = mask + static_cast<int64_t>(p0 / kPlanesPerPass) * n_cols;
    const uint32_t live = live_planes(u, wu, p0, np, r);
    int best[kPlanesPerPass];
#pragma unroll
    for (int q = 0; q < kPlanesPerPass; ++q) best[q] = rt::kInf;
    for (int d = 0; live != 0 && d < k; d += kEllSlots) {
      int c[kEllSlots];
      load_slots<kEllSlots, kVec>(row, d, k, c);
      // every probe of the step in flight at once
      uint32_t hit[kEllSlots];
#pragma unroll
      for (int j = 0; j < kEllSlots; ++j)
        hit[j] = static_cast<unsigned>(c[j]) < static_cast<unsigned>(n_cols)
                     ? slot_planes<kMask>(m, f, c[j]) & live
                     : 0u;
#pragma unroll
      for (int j = 0; j < kEllSlots; ++j) {
        if (hit[j] == 0) continue;
#pragma unroll
        for (int q = 0; q < kPlanesPerPass; ++q)
          if ((hit[j] >> q) & 1u) best[q] = min(best[q], c[j]);
      }
    }
#pragma unroll
    for (int q = 0; q < kPlanesPerPass; ++q)
      if (q < np) __stcs(out + static_cast<int64_t>(p0 + q) * n_rows + r, best[q]);
  }
}

struct EllArgs {
  const int* nbr;
  const uint8_t* mask;
  const uint32_t* f;
  const uint32_t* u;
  int* out;
  int n_rows, k, n_cols, planes;
  int64_t wu;
};

template <bool kVec, bool kMask>
void launch_ell(const EllArgs& a, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>((a.n_rows + kThreads - 1) / kThreads);
  ell_min_planes_kernel<kVec, kMask><<<blocks, kThreads, 0, s>>>(
      a.nbr, a.mask, a.f, a.u, a.out, a.n_rows, a.k, a.n_cols, a.planes, a.wu);
}

}  // namespace

// f: (planes, wf) uint32 vertical words, n_cols = 32 * wf a multiple of
// 1024; mask: (ceil(planes / 8), n_cols) uint8.
RT_API int rt_frontier_mask(const void* f, void* mask, long long n_cols, int planes,
                            long long wf, void* stream) {
  const dim3 grid(static_cast<unsigned>((n_cols / rt::kChunk + kMaskWarps - 1) / kMaskWarps),
                  static_cast<unsigned>((planes + kPlanesPerPass - 1) / kPlanesPerPass));
  frontier_mask_kernel<<<grid, kMaskWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(f), static_cast<uint8_t*>(mask), planes, wf, n_cols);
  return rt::launch_status();
}

// nbr: (n_rows, k) int32; mask: the frontier mask of f, or null when
// planes == 1 (the kernel probes f: (1, n_cols/32) uint32); u: (planes, wu)
// uint32 unreached-row bitmaps, or null (push); out: (planes, n_rows) int32.
// vec != 0: k % 4 == 0 and nbr 16-byte aligned.
RT_API int rt_spmv_min_planes(const void* nbr, const void* mask, const void* f, const void* u,
                              void* out, int n_rows, int k, int n_cols, int planes,
                              long long wu, int vec, void* stream) {
  // (with no columns no slot is probed, and the empty mask may be null)
  if (mask == nullptr && planes != 1 && n_cols > 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const EllArgs a{static_cast<const int*>(nbr), static_cast<const uint8_t*>(mask),
                  static_cast<const uint32_t*>(f), static_cast<const uint32_t*>(u),
                  static_cast<int*>(out), n_rows, k, n_cols, planes, wu};
  const auto s = static_cast<cudaStream_t>(stream);
  if (vec && mask != nullptr)
    launch_ell<true, true>(a, s);
  else if (vec)
    launch_ell<true, false>(a, s);
  else if (mask != nullptr)
    launch_ell<false, true>(a, s);
  else
    launch_ell<false, false>(a, s);
  return rt::launch_status();
}

// ---------------------------------------------------------------------------
// Frontier-algebra value gather with a min reduce over B planes.
//
// Replaces the Pallas kernel gspmm_min_planes_pallas / _gspmm_planes_kernel
// (src/repro/kernels/spmv/spmv.py:127 and :80):
//
//   out[p, r] = min over slots d with c = nbr[r, d] < n_cols and bit c of
//               frontier p of
//                 copy:    x[p, c]
//                 minplus: x[p, c] >= INF - w ? INF : x[p, c] + w,
//                          w = edge_weight(row_base + r, col_base + c)
//
// or INF when no slot hits.  x[p, c] reads as INF for c >= n_x (the
// reference pads x to n_cols with INF).  With u given (pull), a row whose
// bit in plane p's unreached bitmap is clear gives INF.
//
// Bound: bytes.  The slab once (R*K*4 bytes), each plane's frontier
// bitmap once (n_cols/8 bytes), the x[p, c] the hits need once (4 bytes
// each), the unreached bitmaps once, the (B, R) output once.
//
// What held the first design at 15.3x that bound: as the ELL kernel above,
// every real slot probed all 8 planes' bitmaps, with no early exit (a value
// minimum is not monotone in the column id); and every plane hit gathered
// x[q, c] from the (B, n_x) int32 array, 134 MB at scale 22, past the 50 MB
// L2: one random 32-byte sector for 4 bytes.  In stages at the densest SSSP
// level of scale 22 (throw-away stage builds, PERF.md): slab loads and
// stores 94 us, the probes +252 us, the weights and gathers +521 us.
//
// Design: the ELL kernel's, with the value gather, 8 slots a step (two
// int4) so all of a K = 8 row's value loads are in flight at once.  One mask
// byte per real slot ANDed with the live planes; a zero byte skips the slot
// before the edge weight is derived (once per hit slot: it depends on the
// pair, not the plane) and before any value is read.  The values' layout:
// - push at B > 1 (kInterleaved): interleave_values_kernel first copies
//   the frontier's columns into a (ceil(B/8), n_x, 8) int32 copy, and a hit
//   slot reads the one 32-byte sector holding all 8 planes' values of its
//   column (two int4 loads).  At the densest SSSP level 4.06 M of the 4.07 M
//   real slots hit, in 5.5 planes each: as they are, the values cost 22.2 M
//   random sectors (710 MB); copied, 4.06 M (130 MB) plus the copy's own
//   streams.  The copy writes only the frontier's columns, so at a sparse
//   level it costs the mask's stream and little else.  Summed over the 12
//   levels of an SSSP batch the copy wins; at the levels where it loses
//   (few planes a hit column) it costs up to 60 us, and neither the
//   frontier's bit count nor a per-column choice picks the better layout
//   for less (PERF.md; chip_smoke.py times both layouts at every level).
//   The copy is bound by bytes, read a sector at a time: at the densest
//   level almost every 32-byte sector of every plane of x holds a set bit,
//   so it reads nearly all of x (134 MB at scale 22) and writes 32 bytes a
//   written column.  A thread takes 4 consecutive columns: one 4-byte load
//   of their mask bytes, then one 16-byte evict-first load of x[q, c..c+3]
//   for each plane q with a bit in any of the 4 bytes, all issued before any
//   select (the first design loaded one 4-byte value a set bit, behind a
//   branch a column, and moved its traffic at ~2.3 TB/s).  Registers hold
//   the 4 x 8 transpose; INF where a bit is clear or the plane is past B.
//   The stores go through the warp's 4 KB of shared memory (a swizzled slot
//   per 16-byte half-column, conflict-free both ways), so each warp store
//   writes 512 contiguous bytes, and a half-column is stored only where its
//   column's byte is nonzero (read from its owner lane by a shuffle).
//   Storing each thread's own 4 columns directly (two int4 each, 128 bytes
//   apart across a warp: 32 lines a store) measured slower than the first
//   design at dense inputs and is not kept.  Unaligned rows and the ragged
//   tail take scalar loads in the same kernel (kVec).  At the densest SSSP
//   level of scale 22 the copy writes 2.38 M columns and reads 4.17 M
//   sectors of x: a sector-granular floor of 213.8 MB, 63.8 us, against
//   81.0 us of device time (96.0 us for the first design; bound 44.2 us
//   for the set bits alone); at an all-set mask it takes 93.6 us, where
//   the transpose copy x.view(g, 8, n_x).transpose(1, 2).contiguous()
//   takes 129.1 us (chip_smoke.py on an H100 80GB HBM3 at 700 W, PERF.md).
// - pull: only the planes where the row is unreached gather, and the copy
//   would not pay (210 us against 208 + 93 us at the densest level): x is
//   read as it is.  So is the one plane of B = 1 (kMask = false).
// A pull row reached in every plane of the pass writes INF and reads neither
// slab nor values.
// The hash is the uint32 avalanche of repro/core/algebra.py:edge_weight:
//   h = (a * 2654435761) ^ (b * 40503 + 2654435769); h ^= h >> 16;
//   w = h % max_weight + 1,  a = min(row, col), b = max(row, col).

namespace {

__device__ __forceinline__ int edge_weight(uint32_t row, uint32_t col, uint32_t max_weight) {
  const uint32_t a = min(row, col);
  const uint32_t b = max(row, col);
  uint32_t h = (a * 2654435761u) ^ ((b * 40503u) + 2654435769u);
  h = h ^ (h >> 16);
  return static_cast<int>(h % max_weight) + 1;
}

template <bool kMinPlus, bool kVec, bool kMask, bool kInterleaved>
__global__ void __launch_bounds__(kThreads)
    gspmm_min_planes_kernel(const int* __restrict__ nbr, const uint8_t* __restrict__ mask,
                            const uint32_t* __restrict__ f, const int* __restrict__ x,
                            const int4* __restrict__ xi, const uint32_t* __restrict__ u,
                            int* __restrict__ out, int n_rows, int k, int n_cols, int n_x,
                            int planes, int64_t wu, int row_base, int col_base,
                            int max_weight) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  const int* row = nbr + static_cast<int64_t>(r) * k;
  for (int p0 = 0; p0 < planes; p0 += kPlanesPerPass) {
    const int np = min(kPlanesPerPass, planes - p0);
    const uint8_t* m = mask + static_cast<int64_t>(p0 / kPlanesPerPass) * n_cols;
    // kInterleaved: xi is the (groups, n_x, 8) copy, one int4 pair a column
    const int4* xg = xi + static_cast<int64_t>(p0 / kPlanesPerPass) * n_x * 2;
    const uint32_t live = live_planes(u, wu, p0, np, r);
    int best[kPlanesPerPass];
#pragma unroll
    for (int q = 0; q < kPlanesPerPass; ++q) best[q] = rt::kInf;
    for (int d = 0; live != 0 && d < k; d += kGatherSlots) {
      int c[kGatherSlots];
      load_slots<kGatherSlots, kVec>(row, d, k, c);
      uint32_t hit[kGatherSlots];
#pragma unroll
      for (int j = 0; j < kGatherSlots; ++j)
        hit[j] = static_cast<unsigned>(c[j]) < static_cast<unsigned>(n_cols)
                     ? slot_planes<kMask>(m, f, c[j]) & live
                     : 0u;
#pragma unroll
      for (int j = 0; j < kGatherSlots; ++j) {
        if (hit[j] == 0) continue;
        int w = 0;
        if (kMinPlus)
          w = edge_weight(static_cast<uint32_t>(row_base + r),
                          static_cast<uint32_t>(col_base + c[j]),
                          static_cast<uint32_t>(max_weight));
        int v[kPlanesPerPass];
        if (c[j] >= n_x) {
#pragma unroll
          for (int q = 0; q < kPlanesPerPass; ++q) v[q] = rt::kInf;
        } else if (kInterleaved) {
          const int4 lo = __ldg(xg + 2 * static_cast<int64_t>(c[j]));
          const int4 hi = __ldg(xg + 2 * static_cast<int64_t>(c[j]) + 1);
          v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
          v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
        } else {
#pragma unroll
          for (int q = 0; q < kPlanesPerPass; ++q)
            v[q] = (hit[j] >> q) & 1u ? __ldg(x + static_cast<int64_t>(p0 + q) * n_x + c[j])
                                      : rt::kInf;
        }
#pragma unroll
        for (int q = 0; q < kPlanesPerPass; ++q) {
          if (!((hit[j] >> q) & 1u)) continue;
          int vq = v[q];
          if (kMinPlus) vq = vq >= rt::kInf - w ? rt::kInf : vq + w;
          best[q] = min(best[q], vq);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kPlanesPerPass; ++q)
      if (q < np) __stcs(out + static_cast<int64_t>(p0 + q) * n_rows + r, best[q]);
  }
}

// x: (planes, n_x) int32 and the frontier mask (groups, n_cols) -> xi:
// (groups, n_x, 8) int32 viewed as int4 pairs.  For each column c < n_x
// whose mask byte mask[g, c] is nonzero, xi[g, c, q] = x[8g + q, c] where
// bit q is set and 8g + q < planes, INF otherwise; no other column is
// written, and the gather reads no other (it reads a column's pair only when
// its byte hits, and uses only the set bits).  Thread t of the grid takes
// columns 4t .. 4t + 3 of group g (the value gather's note above).  kVec:
// x's rows 16-byte aligned and the mask's rows 4-byte aligned.
template <bool kVec>
__global__ void __launch_bounds__(kTileThreads)
    interleave_values_kernel(const int* __restrict__ x, const uint8_t* __restrict__ mask,
                             int4* __restrict__ xi, int n_x, int n_cols, int planes) {
  // a warp's 128 columns as 256 half-columns of 16 bytes; half-column 8t + j
  // of the warp sits in slot 8t + (j ^ (t & 7)), so neither the writes (lane
  // t, slots 8t + j) nor the reads (lane l, slots 32r + l) conflict
  __shared__ int4 stage[kTileThreads / 32][32 * kInterleaveCols * 2];
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.y;
  const int64_t c = kInterleaveCols * (static_cast<int64_t>(blockIdx.x) * kTileThreads +
                                       threadIdx.x);
  const int n = min(n_x, n_cols);  // the columns with both a value and a byte
  const uint32_t live = (1u << min(kPlanesPerPass, planes - kPlanesPerPass * g)) - 1u;
  const uint8_t* m = mask + static_cast<int64_t>(g) * n_cols + c;
  const int* xg = x + static_cast<int64_t>(g) * kPlanesPerPass * n_x + c;
  uint32_t bytes;  // the 4 columns' mask bytes; a column is written where its byte is not 0
  uint32_t b[kInterleaveCols];  // the same bytes, planes below `planes` only
  int v[kPlanesPerPass][kInterleaveCols];
  if (kVec && c + kInterleaveCols <= n) {
    bytes = __ldg(reinterpret_cast<const uint32_t*>(m));
#pragma unroll
    for (int k = 0; k < kInterleaveCols; ++k) b[k] = (bytes >> (8 * k)) & live;
    const uint32_t any = b[0] | b[1] | b[2] | b[3];
    // one 16-byte load a plane with a bit in any of the 4 bytes, all
    // issued before any select
#pragma unroll
    for (int q = 0; q < kPlanesPerPass; ++q) {
      int4 t = make_int4(rt::kInf, rt::kInf, rt::kInf, rt::kInf);
      if ((any >> q) & 1u)
        t = __ldcs(reinterpret_cast<const int4*>(xg + static_cast<int64_t>(q) * n_x));
      v[q][0] = t.x; v[q][1] = t.y; v[q][2] = t.z; v[q][3] = t.w;
    }
  } else {  // a misaligned row or the ragged tail: scalars
    bytes = 0;
#pragma unroll
    for (int k = 0; k < kInterleaveCols; ++k) {
      if (c + k < n) bytes |= static_cast<uint32_t>(__ldg(m + k)) << (8 * k);
      b[k] = (bytes >> (8 * k)) & live;
    }
#pragma unroll
    for (int q = 0; q < kPlanesPerPass; ++q)
#pragma unroll
      for (int k = 0; k < kInterleaveCols; ++k)
        v[q][k] = (b[k] >> q) & 1u ? __ldcs(xg + static_cast<int64_t>(q) * n_x + k) : rt::kInf;
  }
  if (__ballot_sync(0xffffffffu, bytes != 0) == 0) return;  // warp-uniform
  // the 4 x 8 transpose: column k's 8 planes, INF where the bit is clear
  int4* s = stage[threadIdx.x >> 5];
#pragma unroll
  for (int k = 0; k < kInterleaveCols; ++k) {
    int o[kPlanesPerPass];
#pragma unroll
    for (int q = 0; q < kPlanesPerPass; ++q) o[q] = (b[k] >> q) & 1u ? v[q][k] : rt::kInf;
    s[8 * lane + ((2 * k) ^ (lane & 7))] = make_int4(o[0], o[1], o[2], o[3]);
    s[8 * lane + ((2 * k + 1) ^ (lane & 7))] = make_int4(o[4], o[5], o[6], o[7]);
  }
  __syncwarp();
  // 512 contiguous bytes a warp store; a half-column is stored where its
  // column's byte (held by lane t) is nonzero
  int4* dst = xi + (static_cast<int64_t>(g) * n_x + (c - kInterleaveCols * lane)) * 2;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int h = 32 * r + lane;
    const int t = h >> 3;
    const uint32_t owner = __shfl_sync(0xffffffffu, bytes, t);
    if ((owner >> (8 * ((h >> 1) & 3))) & 0xFFu) dst[h] = s[8 * t + ((h & 7) ^ (t & 7))];
  }
}

struct GspmmArgs {
  const int* nbr;
  const uint8_t* mask;
  const uint32_t* f;
  const int* x;
  const int4* xi;
  const uint32_t* u;
  int* out;
  int n_rows, k, n_cols, n_x, planes;
  int64_t wu;
  int row_base, col_base, max_weight;
};

template <bool kMinPlus, bool kVec, bool kMask, bool kInterleaved>
void launch_gspmm(const GspmmArgs& a, cudaStream_t s) {
  const unsigned blocks = static_cast<unsigned>((a.n_rows + kThreads - 1) / kThreads);
  gspmm_min_planes_kernel<kMinPlus, kVec, kMask, kInterleaved><<<blocks, kThreads, 0, s>>>(
      a.nbr, a.mask, a.f, a.x, a.xi, a.u, a.out, a.n_rows, a.k, a.n_cols, a.n_x, a.planes,
      a.wu, a.row_base, a.col_base, a.max_weight);
}

template <bool kMinPlus, bool kVec>
void launch_gspmm(const GspmmArgs& a, cudaStream_t s) {
  if (a.mask == nullptr)
    launch_gspmm<kMinPlus, kVec, false, false>(a, s);
  else if (a.xi != nullptr)
    launch_gspmm<kMinPlus, kVec, true, true>(a, s);
  else
    launch_gspmm<kMinPlus, kVec, true, false>(a, s);
}

template <bool kMinPlus>
void launch_gspmm(const GspmmArgs& a, bool vec, cudaStream_t s) {
  if (vec)
    launch_gspmm<kMinPlus, true>(a, s);
  else
    launch_gspmm<kMinPlus, false>(a, s);
}

}  // namespace

// x: (planes, n_x) int32, mask: (ceil(planes / 8), n_cols) uint8 -> xi:
// (ceil(planes / 8), n_x, 8) int32, written for the columns whose byte is
// nonzero, the others left as they were.  vec != 0: x 16-byte aligned with
// n_x % 4 == 0, the mask 4-byte aligned with n_cols % 4 == 0.
RT_API int rt_interleave_values(const void* x, const void* mask, void* xi, int planes,
                                int n_x, int n_cols, int vec, void* stream) {
  const int n = n_x < n_cols ? n_x : n_cols;
  if (n <= 0) return rt::launch_status();  // no column to write
  constexpr int kCols = kInterleaveCols * kTileThreads;
  const dim3 grid(static_cast<unsigned>((n + kCols - 1) / kCols),
                  static_cast<unsigned>((planes + kPlanesPerPass - 1) / kPlanesPerPass));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xs = static_cast<const int*>(x);
  const auto* ms = static_cast<const uint8_t*>(mask);
  auto* out = static_cast<int4*>(xi);
  if (vec)
    interleave_values_kernel<true><<<grid, kTileThreads, 0, s>>>(xs, ms, out, n_x, n_cols, planes);
  else
    interleave_values_kernel<false><<<grid, kTileThreads, 0, s>>>(xs, ms, out, n_x, n_cols,
                                                                  planes);
  return rt::launch_status();
}

// nbr: (n_rows, k) int32; mask / f as for rt_spmv_min_planes; x: the
// (planes, n_x) int32 values; xi: null, or (with a mask) their
// rt_interleave_values copy, which the kernel then reads instead; u:
// (planes, wu) uint32 unreached bitmaps or null (push); out: (planes,
// n_rows) int32.  minplus != 0 adds the hashed edge weight.
RT_API int rt_gspmm_min_planes(const void* nbr, const void* mask, const void* f, const void* x,
                               const void* xi, const void* u, void* out, int n_rows, int k,
                               int n_cols, int n_x, int planes, long long wu, int row_base,
                               int col_base, int minplus, int max_weight, int vec,
                               void* stream) {
  if (mask == nullptr && n_cols > 0 && (planes != 1 || xi != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const GspmmArgs a{static_cast<const int*>(nbr), static_cast<const uint8_t*>(mask),
                    static_cast<const uint32_t*>(f), static_cast<const int*>(x),
                    static_cast<const int4*>(xi), static_cast<const uint32_t*>(u),
                    static_cast<int*>(out), n_rows, k, n_cols, n_x, planes, wu, row_base,
                    col_base, max_weight};
  const auto s = static_cast<cudaStream_t>(stream);
  if (minplus)
    launch_gspmm<true>(a, vec != 0, s);
  else
    launch_gspmm<false>(a, vec != 0, s);
  return rt::launch_status();
}
