// ELL frontier expansion, push and pull, over B frontier planes.
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
// written once.  The work is a handful of integer operations per slot.
//
// Design: one thread per row.  The TPU kernel re-streams the slab once per
// plane (spmv.py:176-181) and carries the min across its sequential
// degree-chunk grid axis by output revisiting (spmv.py:50-56); here the
// thread loads each of its row's K slots once and probes it against up to
// kPlanesPerPass planes, keeping the per-plane mins in registers, so at the
// main path's B = 8 the slab is read exactly once.  A slot is probed for a
// plane only while it could still lower that plane's min (slab rows are
// ascending on the graphs the builder makes, so a row stops probing at its
// first hit).  Pull reads the row's unreached bits first and skips the
// probe, and the slab row, for planes where the row is already reached.
// The frontier bitmap is n_cols/8 bytes per plane (512 KB at scale 22), more
// than the 227 KB of shared memory a block may use, so it is not staged as
// the TPU kernel kept it in VMEM (spmv.py:4-7): the probes gather it through
// the read-only path from L2, which holds all B planes.  No ROW_TILE /
// DEG_CHUNK padding is needed: the grid masks its ragged edge.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPlanesPerPass = 8;

template <bool kPull>
__global__ void ell_min_planes_kernel(const int* __restrict__ nbr,
                                      const uint32_t* __restrict__ f,
                                      const uint32_t* __restrict__ u,
                                      int* __restrict__ out, int n_rows, int k,
                                      int n_cols, int planes, int64_t wf, int64_t wu) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  const int* row = nbr + static_cast<int64_t>(r) * k;
  for (int p0 = 0; p0 < planes; p0 += kPlanesPerPass) {
    const int np = min(kPlanesPerPass, planes - p0);
    const uint32_t* fp = f + static_cast<int64_t>(p0) * wf;
    uint32_t probe = 0;  // bit q: plane p0 + q probes this row
    int best[kPlanesPerPass];
#pragma unroll
    for (int q = 0; q < kPlanesPerPass; ++q) {
      best[q] = rt::kInf;
      if (q < np && (!kPull || rt::bitmap_bit(u + static_cast<int64_t>(p0 + q) * wu, r)))
        probe |= 1u << q;
    }
    for (int d = 0; probe != 0 && d < k; ++d) {
      const int c = __ldg(row + d);
      if (static_cast<unsigned>(c) >= static_cast<unsigned>(n_cols)) continue;
#pragma unroll
      for (int q = 0; q < kPlanesPerPass; ++q) {
        if (((probe >> q) & 1u) && c < best[q] && rt::bitmap_bit(fp + q * wf, c))
          best[q] = c;
      }
    }
#pragma unroll
    for (int q = 0; q < kPlanesPerPass; ++q)
      if (q < np) out[static_cast<int64_t>(p0 + q) * n_rows + r] = best[q];
  }
}

template <bool kPull>
int launch_ell(const void* nbr, const void* f, const void* u, void* out, int n_rows, int k,
               int n_cols, int planes, long long wf, long long wu, void* stream) {
  const unsigned blocks = static_cast<unsigned>((n_rows + kThreads - 1) / kThreads);
  ell_min_planes_kernel<kPull><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nbr), static_cast<const uint32_t*>(f),
      static_cast<const uint32_t*>(u), static_cast<int*>(out), n_rows, k, n_cols, planes,
      wf, wu);
  return rt::launch_status();
}

}  // namespace

// nbr: (n_rows, k) int32; f: (planes, wf) uint32; out: (planes, n_rows) int32.
RT_API int rt_spmv_min_planes(const void* nbr, const void* f, void* out, int n_rows, int k,
                              int n_cols, int planes, long long wf, void* stream) {
  return launch_ell<false>(nbr, f, nullptr, out, n_rows, k, n_cols, planes, wf, 0, stream);
}

// As above, plus u: (planes, wu) uint32 unreached-row bitmaps.
RT_API int rt_spmv_pull_min_planes(const void* nbr, const void* f, const void* u, void* out,
                                   int n_rows, int k, int n_cols, int planes, long long wf,
                                   long long wu, void* stream) {
  return launch_ell<true>(nbr, f, u, out, n_rows, k, n_cols, planes, wf, wu, stream);
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
// bitmap once (n_cols/8 bytes), each plane's value row once (n_cols*4
// bytes, gathered), the unreached bitmaps once, the (B, R) output once.
//
// Design: one thread per row, as the ELL kernels above.  The TPU kernel
// streams a (1024, 8) slab tile per plane and keeps the plane's value
// vector resident in VMEM (spmv.py:155-156); at scale 22 one plane's values
// are 16 MB, past shared memory, so here x is gathered through the
// read-only path and L2.  The thread loads each of its K slots once per
// pass of up to kPlanesPerPass planes, derives the edge weight once per
// slot (it depends on the pair, not the plane), and keeps each plane's min
// in registers.  There is no early exit: a value minimum is not monotone
// in the column id, so every hit slot is probed.  A pull row reached in
// every plane of the pass writes INF and reads neither slab nor values.
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

template <bool kMinPlus>
__global__ void gspmm_min_planes_kernel(const int* __restrict__ nbr,
                                        const uint32_t* __restrict__ f,
                                        const int* __restrict__ x,
                                        const uint32_t* __restrict__ u,
                                        int* __restrict__ out, int n_rows, int k, int n_cols,
                                        int n_x, int planes, int64_t wf, int64_t wu,
                                        int row_base, int col_base, int max_weight) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  const int* row = nbr + static_cast<int64_t>(r) * k;
  for (int p0 = 0; p0 < planes; p0 += kPlanesPerPass) {
    const int np = min(kPlanesPerPass, planes - p0);
    const uint32_t* fp = f + static_cast<int64_t>(p0) * wf;
    const int* xp = x + static_cast<int64_t>(p0) * n_x;
    uint32_t probe = 0;  // bit q: plane p0 + q probes this row
    int best[kPlanesPerPass];
#pragma unroll
    for (int q = 0; q < kPlanesPerPass; ++q) {
      best[q] = rt::kInf;
      if (q < np && (u == nullptr || rt::bitmap_bit(u + static_cast<int64_t>(p0 + q) * wu, r)))
        probe |= 1u << q;
    }
    for (int d = 0; probe != 0 && d < k; ++d) {
      const int c = __ldg(row + d);
      if (static_cast<unsigned>(c) >= static_cast<unsigned>(n_cols)) continue;
      int w = 0;
      if (kMinPlus)
        w = edge_weight(static_cast<uint32_t>(row_base + r), static_cast<uint32_t>(col_base + c),
                        static_cast<uint32_t>(max_weight));
#pragma unroll
      for (int q = 0; q < kPlanesPerPass; ++q) {
        if (!((probe >> q) & 1u) || !rt::bitmap_bit(fp + q * wf, c)) continue;
        int v = c < n_x ? __ldg(xp + static_cast<int64_t>(q) * n_x + c) : rt::kInf;
        if (kMinPlus) v = v >= rt::kInf - w ? rt::kInf : v + w;
        best[q] = min(best[q], v);
      }
    }
#pragma unroll
    for (int q = 0; q < kPlanesPerPass; ++q)
      if (q < np) out[static_cast<int64_t>(p0 + q) * n_rows + r] = best[q];
  }
}

}  // namespace

// nbr: (n_rows, k) int32; f: (planes, wf) uint32; x: (planes, n_x) int32;
// u: (planes, wu) uint32 unreached bitmaps or null (push); out: (planes,
// n_rows) int32.  minplus != 0 adds the hashed edge weight.
RT_API int rt_gspmm_min_planes(const void* nbr, const void* f, const void* x, const void* u,
                               void* out, int n_rows, int k, int n_cols, int n_x, int planes,
                               long long wf, long long wu, int row_base, int col_base,
                               int minplus, int max_weight, void* stream) {
  const unsigned blocks = static_cast<unsigned>((n_rows + kThreads - 1) / kThreads);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* nbr_p = static_cast<const int*>(nbr);
  const auto* f_p = static_cast<const uint32_t*>(f);
  const auto* x_p = static_cast<const int*>(x);
  const auto* u_p = static_cast<const uint32_t*>(u);
  auto* out_p = static_cast<int*>(out);
  if (minplus)
    gspmm_min_planes_kernel<true><<<blocks, kThreads, 0, s>>>(
        nbr_p, f_p, x_p, u_p, out_p, n_rows, k, n_cols, n_x, planes, wf, wu, row_base,
        col_base, max_weight);
  else
    gspmm_min_planes_kernel<false><<<blocks, kThreads, 0, s>>>(
        nbr_p, f_p, x_p, u_p, out_p, n_rows, k, n_cols, n_x, planes, wf, wu, row_base,
        col_base, max_weight);
  return rt::launch_status();
}
