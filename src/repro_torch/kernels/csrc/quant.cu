// Int8 block quantization: per group of 128 consecutive float32 values,
// scale = max|x| / 127 and q = clip(rint(x / scale), -127, 127) as int8 (an
// all-zero group divides by 1).
//
// Replaces the Pallas kernel quantize_pallas / _quant_kernel
// (src/repro/kernels/quant/quant.py:31 and :23).
//
// Bound: bytes.  Each value is read once (4 bytes) and written once as int8,
// plus one 4-byte scale per group: 4N + N + N/32 bytes; the arithmetic is a
// handful of operations per value.
//
// Design: a warp takes G = 4 consecutive groups at a time, walking the groups
// in a grid-stride loop over a grid sized to the card (rt::stride_grid).
// Each lane issues the G 16-byte loads of its 4 values in each of the G
// groups before any reduction, so G loads a lane are in flight; the loads stream (__ldcs: every
// value is read once).  A group's max-abs is one __reduce_max_sync over the
// bit patterns of |x| (for non-negative floats the unsigned order is the
// float order, and every NaN pattern lies above +inf), so all lanes hold it
// after one instruction instead of five shuffles.  Each lane stores its 4
// codes of a group as one char4, and lanes 0..G-1 store the G scales, one
// 4G-byte store.  A step whose G groups run past the end keeps the loop's
// warp-uniform exit: the groups past the end load zeros and store nothing.
// The TPU's (8, 128) tile is not kept.  The divisions are IEEE (no fast-math
// flag) and rintf rounds half to even as jnp.round and torch.round do: a
// reciprocal multiply or roundf would move q by one step at ties and
// boundaries.  The IEEE division's range check (FCHK) sends a zero
// numerator to its slow path, a call per zero; the GNN's owned chunks are
// up to 36% zeros (the padding rows), which made them 40% slower than
// random values.  So a zero is divided as a stand-in 1 and given its exact
// answer afterwards: code 0, and scale 0 for an all-zero group.
//
// Non-finite inputs give the plain version's answer.  The max of the bit
// patterns is a NaN when the group holds a NaN, as amax propagates it, so
// such a group gets a NaN scale (and divides by 1).  A value whose quotient
// is NaN (NaN itself, or inf over an inf scale) gets code 0, as the plain
// version's float-to-int8 cast gives it.  Such a group dequantizes to NaN
// everywhere, as the plain one does.
#include "common.cuh"

namespace {

constexpr int kGroup = 128;
constexpr int kVecs = kGroup / 4;  // float4 vectors a group: one a lane
constexpr int kThreads = rt::kStrideBlock;
constexpr int G = 4;  // groups a warp and step, their loads in flight together

// x / d for x != 0 (IEEE); the caller gives x == 0 its own answer.  See
// the head note: a zero numerator would take the division's slow path.
__device__ __forceinline__ float quotient(float x, float d) {
  return (x == 0.0f ? 1.0f : x) / d;
}

__device__ __forceinline__ signed char code(float v, float safe) {
  const float r = rintf(quotient(v, safe));
  if (v == 0.0f || isnan(r)) return 0;  // fminf/fmaxf would clamp NaN to -127
  return static_cast<signed char>(static_cast<int>(fminf(fmaxf(r, -127.0f), 127.0f)));
}

__device__ __forceinline__ unsigned abs_bits(const float4& v) {
  const unsigned a = __float_as_uint(v.x) & 0x7fffffffu, b = __float_as_uint(v.y) & 0x7fffffffu;
  const unsigned c = __float_as_uint(v.z) & 0x7fffffffu, d = __float_as_uint(v.w) & 0x7fffffffu;
  return max(max(a, b), max(c, d));
}

// G consecutive groups a warp and step; see the head note.
__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const float4* __restrict__ x, char4* __restrict__ q,
                    float* __restrict__ scales, int64_t groups) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t g0 = ((blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5) * G;
       g0 < groups; g0 += warps * G) {  // warp-uniform: the reductions see all 32 lanes
    float4 v[G];
#pragma unroll
    for (int t = 0; t < G; ++t)
      v[t] = g0 + t < groups ? __ldcs(x + (g0 + t) * kVecs + lane) : make_float4(0, 0, 0, 0);
    float scale[G];
#pragma unroll
    for (int t = 0; t < G; ++t) {
      const float m = __uint_as_float(__reduce_max_sync(0xffffffffu, abs_bits(v[t])));
      scale[t] = m == 0.0f ? 0.0f : quotient(m, 127.0f);
      if (g0 + t < groups) {
        const float safe = scale[t] > 0.0f ? scale[t] : 1.0f;
        q[(g0 + t) * kVecs + lane] = make_char4(code(v[t].x, safe), code(v[t].y, safe),
                                                code(v[t].z, safe), code(v[t].w, safe));
      }
    }
    float mine = scale[0];
#pragma unroll
    for (int t = 1; t < G; ++t)
      if (lane == t) mine = scale[t];
    if (lane < G && g0 + lane < groups) scales[g0 + lane] = mine;
  }
}

}  // namespace

// x: (groups * 128,) float32, 16-byte aligned; q: (groups * 128,) int8,
// 4-byte aligned; scales: (groups,) float32.
RT_API int rt_quantize(const void* x, void* q, void* scales, long long groups, void* stream) {
  quantize_kernel<<<rt::stride_grid((groups + G - 1) / G * 32), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<char4*>(q), static_cast<float*>(scales), groups);
  return rt::launch_status();
}
