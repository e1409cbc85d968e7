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
// Design: one warp per group.  Each lane loads its 4 values as one float4,
// so a warp reads the group's 512 bytes in one coalesced access; the
// max-abs is reduced across the warp with __shfl_xor_sync (every lane ends
// with it), each lane stores its 4 codes as one char4 and lane 0 stores the
// scale.  The TPU's (8, 128) tile is not kept: a block is 8 warps, 8 groups.
// The divisions are IEEE (no fast-math flag), and rintf rounds half to even
// as jnp.round and torch.round do: a reciprocal multiply or roundf would
// move q by one step at ties and boundaries.
//
// Non-finite inputs give the plain version's answer.  fmaxf drops NaN, but
// amax propagates it, so a group that holds a NaN gets a NaN scale (and
// divides by 1).  A value whose quotient is NaN (NaN itself, or inf over an
// inf scale) gets code 0, as the plain version's float-to-int8 cast gives
// it.  Such a group dequantizes to NaN everywhere, as the plain one does.
#include "common.cuh"

namespace {

constexpr int kGroup = 128;
constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ signed char code(float v, float safe) {
  const float r = rintf(v / safe);
  if (isnan(r)) return 0;  // fminf/fmaxf would clamp NaN to -127
  return static_cast<signed char>(static_cast<int>(fminf(fmaxf(r, -127.0f), 127.0f)));
}

__global__ void quantize_kernel(const float4* __restrict__ x, char4* __restrict__ q,
                                float* __restrict__ scales, int64_t groups) {
  const int lane = threadIdx.x & 31;
  const int64_t g = blockIdx.x * static_cast<int64_t>(kWarpsPerBlock) + (threadIdx.x >> 5);
  if (g >= groups) return;  // the whole warp leaves together
  const int64_t i = g * (kGroup / 4) + lane;
  const float4 v = __ldg(x + i);
  float m = fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  const bool has_nan = isnan(v.x) || isnan(v.y) || isnan(v.z) || isnan(v.w);
  if (__any_sync(0xffffffffu, has_nan)) m = nanf("");
  const float scale = m / 127.0f;
  const float safe = scale > 0.0f ? scale : 1.0f;
  q[i] = make_char4(code(v.x, safe), code(v.y, safe), code(v.z, safe), code(v.w, safe));
  if (lane == 0) scales[g] = scale;
}

}  // namespace

// x: (groups * 128,) float32, 16-byte aligned; q: (groups * 128,) int8;
// scales: (groups,) float32.
RT_API int rt_quantize(const void* x, void* q, void* scales, long long groups, void* stream) {
  const unsigned blocks =
      static_cast<unsigned>((groups + kWarpsPerBlock - 1) / kWarpsPerBlock);
  quantize_kernel<<<blocks, 32 * kWarpsPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<char4*>(q), static_cast<float*>(scales),
      groups);
  return rt::launch_status();
}
