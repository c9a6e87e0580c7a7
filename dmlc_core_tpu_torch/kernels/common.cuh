// What every kernel source shares: XLA's two id rules, the skipped +-0 add,
// and the size of a thread group.  The device-side twin of kernels/common.py.
//
// Out-of-range feature ids follow XLA, which the JAX package relies on:
//   * the forward gather (clamp_id): a negative id counts from the end of the
//     table, then ids are clamped into [0, F);
//   * the backward scatter-add (grad_row): a negative id wraps once, and the
//     entry is dropped (-1) unless it then lies in [0, F).
// So an id of F + 7 reads row F - 1 but sends it no gradient.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int64_t clamp_id(int id, int F) {
  int64_t r = id;
  if (r < 0) r += F;
  return r < 0 ? 0 : (r >= F ? F - 1 : r);
}

__device__ __forceinline__ int64_t grad_row(int id, int F) {
  int64_t r = id;
  if (r < 0) r += F;
  return (r < 0 || r >= F) ? -1 : r;
}

// An add of +-0 is skipped: every accumulator starts at +0 and can never
// become -0, so such an add changes nothing; padding entries (value 0) then
// cost no atomics.  A NaN is not 0 and is still added.
__device__ __forceinline__ void add_nonzero(float* p, float c) {
  if (c != 0.0f) atomicAdd(p, c);
}

// Threads per group: D/4 (float4 loads) or D (scalar), rounded up to a power
// of two and capped at a warp, so a group never straddles two warps.
inline int group_size(int D, int vec4) {
  const int n = vec4 ? D / 4 : D;
  int g = 1;
  while (g < n && g < 32) g <<= 1;
  return g;
}

}  // namespace
