// What every kernel source shares: XLA's two id rules, the skipped +-0 add,
// the row load, and the shape of a warp's thread groups.  The device-side
// twin of kernels/common.py.
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

#include <type_traits>

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

// The same for W consecutive floats: W = 4 is one 16-byte atomicAdd on a
// float4 (sm_90 and later, global memory, p 16-byte aligned), skipped when
// all four are +-0; adding +-0 to the other lanes of a float4 changes
// nothing.
template <int W>
__device__ __forceinline__ void add_nonzero(float* p, const float (&c)[W]) {
  if constexpr (W == 4) {
    if (c[0] != 0.0f || c[1] != 0.0f || c[2] != 0.0f || c[3] != 0.0f) {
      atomicAdd(reinterpret_cast<float4*>(p),
                make_float4(c[0], c[1], c[2], c[3]));
    }
  } else {
    add_nonzero(p, c[0]);
  }
}

// W consecutive floats of a table row: one float4 load (W = 4, 16-byte
// aligned) or one float.
template <int W>
__device__ __forceinline__ void load_row(const float* p, float (&x)[W]) {
  if constexpr (W == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = t.x;
    x[1] = t.y;
    x[2] = t.z;
    x[3] = t.w;
  } else {
    x[0] = __ldg(p);
  }
}

// Threads per group: D/4 (float4 loads) or D (scalar), rounded up to a power
// of two and capped at a warp, so a group never straddles two warps.
inline int group_size(int D, int vec4) {
  const int n = vec4 ? D / 4 : D;
  int g = 1;
  while (g < n && g < 32) g <<= 1;
  return g;
}

// A warp of 32 / G groups of G lanes; U warp-steps (one entry per group
// each) load their table rows together before any is summed, so U rows per
// group, 32 * U / G per warp, are in flight.  U is UMAX, or 4 where G is
// small, since one iteration then covers more entries already.
template <int G, int UMAX>
struct WarpShape {
  static constexpr int P = 32 / G;            // entries in one warp-step
  static constexpr int U = G <= 2 ? 4 : UMAX; // warp-steps loaded together
  static constexpr int E = P * U;             // entries in one iteration
  static constexpr int M = (E + 31) / 32;     // their metadata words a lane
};

// Streaming multiprocessors of the current device.
inline int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

// f(std::integral_constant<int, G>{}) for the runtime group size G, so a
// launcher can instantiate its kernel for each G.
template <typename Fn>
cudaError_t with_group(int G, Fn&& f) {
  switch (G) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
