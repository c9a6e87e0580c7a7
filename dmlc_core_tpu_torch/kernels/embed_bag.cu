// Row-padded weighted embedding bag for Hopper (sm_90a): forward and backward.
//
// Replaces dmlc_core_tpu/ops/pallas_embed.py::_kernel (launched by
// _embed_bag_pallas_one / embed_bag_pallas) and the XLA backward of its custom
// VJP (_embed_bag_pallas_diff, pallas_embed.py:229-239).  For ids, vals of
// shape [B, K] and a table [F, D], with t(x) = x*x when SQUARE else x:
//
//   forward:   out[b]        = sum_k vals[b,k] * t(table[clamp(ids[b,k])])
//   backward:  dvals[b,k]    = sum_d g[b,d] * t(x_bk)[d]
//              dtable[r(id)] += coeff_bk * g[b]     coeff = 2*v*x if SQUARE
//                                                            else v
//
// Ids follow XLA (common.cuh): the forward clamps, the backward scatter drops
// what lies outside the table after one wrap, as jnp's .at[ids].add does.
//
// What bounds it: bytes.  Each (b, k) reads one D-float table row and two
// 4-byte words; the flops (2 or 3 per element) are far below the card's rate.
// Design:
//   * forward: the warp-per-row loop of warp_rows.cuh, shared with the
//     fm-terms forward, with one sum (BagSum below): a warp per row b, 32/G
//     groups of G = D/4 lanes each issuing 16 float4 row loads before it
//     sums any (at D = 32 a row's 64 gathers in flight together), a fixed
//     xor shuffle tree, a k split in k order at small B.  Deterministic
//     (bit-equal from call to call), no atomics, no output memset.  Every
//     entry is computed, padding included, as the JAX forward does (a
//     padding entry multiplies table row 0 by 0, which matters if that row
//     holds inf/NaN).
//   * backward: a group per entry (b, k).  dvals comes from a shuffle
//     reduction inside the group (written for every entry, so the output
//     needs no memset); dtable is a dense zeroed buffer the caller allocates
//     and each entry adds its row with atomicAdd, resolved in L2.  The table
//     row is read only when it is needed (dvals asked for, or SQUARE).  An
//     add of +-0 is skipped: dtable starts at +0 and can never become -0, so
//     such an add changes nothing, and padding entries (value 0) then cost no
//     atomics on row 0.  A NaN coefficient is not 0 and is still added.
// The TPU kernel's 8-row grid, SMEM scalar chunking and DMA ring are TPU
// artifacts and have no counterpart here.

#include "warp_rows.cuh"

namespace {

template <bool SQUARE>
__device__ __forceinline__ float tx(float x) {
  return SQUARE ? x * x : x;
}

// ---------------------------------------------------------------- forward --

// One entry's term of the bag's single sum, for warp_rows.cuh.
template <bool SQUARE>
struct BagSum {
  static constexpr int N = 1;
  static __device__ __forceinline__ void add(float v, float x, float (&a)[1]) {
    a[0] += v * tx<SQUARE>(x);
  }
};

// --------------------------------------------------------------- backward --

// One group per entry e = b * K + k.  Every thread of a warp reaches the
// shuffle reduction (entries past the end only contribute 0), so the full
// mask is safe.
template <bool SQUARE, bool VEC4, bool NEED_X>
__global__ void embed_bag_bwd(const int* __restrict__ ids,
                              const float* __restrict__ vals,
                              const float* __restrict__ table,
                              const float* __restrict__ g,
                              float* __restrict__ dvals,
                              float* __restrict__ dtable, int B, int K, int F,
                              int D, int group) {
  const int per_block = blockDim.x / group;
  const int64_t e = (int64_t)blockIdx.x * per_block + threadIdx.x / group;
  const int lane = threadIdx.x % group;
  const bool live = e < (int64_t)B * K;
  float part = 0.f;
  if (live) {
    const int64_t b = e / K;
    const int id = __ldg(ids + e);
    const float v = __ldg(vals + e);
    const float* gr = g + b * D;
    const float* xr = table + clamp_id(id, F) * D;
    const int64_t row = dtable ? grad_row(id, F) : -1;
    float* dr = row >= 0 ? dtable + row * D : nullptr;
    if (VEC4) {
      for (int c = lane; c < D / 4; c += group) {
        const float4 gv = __ldg(reinterpret_cast<const float4*>(gr) + c);
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (NEED_X) x = __ldg(reinterpret_cast<const float4*>(xr) + c);
        if (dvals) {
          part += gv.x * tx<SQUARE>(x.x) + gv.y * tx<SQUARE>(x.y) +
                  gv.z * tx<SQUARE>(x.z) + gv.w * tx<SQUARE>(x.w);
        }
        if (dr) {
          float* p = dr + 4 * c;
          add_nonzero(p + 0, (SQUARE ? 2.f * v * x.x : v) * gv.x);
          add_nonzero(p + 1, (SQUARE ? 2.f * v * x.y : v) * gv.y);
          add_nonzero(p + 2, (SQUARE ? 2.f * v * x.z : v) * gv.z);
          add_nonzero(p + 3, (SQUARE ? 2.f * v * x.w : v) * gv.w);
        }
      }
    } else {
      for (int d = lane; d < D; d += group) {
        const float gv = __ldg(gr + d);
        const float x = NEED_X ? __ldg(xr + d) : 0.f;
        if (dvals) part += gv * tx<SQUARE>(x);
        if (dr) add_nonzero(dr + d, (SQUARE ? 2.f * v * x : v) * gv);
      }
    }
  }
  if (dvals) {
    for (int off = group / 2; off > 0; off >>= 1) {
      part += __shfl_xor_sync(0xffffffffu, part, off, group);
    }
    if (live && lane == 0) dvals[e] = part;
  }
}

constexpr int kThreads = 128;

template <bool SQUARE, bool NEED_X>
cudaError_t launch_bwd(const int* ids, const float* vals, const float* table,
                       const float* g, float* dvals, float* dtable, int B,
                       int K, int F, int D, int vec4, cudaStream_t s) {
  const int group = group_size(D, vec4);
  const int per_block = kThreads / group;
  const int64_t entries = (int64_t)B * K;
  const int64_t blocks = (entries + per_block - 1) / per_block;
  if (vec4) {
    embed_bag_bwd<SQUARE, true, NEED_X><<<(unsigned)blocks, kThreads, 0, s>>>(
        ids, vals, table, g, dvals, dtable, B, K, F, D, group);
  } else {
    embed_bag_bwd<SQUARE, false, NEED_X><<<(unsigned)blocks, kThreads, 0, s>>>(
        ids, vals, table, g, dvals, dtable, B, K, F, D, group);
  }
  return cudaGetLastError();
}

}  // namespace

// out is [B, D] and needs no initialisation.  vec4 != 0 requires D % 4 == 0
// and a 16-byte aligned table and out.  Returns a cudaError_t (0 = launched).
extern "C" int embed_bag_launch(const int* ids, const float* vals,
                                const float* table, float* out, int B, int K,
                                int F, int D, int square, int vec4,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return square ? launch_warp_rows<BagSum<true>>(ids, vals, table, out,
                                                 nullptr, B, K, F, D, vec4, s)
                : launch_warp_rows<BagSum<false>>(ids, vals, table, out,
                                                  nullptr, B, K, F, D, vec4,
                                                  s);
}

// dvals ([B, K], written in full) and dtable ([F, D], zeroed by the caller)
// may each be null when not wanted.  vec4 != 0 requires D % 4 == 0 and
// 16-byte aligned table, g and dtable.  Returns a cudaError_t.
extern "C" int embed_bag_grad_launch(const int* ids, const float* vals,
                                     const float* table, const float* g,
                                     float* dvals, float* dtable, int B,
                                     int K, int F, int D, int square, int vec4,
                                     void* stream) {
  if (B <= 0 || K <= 0 || D <= 0) return 0;
  if (dvals == nullptr && dtable == nullptr) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool need_x = square || dvals != nullptr;
  if (square) {
    return launch_bwd<true, true>(ids, vals, table, g, dvals, dtable, B, K, F,
                                  D, vec4, s);
  }
  if (need_x) {
    return launch_bwd<false, true>(ids, vals, table, g, dvals, dtable, B, K,
                                   F, D, vec4, s);
  }
  return launch_bwd<false, false>(ids, vals, table, g, dvals, dtable, B, K, F,
                                  D, vec4, s);
}
