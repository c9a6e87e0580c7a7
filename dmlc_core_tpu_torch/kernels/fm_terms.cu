// Row-major FM terms for Hopper (sm_90a): forward and backward.
//
// Replaces dmlc_core_tpu/ops/pallas_embed.py::_fm_kernel (launched by
// _fm_terms_pallas_one / fm_terms_pallas) and the XLA backward of its custom
// VJP (fm_embed_terms, pallas_embed.py:199-209).  For ids, vals of shape
// [B, K], a table [F, D], x_bk = table[clamp(ids[b,k])] and upstream
// gradients g1, g2 of shape [B, D]:
//
//   forward:   s1[b] = sum_k vals[b,k] * x_bk
//              s2[b] = sum_k vals[b,k]^2 * x_bk^2
//   backward:  dvals[b,k]   = sum_d x_bk * (g1[b] + 2 v g2[b] x_bk)
//              dtable[r]   += v * (g1[b] + 2 v x_bk g2[b])     v = vals[b,k]
//
// Ids follow XLA (common.cuh): the forward clamps (clamp_id), the backward
// scatter drops what lies outside the table after one wrap (grad_row), as
// jnp's .at[ids].add does.
//
// What bounds it: bytes.  Forward: one D-float row per (b, k), two flops
// per element per sum; in practice the latency of the dependent loads (id,
// then row), so the design is about rows in flight.  Backward: the same
// rows plus g1 and g2, and the dense [F, D] gradient the caller zeroes
// (128 MiB at F = 2^20, D = 32, the floor of the call).
// Design:
//   * forward: the warp-per-row loop of warp_rows.cuh (shared with the
//     embed-bag forward) with both sums, FmSums below: a warp per row b,
//     the row's gathers in flight together, a fixed shuffle tree, a k split
//     at small B (the serving bucket, B 128).  Bit-equal from call to call.
//   * backward: one fused pass, a group of D/4 threads per entry (b, k) with
//     float4 loads when D % 4 == 0 and the rows are 16-byte aligned (D
//     threads without), as embed_bag_bwd in embed_bag.cu.  The gathered row
//     is read once for both terms; dvals is one shuffle reduction of the
//     combined sum, computed only when asked for and written for every entry
//     (no memset); each dtable element gets one atomicAdd of the combined
//     coefficient, +-0 adds skipped (add_nonzero), so padding entries (value
//     0) cost no atomics on row 0.
// The TPU kernel's 8-row blocks, SMEM scalar chunking and DMA ring are TPU
// artifacts and have no counterpart here.

#include "warp_rows.cuh"

namespace {

// ---------------------------------------------------------------- forward --

// Both FM sums of one entry, in the order the forward has always added them.
struct FmSums {
  static constexpr int N = 2;
  static __device__ __forceinline__ void add(float v, float x, float (&a)[2]) {
    a[0] += v * x;
    a[1] += (v * v) * (x * x);
  }
};

// --------------------------------------------------------------- backward --

// One group per entry e = b * K + k.  Every thread of a warp reaches the
// shuffle reduction (entries past the end only contribute 0), so the full
// mask is safe.
template <bool VEC4>
__global__ void fm_terms_bwd(const int* __restrict__ ids,
                             const float* __restrict__ vals,
                             const float* __restrict__ table,
                             const float* __restrict__ g1,
                             const float* __restrict__ g2,
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
    const float* xr = table + clamp_id(id, F) * D;
    const float* ar = g1 + b * D;
    const float* cr = g2 + b * D;
    const int64_t row = dtable ? grad_row(id, F) : -1;
    float* dr = row >= 0 ? dtable + row * D : nullptr;
    if (VEC4) {
      for (int c = lane; c < D / 4; c += group) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(xr) + c);
        const float4 a = __ldg(reinterpret_cast<const float4*>(ar) + c);
        const float4 g = __ldg(reinterpret_cast<const float4*>(cr) + c);
        // t = g1 + 2 v g2 x: dvals adds x * t, dtable gets v * t
        const float4 t = make_float4(a.x + 2.f * v * g.x * x.x,
                                     a.y + 2.f * v * g.y * x.y,
                                     a.z + 2.f * v * g.z * x.z,
                                     a.w + 2.f * v * g.w * x.w);
        if (dvals) part += x.x * t.x + x.y * t.y + x.z * t.z + x.w * t.w;
        if (dr) {
          float* p = dr + 4 * c;
          add_nonzero(p + 0, v * t.x);
          add_nonzero(p + 1, v * t.y);
          add_nonzero(p + 2, v * t.z);
          add_nonzero(p + 3, v * t.w);
        }
      }
    } else {
      for (int d = lane; d < D; d += group) {
        const float x = __ldg(xr + d);
        const float t = __ldg(ar + d) + 2.f * v * __ldg(cr + d) * x;
        if (dvals) part += x * t;
        if (dr) add_nonzero(dr + d, v * t);
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

}  // namespace

// s1 and s2 ([B, D]) are written in full.  vec4 != 0 requires D % 4 == 0
// and 16-byte aligned table, s1 and s2.  Returns a cudaError_t (0 =
// launched).
extern "C" int fm_terms_launch(const int* ids, const float* vals,
                               const float* table, float* s1, float* s2,
                               int B, int K, int F, int D, int vec4,
                               void* stream) {
  return launch_warp_rows<FmSums>(ids, vals, table, s1, s2, B, K, F, D,
                                  vec4, static_cast<cudaStream_t>(stream));
}

// dvals ([B, K], written in full) and dtable ([F, D], zeroed by the caller)
// may each be null when not wanted.  vec4 != 0 requires D % 4 == 0 and
// 16-byte aligned table, g1, g2 and dtable.  Returns a cudaError_t.
extern "C" int fm_terms_grad_launch(const int* ids, const float* vals,
                                    const float* table, const float* g1,
                                    const float* g2, float* dvals,
                                    float* dtable, int B, int K, int F, int D,
                                    int vec4, void* stream) {
  if (B <= 0 || K <= 0 || D <= 0) return 0;
  if (dvals == nullptr && dtable == nullptr) return 0;
  const int group = group_size(D, vec4);
  const int per_block = kThreads / group;
  const int64_t blocks = ((int64_t)B * K + per_block - 1) / per_block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    fm_terms_bwd<true><<<(unsigned)blocks, kThreads, 0, s>>>(
        ids, vals, table, g1, g2, dvals, dtable, B, K, F, D, group);
  } else {
    fm_terms_bwd<false><<<(unsigned)blocks, kThreads, 0, s>>>(
        ids, vals, table, g1, g2, dvals, dtable, B, K, F, D, group);
  }
  return cudaGetLastError();
}
