// Ragged CSR gather-accumulate for Hopper (sm_90a).
//
// Replaces dmlc_core_tpu/ops/ragged_csr.py::_ragged_gather_kernel (launched
// by _gather_pallas_one / _gather_pallas).  For every entry i < nnz_used:
//
//     out1[seg[i]] += vals[i] * table[ids[i]]
//     out2[seg[i]] += (vals[i] * table[ids[i]])^2      (fm variant only)
//
// Outputs are [num_rows + 1, D] and zero-initialised by the caller; row
// num_rows is the scratch row of the padded layout.  Entries whose segment
// lies outside [0, num_rows] are dropped (jax.ops.segment_sum drops them).
// Ids follow XLA's gather (clamp_id in common.cuh).
//
// What bounds it: bytes.  Each live entry reads one D-float table row,
// three 4-byte words (id, segment, value) and does 2 (4 for fm) flops per
// table element, far below the card's flop rate.  Design:
//   * a group of threads per entry, each thread loading 16 bytes (float4)
//     when D % 4 == 0 and the table is 16-byte aligned, so one table row is
//     one coalesced read; the group is D/4 threads (8 for D = 32), so a warp
//     fetches several rows at once and many rows are in flight per SM;
//   * nnz_used is read from device memory (null = the whole capacity): the
//     launch never waits on the host and stays capturable in a CUDA graph;
//     entries past it cost no load and no flop;
//   * segments need not be sorted: each entry adds into its row with
//     atomicAdd, resolved in L2.  The order of the adds varies, so results
//     are allclose, not bit-equal, to the plain version — as the Pallas
//     kernel is only allclose to its XLA twin.
//     An add of +-0 is skipped: the accumulators start at +0 and can never
//     become -0, so such an add never changes them; padding entries (value
//     0) therefore cost no atomics on the scratch row.
// The TPU kernel's SMEM chunking and DMA ring are TPU artifacts and have no
// counterpart here.

#include "common.cuh"

namespace {

template <bool FM>
__device__ __forceinline__ void accumulate(float* o1, float* o2, float x,
                                           float v) {
  const float vx = x * v;
  add_nonzero(o1, vx);
  if (FM) add_nonzero(o2, vx * vx);
}

template <bool FM, bool VEC4>
__global__ void ragged_gather_kernel(const int* __restrict__ ids,
                                     const int* __restrict__ segs,
                                     const float* __restrict__ vals,
                                     const int* __restrict__ nnz_used,
                                     const float* __restrict__ table,
                                     float* __restrict__ out1,
                                     float* __restrict__ out2, int cap,
                                     int num_rows, int F, int D, int group) {
  const int per_block = blockDim.x / group;
  const int i = blockIdx.x * per_block + threadIdx.x / group;
  const int lane = threadIdx.x % group;
  const int used = nnz_used ? min(*nnz_used, cap) : cap;
  if (i >= used) return;
  const int seg = segs[i];
  if (seg < 0 || seg > num_rows) return;
  const float v = vals[i];
  const int64_t row = clamp_id(ids[i], F);
  float* o1 = out1 + (int64_t)seg * D;
  float* o2 = FM ? out2 + (int64_t)seg * D : nullptr;
  if (VEC4) {
    const float4* src = reinterpret_cast<const float4*>(table + row * D);
    for (int c = lane; c < D / 4; c += group) {
      const float4 x = __ldg(src + c);
      const int d = 4 * c;
      accumulate<FM>(o1 + d + 0, FM ? o2 + d + 0 : nullptr, x.x, v);
      accumulate<FM>(o1 + d + 1, FM ? o2 + d + 1 : nullptr, x.y, v);
      accumulate<FM>(o1 + d + 2, FM ? o2 + d + 2 : nullptr, x.z, v);
      accumulate<FM>(o1 + d + 3, FM ? o2 + d + 3 : nullptr, x.w, v);
    }
  } else {
    const float* src = table + row * D;
    for (int d = lane; d < D; d += group) {
      accumulate<FM>(o1 + d, FM ? o2 + d : nullptr, __ldg(src + d), v);
    }
  }
}

template <bool FM>
cudaError_t launch(const int* ids, const int* segs, const float* vals,
                   const int* nnz_used, const float* table, float* out1,
                   float* out2, int cap, int num_rows, int F, int D, int vec4,
                   cudaStream_t stream) {
  const int threads = 256;
  const int group = group_size(D, vec4);
  const int per_block = threads / group;
  const int blocks = (cap + per_block - 1) / per_block;
  if (vec4) {
    ragged_gather_kernel<FM, true><<<blocks, threads, 0, stream>>>(
        ids, segs, vals, nnz_used, table, out1, out2, cap, num_rows, F, D,
        group);
  } else {
    ragged_gather_kernel<FM, false><<<blocks, threads, 0, stream>>>(
        ids, segs, vals, nnz_used, table, out1, out2, cap, num_rows, F, D,
        group);
  }
  return cudaGetLastError();
}

}  // namespace

// out2 == nullptr selects the embed variant; nnz_used == nullptr means the
// whole capacity is live.  Returns a cudaError_t (0 = launched).
extern "C" int ragged_gather_launch(const int* ids, const int* segs,
                                    const float* vals, const int* nnz_used,
                                    const float* table, float* out1,
                                    float* out2, int cap, int num_rows, int F,
                                    int D, int vec4, void* stream) {
  if (cap <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out2 != nullptr) {
    return launch<true>(ids, segs, vals, nnz_used, table, out1, out2, cap,
                        num_rows, F, D, vec4, s);
  }
  return launch<false>(ids, segs, vals, nnz_used, table, out1, nullptr, cap,
                       num_rows, F, D, vec4, s);
}
