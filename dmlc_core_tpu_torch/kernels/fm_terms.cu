// Row-major FM terms for Hopper (sm_90a), forward only.
//
// Replaces dmlc_core_tpu/ops/pallas_embed.py::_fm_kernel (launched by
// _fm_terms_pallas_one / fm_terms_pallas).  For ids, vals of shape [B, K]
// and a table [F, D]:
//
//     s1[b] = sum_k vals[b,k] * x_bk          x_bk = table[ids[b,k]]
//     s2[b] = sum_k vals[b,k]^2 * x_bk^2
//
// reading each gathered row once for both sums.  Ids follow XLA's gather:
// negative ids count from the end, then clamp into [0, F).
//
// What bounds it: bytes (one D-float row per (b, k), two flops per element
// per sum).  Design: one block per row b, threads over d, so each gathered
// table row is one coalesced read; the loop over k runs in order with s1
// and s2 in registers, so the result is deterministic and no atomics are
// needed.  The loop is unrolled so several rows' loads are in flight per
// thread.  The TPU kernel's 8-row blocks, SMEM scalar chunking and DMA ring
// are TPU artifacts and have no counterpart here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int64_t clamp_id(int id, int F) {
  int64_t r = id;
  if (r < 0) r += F;
  return r < 0 ? 0 : (r >= F ? F - 1 : r);
}

__global__ void fm_terms_kernel(const int* __restrict__ ids,
                                const float* __restrict__ vals,
                                const float* __restrict__ table,
                                float* __restrict__ s1,
                                float* __restrict__ s2, int K, int F, int D) {
  const int64_t b = blockIdx.x;
  const int* id_row = ids + b * K;
  const float* val_row = vals + b * K;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float a1 = 0.0f, a2 = 0.0f;
#pragma unroll 8
    for (int k = 0; k < K; ++k) {
      const float v = __ldg(val_row + k);
      const float x = __ldg(table + clamp_id(__ldg(id_row + k), F) * D + d);
      a1 += v * x;
      a2 += (v * v) * (x * x);
    }
    s1[b * D + d] = a1;
    s2[b * D + d] = a2;
  }
}

}  // namespace

// Returns a cudaError_t (0 = launched).
extern "C" int fm_terms_launch(const int* ids, const float* vals,
                               const float* table, float* s1, float* s2,
                               int B, int K, int F, int D, void* stream) {
  if (B <= 0 || D <= 0) return 0;
  int threads = ((D + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  fm_terms_kernel<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      ids, vals, table, s1, s2, K, F, D);
  return cudaGetLastError();
}
