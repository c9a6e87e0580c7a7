// Backward of the ragged CSR gather-accumulate for Hopper (sm_90a).
//
// Replaces the backward of dmlc_core_tpu/ops/ragged_csr.py::
// _ragged_gather_kernel: XLA's autodiff of the segment sums in ops/csr.py
// and ops/ragged_csr.py, and ragged_embed_grad (ragged_csr.py:348-369).
// For every live entry i (i < nnz_used and seg = segs[i] in [0, num_rows]),
// with x = table[clamp(ids[i])], v = vals[i], g1r = g1[seg], g2r = g2[seg]:
//
//   embed:  dtable[r] += v * g1r              dvals[i] = sum_d g1r * x
//   fm:     dtable[r] += v * g1r + 2 v^2 x g2r
//           dvals[i]   = sum_d (g1r * x + 2 v g2r x^2)
//
// and dvals[i] = 0 for every other entry.  r follows jnp's scatter-add
// (grad_row in common.cuh): the entry is dropped unless r is in [0, F).
// Entries past nnz_used are never read (garbage there never reaches a
// result), as in the forward kernel.
//
// What bounds it: bytes.  Each live entry reads one D-float row of g1 (and
// g2), the table row when it is needed (fm, or dvals asked for), and three
// 4-byte words; the dense [F, D] gradient is zeroed by the caller, which at
// F = 2^20, D = 32 is a 128 MiB write and the floor of the whole call.
// Design: a group of D/4 threads per entry with float4 loads (D threads
// without), rows added into dtable with atomicAdd (segments and ids need
// no order), dvals reduced by shuffles inside the group and written for
// every entry (no memset).  Adds of +-0 are skipped (dtable starts at +0),
// so padding entries of value 0 cost no atomics on row 0.

#include "common.cuh"

namespace {

// one element's share: its dtable coefficient and its dvals term
template <bool FM>
__device__ __forceinline__ float element(float x, float v, float a, float c,
                                         float* dv) {
  // a = g1r[d], c = g2r[d]
  if (FM) {
    *dv += a * x + 2.f * v * c * x * x;
    return v * a + 2.f * v * v * x * c;
  }
  *dv += a * x;
  return v * a;
}

template <bool FM, bool VEC4, bool NEED_X>
__global__ void ragged_gather_bwd(const int* __restrict__ ids,
                                  const int* __restrict__ segs,
                                  const float* __restrict__ vals,
                                  const int* __restrict__ nnz_used,
                                  const float* __restrict__ table,
                                  const float* __restrict__ g1,
                                  const float* __restrict__ g2,
                                  float* __restrict__ dvals,
                                  float* __restrict__ dtable, int cap,
                                  int num_rows, int F, int D, int group) {
  const int per_block = blockDim.x / group;
  const int i = blockIdx.x * per_block + threadIdx.x / group;
  const int lane = threadIdx.x % group;
  const int used = nnz_used ? min(*nnz_used, cap) : cap;
  bool live = i < used;
  int seg = 0;
  if (live) {
    seg = segs[i];
    live = seg >= 0 && seg <= num_rows;
  }
  float part = 0.f;
  if (live) {
    const int id = ids[i];
    const float v = vals[i];
    const float* a = g1 + (int64_t)seg * D;
    const float* c = FM ? g2 + (int64_t)seg * D : nullptr;
    const float* xr = table + clamp_id(id, F) * D;
    const int64_t row = dtable ? grad_row(id, F) : -1;
    float* dr = row >= 0 ? dtable + row * D : nullptr;
    if (VEC4) {
      for (int q = lane; q < D / 4; q += group) {
        const float4 av = __ldg(reinterpret_cast<const float4*>(a) + q);
        float4 cv = make_float4(0.f, 0.f, 0.f, 0.f);
        if (FM) cv = __ldg(reinterpret_cast<const float4*>(c) + q);
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (NEED_X) x = __ldg(reinterpret_cast<const float4*>(xr) + q);
        const float t0 = element<FM>(x.x, v, av.x, cv.x, &part);
        const float t1 = element<FM>(x.y, v, av.y, cv.y, &part);
        const float t2 = element<FM>(x.z, v, av.z, cv.z, &part);
        const float t3 = element<FM>(x.w, v, av.w, cv.w, &part);
        if (dr) {
          float* p = dr + 4 * q;
          add_nonzero(p + 0, t0);
          add_nonzero(p + 1, t1);
          add_nonzero(p + 2, t2);
          add_nonzero(p + 3, t3);
        }
      }
    } else {
      for (int d = lane; d < D; d += group) {
        const float x = NEED_X ? __ldg(xr + d) : 0.f;
        const float t = element<FM>(x, v, __ldg(a + d),
                                    FM ? __ldg(c + d) : 0.f, &part);
        if (dr) add_nonzero(dr + d, t);
      }
    }
  }
  if (dvals) {
    for (int off = group / 2; off > 0; off >>= 1) {
      part += __shfl_xor_sync(0xffffffffu, part, off, group);
    }
    if (i < cap && lane == 0) dvals[i] = live ? part : 0.f;
  }
}

template <bool FM, bool NEED_X>
cudaError_t launch(const int* ids, const int* segs, const float* vals,
                   const int* nnz_used, const float* table, const float* g1,
                   const float* g2, float* dvals, float* dtable, int cap,
                   int num_rows, int F, int D, int vec4, cudaStream_t s) {
  const int threads = 128;
  const int group = group_size(D, vec4);
  const int per_block = threads / group;
  const int blocks = (cap + per_block - 1) / per_block;
  if (vec4) {
    ragged_gather_bwd<FM, true, NEED_X><<<blocks, threads, 0, s>>>(
        ids, segs, vals, nnz_used, table, g1, g2, dvals, dtable, cap,
        num_rows, F, D, group);
  } else {
    ragged_gather_bwd<FM, false, NEED_X><<<blocks, threads, 0, s>>>(
        ids, segs, vals, nnz_used, table, g1, g2, dvals, dtable, cap,
        num_rows, F, D, group);
  }
  return cudaGetLastError();
}

}  // namespace

// g1 (and g2, whose presence selects the fm variant) are [num_rows + 1, D].
// dvals ([cap], written in full) and dtable ([F, D], zeroed by the caller)
// may each be null when not wanted; nnz_used == null means every entry is
// live.  vec4 != 0 requires D % 4 == 0 and 16-byte aligned table, g1, g2 and
// dtable.  Returns a cudaError_t (0 = launched).
extern "C" int ragged_gather_grad_launch(
    const int* ids, const int* segs, const float* vals, const int* nnz_used,
    const float* table, const float* g1, const float* g2, float* dvals,
    float* dtable, int cap, int num_rows, int F, int D, int vec4,
    void* stream) {
  if (cap <= 0 || D <= 0) return 0;
  if (dvals == nullptr && dtable == nullptr) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g2 != nullptr) {
    return launch<true, true>(ids, segs, vals, nnz_used, table, g1, g2, dvals,
                              dtable, cap, num_rows, F, D, vec4, s);
  }
  if (dvals != nullptr) {
    return launch<false, true>(ids, segs, vals, nnz_used, table, g1, nullptr,
                               dvals, dtable, cap, num_rows, F, D, vec4, s);
  }
  return launch<false, false>(ids, segs, vals, nnz_used, table, g1, nullptr,
                              nullptr, dtable, cap, num_rows, F, D, vec4, s);
}
