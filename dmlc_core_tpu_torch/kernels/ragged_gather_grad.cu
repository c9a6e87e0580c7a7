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
// Entries past nnz_used are never read into a result (garbage there never
// reaches one), as in the forward kernel.  The dense [F, D] gradient is
// zeroed here, by the launcher, so the caller allocates it uninitialised.
//
// What bounds it: bytes.  Each live entry reads one D-float row of g1 (and
// g2), the table row when it is needed (fm, or dvals asked for), and three
// 4-byte words; the dense [F, D] gradient has to be zeroed, which at F =
// 2^20, D = 32 is a 128 MiB write and the floor of the whole call.
// Two designs, chosen by a fixed rule on shape in the launcher:
//   * embed at D = 1 (the linear term's gradient, 4 MiB at F = 2^20): one
//     cooperative launch that zeroes dtable and then scatters into it, with
//     a grid-wide barrier between the two (blocks run in no order), so the
//     call is one launch instead of a memset and a kernel.  The grid is the
//     co-resident blocks, at most; a launch that does not fit fails, it is
//     never replaced by another path.  Each thread loads the segments, ids
//     and values of kOneEntries entries together, before the zero stores,
//     and their g1 (and table) words after them, so both round trips run
//     under the zeroing and the barrier; then it adds them, one atomicAdd
//     each.
//   * every other instance (fm, and embed at D > 1): a memset of dtable and
//     a group of D/4 threads per entry with float4 loads (D threads
//     without), rows added with atomicAdd (segments and ids need no order),
//     dvals reduced by shuffles inside the group.  At D = 32 the memset is
//     most of the call, so one launch would save little there.
// Both write dvals for every entry (no memset) and skip adds of +-0
// (dtable starts at +0), so padding entries of value 0 cost no atomics on
// row 0.

#include <cooperative_groups.h>

#include <algorithm>

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

// ------------------------------------------------ embed, D = 1: one launch --

constexpr int kOneThreads = 256;
constexpr int kOneEntries = 4;     // entries a thread loads before any add

// The entries i = first + e * stride (e < kOneEntries) of one thread, loaded
// in two round trips: segments, ids and values, then g1 (and x).
template <bool NEED_X>
struct OneBatch {
  int seg[kOneEntries], id[kOneEntries];
  float v[kOneEntries], a[kOneEntries], x[kOneEntries];

  __device__ __forceinline__ void load_entries(
      const int* __restrict__ ids, const int* __restrict__ segs,
      const float* __restrict__ vals, int64_t first, int64_t stride,
      int cap) {
#pragma unroll
    for (int e = 0; e < kOneEntries; ++e) {
      const int64_t i = first + e * stride;
      const bool in = i < cap;
      seg[e] = in ? __ldg(segs + i) : -1;
      id[e] = in ? __ldg(ids + i) : 0;
      v[e] = in ? __ldg(vals + i) : 0.f;
    }
  }

  // entries with a segment in [0, num_rows] read their g1 word (and x)
  __device__ __forceinline__ void load_rows(const float* __restrict__ table,
                                            const float* __restrict__ g1,
                                            int num_rows, int F) {
#pragma unroll
    for (int e = 0; e < kOneEntries; ++e) {
      const bool in = seg[e] >= 0 && seg[e] <= num_rows;
      a[e] = in ? __ldg(g1 + seg[e]) : 0.f;
      x[e] = (NEED_X && in) ? __ldg(table + clamp_id(id[e], F)) : 0.f;
    }
  }

  // dtable gets the live entries' v * g1r; dvals (if asked) every entry i <
  // cap: g1r * x when live, else 0
  __device__ __forceinline__ void apply(float* __restrict__ dvals,
                                        float* __restrict__ dtable,
                                        int64_t first, int64_t stride,
                                        int used, int cap, int num_rows,
                                        int F) const {
#pragma unroll
    for (int e = 0; e < kOneEntries; ++e) {
      const int64_t i = first + e * stride;
      if (i >= cap) continue;
      const bool live = i < used && seg[e] >= 0 && seg[e] <= num_rows;
      if (live && dtable) {
        const int64_t r = grad_row(id[e], F);
        if (r >= 0) add_nonzero(dtable + r, v[e] * a[e]);
      }
      if (dvals) dvals[i] = live ? a[e] * x[e] : 0.f;
    }
  }
};

// Phase 1 zeroes dtable ([F], 16-byte aligned) with float4 stores, phase 2
// adds into it; grid.sync() between them.  The grid must be co-resident
// (a cooperative launch).  dtable == null skips both the zeroing and the
// barrier (a uniform branch).
template <bool NEED_X>
__global__ void __launch_bounds__(kOneThreads)
ragged_grad_one(const int* __restrict__ ids, const int* __restrict__ segs,
                const float* __restrict__ vals,
                const int* __restrict__ nnz_used,
                const float* __restrict__ table,
                const float* __restrict__ g1, float* __restrict__ dvals,
                float* __restrict__ dtable, int cap, int num_rows, int F) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int used_raw = nnz_used ? __ldg(nnz_used) : cap;
  OneBatch<NEED_X> batch;
  batch.load_entries(ids, segs, vals, t, stride, cap);
  if (dtable) {
    float4* d4 = reinterpret_cast<float4*>(dtable);
    for (int64_t q = t; q < F / 4; q += stride) {
      d4[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int64_t q = (F / 4) * 4 + t; q < F; q += stride) dtable[q] = 0.f;
  }
  batch.load_rows(table, g1, num_rows, F);
  if (dtable) cooperative_groups::this_grid().sync();
  const int used = min(used_raw, cap);
  batch.apply(dvals, dtable, t, stride, used, cap, num_rows, F);
  // later batches: up to nnz_used, or to cap when every dvals is written
  const int64_t end = dvals ? cap : used;
  for (int64_t first = t + kOneEntries * stride; first < end;
       first += kOneEntries * stride) {
    batch.load_entries(ids, segs, vals, first, stride, cap);
    batch.load_rows(table, g1, num_rows, F);
    batch.apply(dvals, dtable, first, stride, used, cap, num_rows, F);
  }
}

// Blocks of ragged_grad_one<NEED_X> that fit on the current device at once,
// computed once per device (0 if the query fails).
template <bool NEED_X>
int one_coresident_blocks() {
  constexpr int kMaxDevices = 64;
  static int cached[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < kMaxDevices && cached[dev] > 0) return cached[dev];
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, ragged_grad_one<NEED_X>, kOneThreads, 0) != cudaSuccess) {
    return 0;
  }
  const int n = per_sm * sm_count();
  if (dev < kMaxDevices) cached[dev] = n;
  return n;
}

// One cooperative launch: as many blocks as give each thread kOneEntries
// entries, at least one per SM (so the zeroing uses every SM) and at most
// the co-resident ones.
template <bool NEED_X>
cudaError_t launch_one(const int* ids, const int* segs, const float* vals,
                       const int* nnz_used, const float* table,
                       const float* g1, float* dvals, float* dtable, int cap,
                       int num_rows, int F, cudaStream_t s) {
  if (reinterpret_cast<uintptr_t>(dtable) % 16 != 0) {
    return cudaErrorMisalignedAddress;
  }
  const int most = one_coresident_blocks<NEED_X>();
  if (most <= 0) return cudaErrorCooperativeLaunchTooLarge;
  const int64_t per_block = (int64_t)kOneThreads * kOneEntries;
  const int64_t want = ((int64_t)cap + per_block - 1) / per_block;
  const int blocks = (int)std::min<int64_t>(
      most, std::max<int64_t>(sm_count(), want));
  void* args[] = {&ids, &segs, &vals, &nnz_used, &table, &g1,
                  &dvals, &dtable, &cap, &num_rows, &F};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)ragged_grad_one<NEED_X>, dim3(blocks),
      dim3(kOneThreads), args, 0, s);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// -------------------------------------------- every other instance: memset --

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
// dvals ([cap], written in full) and dtable ([F, D], zeroed here: the caller
// may pass it uninitialised) may each be null when not wanted; nnz_used ==
// null means every entry is live.  vec4 != 0 requires D % 4 == 0 and
// 16-byte aligned table, g1, g2 and dtable; the D = 1 embed path needs a
// 16-byte aligned dtable.  The rule that picks a path: embed at D = 1 takes
// the one cooperative launch, everything else a memset and a kernel.
// Returns a cudaError_t (0 = launched).
extern "C" int ragged_gather_grad_launch(
    const int* ids, const int* segs, const float* vals, const int* nnz_used,
    const float* table, const float* g1, const float* g2, float* dvals,
    float* dtable, int cap, int num_rows, int F, int D, int vec4,
    void* stream) {
  if (D <= 0 || (dvals == nullptr && dtable == nullptr)) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g2 == nullptr && D == 1) {
    if (dvals != nullptr) {
      return launch_one<true>(ids, segs, vals, nnz_used, table, g1, dvals,
                              dtable, std::max(cap, 0), num_rows, F, s);
    }
    return launch_one<false>(ids, segs, vals, nnz_used, table, g1, nullptr,
                             dtable, std::max(cap, 0), num_rows, F, s);
  }
  if (dtable != nullptr) {
    const cudaError_t err =
        cudaMemsetAsync(dtable, 0, sizeof(float) * (size_t)F * D, s);
    if (err != cudaSuccess) return err;
  }
  if (cap <= 0) return 0;
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
