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
// For the fm variant x comes from the entry's own id, so an id of -1 adds
// into row F - 1 a term built from table[0].  Entries past nnz_used are
// never read into a result (garbage there never reaches one), as in the
// forward kernel.  Every element of the dense [F, D] gradient is written
// here, so the caller allocates it uninitialised.
//
// What bounds it: bytes.  The dense gradient has to be written, F * D * 4
// bytes (168 MB at FFM's F = 2^18, D = 160; 2.7 GB at the CLI's FFM
// defaults), beside which each live entry's g1 row (and g2 and table rows
// for fm) and its 12 bytes are small.  Two designs, chosen by a fixed rule
// on shape in the launcher:
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
//   * every other instance (fm, and embed at D > 1): owner writes, each
//     gradient row stored exactly once, zeros included, with no memset of
//     dtable and no float atomic on a short row.  The backward is the
//     forward transposed: grouped by gradient row, a reduce-by-key.  Two
//     launches:
//       1. link, cooperative: zero the workspace (ws[r] = {count, head}
//          and touched[r], 9 bytes a row), a grid-wide barrier, then one
//          thread an entry: each live entry with r >= 0 joins row r's
//          list; the lanes of a warp that share a row join with one int
//          atomicAdd and one atomicExch, and mark the row touched.  Its
//          record (segment, id, value, next) goes to rec[i], 16 bytes.  A
//          row that passes kLong (32) entries is a long row (the padding
//          on row 0 in every flat batch, a hot id): the warp that makes it
//          one stores its zeros.
//       2. own, two kinds of block, the walk blocks first.  A zero block
//          stores zeros into untouched rows, reading a byte of touched[] a
//          row (a memset's stores behind few loads).  A walk block gives
//          each entry a group of D/4 float4 lanes (D lanes without
//          float4).  The group of the entry at the head of a short row's
//          list owns the row: it walks the list, sums the entries' shares
//          in registers from +0 and stores the row with float4 stores.
//          The group of an entry of a long row (never walked) adds its
//          shares into the zeroed row, one 16-byte atomicAdd(float4 *) a 4
//          columns (shares of +-0, the padding's, add nothing).
//     What it costs beyond the bound: the zero blocks' touched[] loads and
//     the link launch (a few microseconds at any size).  dvals, when asked
//     for, is a launch of its own, a group of lanes an entry (a dropped id
//     has a live segment, so its dvals is in no row's list).  Launch sizes
//     depend on cap, F and D alone and nothing waits on the host, so the
//     sequence runs inside a captured CUDA graph; the workspace (rec, ws,
//     touched) comes from the caller, who takes it from PyTorch's caching
//     allocator (ragged_gather_grad_workspace says how many bytes).
//     Without float4 (D % 4 != 0, or an unaligned pointer) the same passes
//     run a float a lane, and long rows add with one scalar atomicAdd a
//     column.
// Both designs write dvals for every entry i < cap.
//
// Order and tolerance: a row's list is built by atomics, so the order of
// its entries (and of a long row's atomics) varies from call to call, and
// so may the last bits of a sum: two calls are not held bit-equal, and the
// plain version is met within rtol = atol = 1e-5 (of the terms' sizes
// where they cancel, tests/test_torch_cuda.py).  Each share is rounded
// on its own before it is added (as the plain version's index_add_ adds
// it), a sum starts at +0 (so a row of +-0 shares is +0, as before), and a
// NaN in a live entry reaches its row.

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

// Blocks of kernel K (of `threads` threads) that fit on the current device
// at once: a cooperative launch's largest grid.  Computed once per device
// (0 if the query fails).
template <auto K>
int coresident_blocks(int threads) {
  constexpr int kMaxDevices = 64;
  static int cached[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < kMaxDevices && cached[dev] > 0) return cached[dev];
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, K, threads,
                                                    0) != cudaSuccess) {
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
  const int most = coresident_blocks<ragged_grad_one<NEED_X>>(kOneThreads);
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

// ------------------------------------- every other instance: owner writes --

constexpr int kThreads = 256;
constexpr int kLong = 32;         // a row with more entries is a long row
constexpr int kZeroRows = 2;      // rows a zeroing group stores

// one entry's share of a gradient element, each operation rounded as the
// plain version rounds it (v a + (((2 v) v) x) c, no fused multiply-add)
template <bool FM>
__device__ __forceinline__ float share(float v, float a, float c, float x) {
  if (!FM) return __fmul_rn(v, a);
  return __fadd_rn(__fmul_rn(v, a),
                   __fmul_rn(__fmul_rn(__fmul_rn(2.f * v, v), x), c));
}

// acc += the shares of one entry in W consecutive columns at offset q
template <bool FM, int W>
__device__ __forceinline__ void add_entry(float (&acc)[W], float v, int seg,
                                          int id, const float* __restrict__ g1,
                                          const float* __restrict__ g2,
                                          const float* __restrict__ table,
                                          int F, int D, int q) {
  float a[W], c[W] = {}, x[W] = {};
  load_row<W>(g1 + (int64_t)seg * D + q, a);
  if constexpr (FM) {
    load_row<W>(g2 + (int64_t)seg * D + q, c);
    load_row<W>(table + clamp_id(id, F) * D + q, x);
  }
#pragma unroll
  for (int w = 0; w < W; ++w) {
    acc[w] = __fadd_rn(acc[w], share<FM>(v, a[w], c[w], x[w]));
  }
}

template <int W>
__device__ __forceinline__ void store_cols(float* p, const float (&x)[W]) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *p = x[0];
  }
}

// 1. link, one cooperative launch.  Phase 1 zeroes ws and touched (9 F
// bytes, 16-byte aligned); after a grid-wide barrier, phase 2 takes the
// entries in warps of 32 consecutive ones: rec[i] for every i < nnz_used is
// {segment, id, value bits, next entry of the row + 1 (0 ends the list)},
// segment -1 when the entry is in no list (not live, or its id dropped);
// touched[r] = 1 for every row with a list.  The warp whose entries take a
// row past kLong entries stores the row's zeros, so a long row is zeroed
// before the next launch adds into it.
__global__ void __launch_bounds__(kThreads)
link_entries(const int* __restrict__ ids, const int* __restrict__ segs,
             const float* __restrict__ vals,
             const int* __restrict__ nnz_used, int4* __restrict__ rec,
             int2* ws, uint8_t* touched, float* __restrict__ dtable, int cap,
             int num_rows, int F, int D, int vec4) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int used = nnz_used ? min(__ldg(nnz_used), cap) : cap;
  // the first entry's words load under the zeroing and the barrier
  int seg = -1, id = 0;
  float v = 0.f;
  if (t < used) {
    seg = __ldg(segs + t);
    id = __ldg(ids + t);
    v = __ldg(vals + t);
  }
  const int64_t nbytes = 9 * (int64_t)F;
  int4* z4 = reinterpret_cast<int4*>(ws);
  for (int64_t q = t; q < nbytes / 16; q += stride) {
    z4[q] = make_int4(0, 0, 0, 0);
  }
  uint8_t* z1 = reinterpret_cast<uint8_t*>(ws);
  for (int64_t q = nbytes / 16 * 16 + t; q < nbytes; q += stride) z1[q] = 0;
  cooperative_groups::this_grid().sync();

  for (int64_t base = t - lane; base < used; base += stride) {
    const int64_t i = base + lane;
    if (base != t - lane) {
      seg = -1, id = 0, v = 0.f;
      if (i < used) {
        seg = __ldg(segs + i);
        id = __ldg(ids + i);
        v = __ldg(vals + i);
      }
    }
    int key = -1;
    if (i < used) {
      const int64_t r = grad_row(id, F);
      if (seg >= 0 && seg <= num_rows && r >= 0) key = (int)r;
    }
    // the lanes bound for the same row join its list together: head ->
    // lowest lane -> ... -> highest lane -> the old head
    const unsigned same = __match_any_sync(0xffffffffu, key);
    if (key < 0) {
      if (i < used) rec[i] = make_int4(-1, id, 0, 0);
      continue;
    }
    const int leader = __ffs(same) - 1;
    int old = 0;
    if (lane == leader) {
      const int n = __popc(same);
      const int before = atomicAdd(&ws[key].x, n);
      old = atomicExch(&ws[key].y, (int)(i + 1));
      touched[key] = 1;
      if (before <= kLong && before + n > kLong) {    // now a long row
        float* out = dtable + (int64_t)key * D;
        if (vec4) {
          for (int q = 0; q < D; q += 4) {
            *reinterpret_cast<float4*>(out + q) =
                make_float4(0.f, 0.f, 0.f, 0.f);
          }
        } else {
          for (int q = 0; q < D; ++q) out[q] = 0.f;
        }
      }
    }
    old = __shfl_sync(same, old, leader);
    const unsigned above = same & ~((2u << lane) - 1u);
    const int next = above ? (int)(i - lane + __ffs(above)) : old;
    rec[i] = make_int4(seg, id, __float_as_int(v), next);
  }
}

// 2. own: one launch of two kinds of block.  The walk blocks come first
// (their latency then runs under the zero blocks' stores): a walk block
// gives each entry a group of G lanes.  A zero block stores zeros into the
// rows no entry touched, a group a row, kZeroRows rows a group (a byte of
// touched[] a row: a memset's stores behind few loads).  The group of
// the entry at the head of a short row's list stores the row: it walks the
// list and sums it (lane l holds columns (base + k G + l) W, k < KT, for
// base = 0, G KT, ...).  The group of an entry of a long row (zeroed by
// link) adds the entry's shares, one atomic a W columns.  Together they
// store each row once.
template <bool FM, int W, int KT>
__global__ void __launch_bounds__(kThreads)
own_rows(const int4* __restrict__ rec, const int2* __restrict__ ws,
         const uint8_t* __restrict__ touched,
         const int* __restrict__ nnz_used, const float* __restrict__ table,
         const float* __restrict__ g1, const float* __restrict__ g2,
         float* __restrict__ dtable, int cap, int F, int D, int G,
         int walk_blocks) {
  const int lane = threadIdx.x % G;
  const int DW = D / W;
  const bool zeroing = (int)blockIdx.x >= walk_blocks;
  const int64_t t =
      (int64_t)(blockIdx.x - (zeroing ? walk_blocks : 0)) * blockDim.x +
      threadIdx.x;
  if (zeroing) {
    const float zero[W] = {};
    const int64_t r0 = t / G * kZeroRows;
    bool z[kZeroRows];
#pragma unroll
    for (int j = 0; j < kZeroRows; ++j) {
      z[j] = r0 + j < F && __ldg(touched + r0 + j) == 0;
    }
#pragma unroll
    for (int j = 0; j < kZeroRows; ++j) {
      if (!z[j]) continue;
      float* out = dtable + (r0 + j) * D;
      for (int q = lane; q < DW; q += G) store_cols<W>(out + q * W, zero);
    }
    return;
  }
  const int64_t i = t / G;
  const int used = nnz_used ? min(__ldg(nnz_used), cap) : cap;
  if (i >= used) return;
  const int4 first = __ldg(rec + i);
  if (first.x < 0) return;
  const int64_t r = grad_row(first.y, F);
  const int2 cr = __ldg(ws + r);
  float* out = dtable + r * D;
  // acc[k] += the shares of entry e in the columns of tile `base`
  auto add = [&](float (&acc)[KT][W], const int4& e, int base) {
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      const int q = base + k * G;
      if (q < DW) {
        add_entry<FM, W>(acc[k], __int_as_float(e.z), e.x, e.y, g1, g2,
                         table, F, D, q * W);
      }
    }
  };
  // a row of one tile (KT = 1): the first entry's rows load under ws[r]'s
  float acc0[KT][W] = {};
  if (KT == 1) add(acc0, first, lane);
  // acc = the first entry's shares in tile `base`
  auto start = [&](float (&acc)[KT][W], int base) {
#pragma unroll
    for (int k = 0; k < KT; ++k) {
#pragma unroll
      for (int w = 0; w < W; ++w) acc[k][w] = KT == 1 ? acc0[k][w] : 0.f;
    }
    if (KT != 1) add(acc, first, base);
  };
  if (cr.x > kLong) {
    for (int base = lane; base < DW; base += G * KT) {
      float acc[KT][W];
      start(acc, base);
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        const int q = base + k * G;
        if (q < DW) add_nonzero<W>(out + q * W, acc[k]);
      }
    }
    return;
  }
  if (cr.y != i + 1) return;
  for (int base = lane; base < DW; base += G * KT) {
    float acc[KT][W];
    start(acc, base);
    for (int nxt = first.w; nxt != 0;) {
      const int4 e = __ldg(rec + nxt - 1);
      nxt = e.w;
      add(acc, e, base);
    }
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      const int q = base + k * G;
      if (q < DW) store_cols<W>(out + q * W, acc[k]);
    }
  }
}

// dvals alone: a group of G lanes an entry (D / 4 with float4 loads, D
// without), its terms reduced by shuffles inside the group.
template <bool FM, bool VEC4>
__global__ void entry_dvals(const int* __restrict__ ids,
                            const int* __restrict__ segs,
                            const float* __restrict__ vals,
                            const int* __restrict__ nnz_used,
                            const float* __restrict__ table,
                            const float* __restrict__ g1,
                            const float* __restrict__ g2,
                            float* __restrict__ dvals, int cap, int num_rows,
                            int F, int D, int group) {
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
    const float v = vals[i];
    const float* a = g1 + (int64_t)seg * D;
    const float* c = FM ? g2 + (int64_t)seg * D : nullptr;
    const float* xr = table + clamp_id(ids[i], F) * D;
    if (VEC4) {
      for (int q = lane; q < D / 4; q += group) {
        const float4 av = __ldg(reinterpret_cast<const float4*>(a) + q);
        float4 cv = make_float4(0.f, 0.f, 0.f, 0.f);
        if (FM) cv = __ldg(reinterpret_cast<const float4*>(c) + q);
        const float4 x = __ldg(reinterpret_cast<const float4*>(xr) + q);
        element<FM>(x.x, v, av.x, cv.x, &part);
        element<FM>(x.y, v, av.y, cv.y, &part);
        element<FM>(x.z, v, av.z, cv.z, &part);
        element<FM>(x.w, v, av.w, cv.w, &part);
      }
    } else {
      for (int d = lane; d < D; d += group) {
        element<FM>(__ldg(xr + d), v, __ldg(a + d), FM ? __ldg(c + d) : 0.f,
                    &part);
      }
    }
  }
  for (int off = group / 2; off > 0; off >>= 1) {
    part += __shfl_xor_sync(0xffffffffu, part, off, group);
  }
  if (i < cap && lane == 0) dvals[i] = live ? part : 0.f;
}

template <bool FM>
cudaError_t launch_dvals(const int* ids, const int* segs, const float* vals,
                         const int* nnz_used, const float* table,
                         const float* g1, const float* g2, float* dvals,
                         int cap, int num_rows, int F, int D, int vec4,
                         cudaStream_t s) {
  const int threads = 128;
  const int group = group_size(D, vec4);
  const int per_block = threads / group;
  const int blocks = (cap + per_block - 1) / per_block;
  if (vec4) {
    entry_dvals<FM, true><<<blocks, threads, 0, s>>>(
        ids, segs, vals, nnz_used, table, g1, g2, dvals, cap, num_rows, F, D,
        group);
  } else {
    entry_dvals<FM, false><<<blocks, threads, 0, s>>>(
        ids, segs, vals, nnz_used, table, g1, g2, dvals, cap, num_rows, F, D,
        group);
  }
  return cudaGetLastError();
}

// own_rows with the fewest KT (1, 2 or 8) that covers a row in one tile
// where one does.
template <bool FM, int W>
cudaError_t launch_own(const int4* rec, const int2* ws,
                       const uint8_t* touched, const int* nnz_used,
                       const float* table, const float* g1, const float* g2,
                       float* dtable, int cap, int F, int D, int G,
                       cudaStream_t s) {
  const int tiles = (D / W + G - 1) / G;
  const int per_block = kThreads / G;
  const int walk = (int)(((int64_t)cap + per_block - 1) / per_block);
  const int64_t zero_rows = (int64_t)per_block * kZeroRows;
  const int64_t zero = (F + zero_rows - 1) / zero_rows;
  const int64_t blocks = zero + walk;
  if (blocks >= (int64_t)1 << 31) return cudaErrorInvalidValue;
  if (tiles <= 1) {
    own_rows<FM, W, 1><<<(int)blocks, kThreads, 0, s>>>(
        rec, ws, touched, nnz_used, table, g1, g2, dtable, cap, F, D, G,
        walk);
  } else if (tiles <= 2) {
    own_rows<FM, W, 2><<<(int)blocks, kThreads, 0, s>>>(
        rec, ws, touched, nnz_used, table, g1, g2, dtable, cap, F, D, G,
        walk);
  } else {
    own_rows<FM, W, 8><<<(int)blocks, kThreads, 0, s>>>(
        rec, ws, touched, nnz_used, table, g1, g2, dtable, cap, F, D, G,
        walk);
  }
  return cudaGetLastError();
}

// The cooperative link, then own_rows.  The link's grid is two blocks an
// SM (its barrier costs more with more blocks; two keep its zeroing at the
// memory's rate), at most the co-resident ones; a link that does not fit
// fails, nothing replaces it.
template <bool FM>
cudaError_t launch_owned(const int* ids, const int* segs, const float* vals,
                         const int* nnz_used, const float* table,
                         const float* g1, const float* g2, float* dtable,
                         void* work, int cap, int num_rows, int F, int D,
                         int vec4, cudaStream_t s) {
  int4* rec = static_cast<int4*>(work);
  int2* ws = reinterpret_cast<int2*>(static_cast<char*>(work) +
                                     16 * (size_t)cap);
  uint8_t* touched = reinterpret_cast<uint8_t*>(ws + F);
  const int most = coresident_blocks<link_entries>(kThreads);
  if (most <= 0) return cudaErrorCooperativeLaunchTooLarge;
  const int blocks = std::min(most, 2 * sm_count());
  void* args[] = {&ids, &segs, &vals, &nnz_used, &rec, &ws, &touched,
                  &dtable, &cap, &num_rows, &F, &D, &vec4};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)link_entries, dim3(blocks), dim3(kThreads), args, 0, s);
  const cudaError_t last = cudaGetLastError();
  if (err == cudaSuccess) err = last;
  if (err != cudaSuccess) return err;
  const int G = group_size(D, vec4);
  if (vec4) {
    return launch_own<FM, 4>(rec, ws, touched, nnz_used, table, g1, g2,
                             dtable, cap, F, D, G, s);
  }
  return launch_own<FM, 1>(rec, ws, touched, nnz_used, table, g1, g2, dtable,
                           cap, F, D, G, s);
}

}  // namespace

// Bytes of workspace ragged_gather_grad_launch needs for these arguments
// (0: none): 16 an entry (its record) and 9 a gradient row ({count, head}
// and its touched byte) when dtable is asked for at D > 1 or for the fm
// variant.
extern "C" long long ragged_gather_grad_workspace(int cap, int F, int D,
                                                  int fm, int need_dtable) {
  if (!need_dtable || D <= 0 || (!fm && D == 1)) return 0;
  return 16LL * std::max(cap, 0) + 9LL * std::max(F, 0);
}

// g1 (and g2, whose presence selects the fm variant) are [num_rows + 1, D].
// dvals ([cap], written in full) and dtable ([F, D], written in full: the
// caller may pass it uninitialised) may each be null when not wanted;
// nnz_used == null means every entry is live.  work holds
// ragged_gather_grad_workspace(...) bytes, 16-byte aligned (null when that
// is 0).  vec4 != 0 requires D % 4 == 0 and 16-byte aligned table, g1, g2
// and dtable; the D = 1 embed path needs a 16-byte aligned dtable.  The
// rule that picks a path: embed at D = 1 takes the one cooperative launch,
// everything else owner writes (a cooperative launch and a kernel).
// Returns a cudaError_t (0 = launched).
extern "C" int ragged_gather_grad_launch(
    const int* ids, const int* segs, const float* vals, const int* nnz_used,
    const float* table, const float* g1, const float* g2, float* dvals,
    float* dtable, void* work, int cap, int num_rows, int F, int D, int vec4,
    void* stream) {
  if (D <= 0 || (dvals == nullptr && dtable == nullptr)) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cap = std::max(cap, 0);
  if (g2 == nullptr && D == 1) {
    if (dvals != nullptr) {
      return launch_one<true>(ids, segs, vals, nnz_used, table, g1, dvals,
                              dtable, cap, num_rows, F, s);
    }
    return launch_one<false>(ids, segs, vals, nnz_used, table, g1, nullptr,
                             dtable, cap, num_rows, F, s);
  }
  if (dvals != nullptr && cap > 0) {
    const cudaError_t err =
        g2 != nullptr
            ? launch_dvals<true>(ids, segs, vals, nnz_used, table, g1, g2,
                                 dvals, cap, num_rows, F, D, vec4, s)
            : launch_dvals<false>(ids, segs, vals, nnz_used, table, g1,
                                  nullptr, dvals, cap, num_rows, F, D, vec4,
                                  s);
    if (err != cudaSuccess) return err;
  }
  if (dtable == nullptr) return 0;
  if (work == nullptr || reinterpret_cast<uintptr_t>(work) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  if (g2 != nullptr) {
    return launch_owned<true>(ids, segs, vals, nnz_used, table, g1, g2,
                              dtable, work, cap, num_rows, F, D, vec4, s);
  }
  return launch_owned<false>(ids, segs, vals, nnz_used, nullptr, g1, nullptr,
                             dtable, work, cap, num_rows, F, D, vec4, s);
}
