// Ragged CSR gather-accumulate for Hopper (sm_90a).
//
// Replaces dmlc_core_tpu/ops/ragged_csr.py::_ragged_gather_kernel (launched
// by _gather_pallas_one / _gather_pallas).  For every entry i < nnz_used:
//
//     out1[seg[i]] += vals[i] * table[ids[i]]
//     out2[seg[i]] += (vals[i] * table[ids[i]])^2      (fm variant only)
//
// Outputs are [num_rows + 1, D] and zero-initialised by the caller (one
// memset for both: the wrapper allocates them as one buffer); row
// num_rows is the scratch row of the padded layout.  Entries whose segment
// lies outside [0, num_rows] are dropped (jax.ops.segment_sum drops them).
// Ids follow XLA's gather (clamp_id in common.cuh).
//
// What bounds it: bytes, in principle.  Each live entry reads one D-float
// table row and three 4-byte words (id, segment, value) and does 2 (4 for
// fm) flops per table element, far below the card's flop rate.  In
// practice it is the latency of the dependent loads (index, then row) and
// the adds into the outputs.  Design, a segmented reduction over runs of
// equal segments (reduce-by-key):
//   * a warp owns a contiguous tile of entries and walks it in iterations
//     of E entries: one coalesced load of ids, segments and values per lane
//     (entries at or past nnz_used, or with an out-of-range segment, load
//     no row and reach nothing), then the table rows of U = 8 warp-steps
//     all issued before any is summed (WarpShape in common.cuh: 32 rows in
//     flight per warp at D = 32; 16 steps ran slower on the H100, the
//     scan's registers costing more occupancy than the depth gained);
//   * in a warp-step each group of G = D/4 lanes (float4; D lanes when the
//     rows are not 16-byte aligned, capped at 32 and looping over columns)
//     holds one entry.  The running sums live in registers, with one warp-
//     uniform current segment: while every entry of a step has that
//     segment, each group adds its entry into its own registers, no
//     shuffles; otherwise the groups' partials are combined, equal
//     neighbouring segments are merged by a shuffle-based segmented scan
//     (head flags where the segment changes), and the last run carries on
//     into the next step;
//   * a run reaches the output only when its segment changes or the tile
//     ends: one atomicAdd per element, a 16-byte float4 atomicAdd when the
//     rows are float4.  On the sorted segments the packers emit a row gets
//     one flush per tile it spans (one to three); on unsorted segments a
//     flush per entry.  The order of the flushes varies, so results are
//     allclose, not bit-equal, to the plain version.
//     A flush of +-0 is skipped (add_nonzero): the outputs start at +0 and
//     can never become -0, so padding entries (value 0) cost no atomics on
//     the scratch row; a NaN in a live entry still reaches its row;
//   * the launcher sizes the tiles from cap, in whole 32-entry words, so
//     the grid holds about 16 warps per SM: one word a warp at the serving
//     shape (cap 8192), two at the training shape (cap 131072).  Blocks
//     shrink, down to one warp, until a short grid covers every SM twice;
//   * nnz_used is read from device memory (null = the whole capacity): the
//     launch never waits on the host and stays capturable in a CUDA graph.
// Hopper's TMA has no row gather, so rows come in by ld.global; the U rows
// in flight fit in registers (ptxas counts are printed by the build).
// The TPU kernel's SMEM chunking and DMA ring are TPU artifacts and have no
// counterpart here.

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Args {
  const int* ids;
  const int* segs;
  const float* vals;
  const int* nnz_used;
  const float* table;
  float* out1;
  float* out2;
  int cap, num_rows, F, D, tile;
};

template <int W>
__device__ __forceinline__ void zero(float (&a)[W]) {
#pragma unroll
  for (int w = 0; w < W; ++w) a[w] = 0.0f;
}

// a += the same registers of every other group of the warp (xor tree).
template <int G, int W>
__device__ __forceinline__ void sum_groups(float (&a)[W]) {
#pragma unroll
  for (int off = G; off < 32; off <<= 1) {
#pragma unroll
    for (int w = 0; w < W; ++w) a[w] += __shfl_xor_sync(kFull, a[w], off);
  }
}

template <bool FM, int W>
__device__ __forceinline__ void flush(const Args& a, int seg, int col,
                                      const float (&c1)[W],
                                      const float (&c2)[W]) {
  const int64_t at = (int64_t)seg * a.D + (int64_t)col * W;
  add_nonzero<W>(a.out1 + at, c1);
  if (FM) add_nonzero<W>(a.out2 + at, c2);
}

template <bool FM, bool VEC4, int G>
__global__ void __launch_bounds__(kThreads)
ragged_gather_kernel(const Args a) {
  using S = WarpShape<G, 8>;
  constexpr int P = S::P, U = S::U, E = S::E, M = S::M;
  constexpr int W = VEC4 ? 4 : 1;
  const int lane = threadIdx.x & 31;
  const int g = lane / G;                 // this lane's entry in a step
  const int j = lane % G;                 // this lane's column in the group
  const int64_t t0 =
      ((int64_t)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32) * a.tile;
  const int used = a.nnz_used ? min(*a.nnz_used, a.cap) : a.cap;
  if (t0 >= used) return;                 // warp-uniform
  const int end = (int)min((int64_t)used, t0 + a.tile);
  const int ncols = VEC4 ? a.D / 4 : a.D;

  for (int c0 = 0; c0 < ncols; c0 += G) {
    const int col = c0 + j;
    const bool has_col = col < ncols;
    float acc1[W], acc2[W];                // this group's part of the run
    zero(acc1);
    zero(acc2);
    int cs = -1;                           // the run's segment, warp-uniform

    for (int base = (int)t0; base < end; base += E) {
      // ids, segments and values of the iteration's E entries, coalesced;
      // segment -1 marks an entry that reaches nothing
      int mid[M], mseg[M];
      float mval[M];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int e = base + m * 32 + lane;
        mid[m] = 0;
        mseg[m] = -1;
        mval[m] = 0.0f;
        if (m * 32 + lane < E && e < end) {  // three independent loads
          const int s = __ldg(a.segs + e);
          const int id = __ldg(a.ids + e);
          const float val = __ldg(a.vals + e);
          if (s >= 0 && s <= a.num_rows) {
            mseg[m] = s;
            mid[m] = id;
            mval[m] = val;
          }
        }
      }
      // every row of the U steps in flight before any is summed
      int seg[U];
      float v[U], x[U][W];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int slot = (u * P) >> 5, src = (u * P + g) & 31;
        seg[u] = __shfl_sync(kFull, mseg[slot], src);
        const int id = __shfl_sync(kFull, mid[slot], src);
        v[u] = __shfl_sync(kFull, mval[slot], src);
        if (seg[u] >= 0 && has_col) {
          load_row<W>(a.table + clamp_id(id, a.F) * a.D + (int64_t)col * W,
                      x[u]);
        } else {
          zero(x[u]);
          v[u] = 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float c1[W], c2[W];
#pragma unroll
        for (int w = 0; w < W; ++w) {
          c1[w] = x[u][w] * v[u];
          c2[w] = c1[w] * c1[w];
        }
        const int s = seg[u];
        if (__all_sync(kFull, s == cs)) {  // the run goes on in every group
#pragma unroll
          for (int w = 0; w < W; ++w) {
            acc1[w] += c1[w];
            if (FM) acc2[w] += c2[w];
          }
          continue;
        }
        // the run so far, whole, in every group
        sum_groups<G, W>(acc1);
        if (FM) sum_groups<G, W>(acc2);
        const int prev = __shfl_up_sync(kFull, s, G);
        const int next = __shfl_down_sync(kFull, s, G);
        if (g == 0) {
          if (s == cs) {                   // the step's first run extends it
#pragma unroll
            for (int w = 0; w < W; ++w) {
              c1[w] += acc1[w];
              c2[w] += acc2[w];
            }
          } else if (cs >= 0 && has_col) {
            flush<FM, W>(a, cs, col, acc1, acc2);
          }
        }
        // segmented inclusive scan over the step's groups
        int head = g == 0 || prev != s;
#pragma unroll
        for (int off = 1; off < P; off <<= 1) {
          float t1[W], t2[W];
#pragma unroll
          for (int w = 0; w < W; ++w) {
            t1[w] = __shfl_up_sync(kFull, c1[w], off * G);
            if (FM) t2[w] = __shfl_up_sync(kFull, c2[w], off * G);
          }
          const int th = __shfl_up_sync(kFull, head, off * G);
          if (g >= off) {
            if (!head) {
#pragma unroll
              for (int w = 0; w < W; ++w) {
                c1[w] += t1[w];
                if (FM) c2[w] += t2[w];
              }
            }
            head |= th;
          }
        }
        // runs that end inside the step are complete; the last carries on
        if (g < P - 1 && next != s && s >= 0 && has_col) {
          flush<FM, W>(a, s, col, c1, c2);
        }
#pragma unroll
        for (int w = 0; w < W; ++w) {
          acc1[w] = g == P - 1 ? c1[w] : 0.0f;
          acc2[w] = g == P - 1 ? c2[w] : 0.0f;
        }
        cs = __shfl_sync(kFull, s, 31);
      }
    }
    sum_groups<G, W>(acc1);
    if (FM) sum_groups<G, W>(acc2);
    if (g == 0 && cs >= 0 && has_col) flush<FM, W>(a, cs, col, acc1, acc2);
  }
}

template <bool FM, bool VEC4>
cudaError_t launch(Args a, cudaStream_t stream) {
  // tiles of whole 32-entry words, as many warps as ~16 per SM, and blocks
  // small enough that a short grid still spreads over every SM
  const int64_t sms = sm_count();
  const int64_t words = (a.cap + 31) / 32;
  const int64_t per = (words + 16 * sms - 1) / (16 * sms);
  a.tile = (int)(per * 32);
  const int64_t warps = (a.cap + a.tile - 1) / a.tile;
  int per_block = kWarps;
  while (per_block > 1 && warps < 2 * sms * per_block) per_block /= 2;
  const unsigned blocks = (unsigned)((warps + per_block - 1) / per_block);
  return with_group(group_size(a.D, VEC4), [&](auto gc) {
    constexpr int G = decltype(gc)::value;
    ragged_gather_kernel<FM, VEC4, G>
        <<<blocks, 32 * per_block, 0, stream>>>(a);
    return cudaGetLastError();
  });
}

}  // namespace

// out2 == nullptr selects the embed variant; nnz_used == nullptr means the
// whole capacity is live.  vec4 != 0 requires D % 4 == 0 and 16-byte
// aligned table and outputs.  Returns a cudaError_t (0 = launched).
extern "C" int ragged_gather_launch(const int* ids, const int* segs,
                                    const float* vals, const int* nnz_used,
                                    const float* table, float* out1,
                                    float* out2, int cap, int num_rows, int F,
                                    int D, int vec4, void* stream) {
  if (cap <= 0 || D <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{ids, segs, vals, nnz_used, table, out1, out2,
               cap, num_rows, F, D, 0};
  if (out2 != nullptr) {
    return vec4 ? launch<true, true>(a, s) : launch<true, false>(a, s);
  }
  return vec4 ? launch<false, true>(a, s) : launch<false, false>(a, s);
}
