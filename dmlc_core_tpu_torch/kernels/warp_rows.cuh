// The warp-per-row weighted gather-sum that the fm-terms forward
// (fm_terms.cu) and the embed-bag forward (embed_bag.cu) share.  For ids,
// vals of shape [B, K], a table [F, D] and x_bk = table[clamp(ids[b,k])],
// it writes one or two [B, D] sums, as the policy SUM says:
//
//   fm terms:           s1[b]  = sum_k v x        s2[b] = sum_k v^2 x^2
//   embed bag:          out[b] = sum_k v x
//   embed bag, square:  out[b] = sum_k v x^2
//
// SUM has N (the number of sums) and add(v, x, a), which adds one entry's
// terms into a[0 .. N-1]; each .cu defines its own.
//
// What bounds it: bytes, one D-float row per (b, k); in practice the
// latency of the dependent loads (id, then row), so the design is about
// rows in flight:
//   * one warp per row b, several rows per 256-thread block.  The warp
//     loads the row's ids and values with coalesced loads, E at a time
//     (WarpShape in common.cuh), and splits into 32/G groups of G = D/4
//     lanes (float4; D lanes, capped at 32 and looping over columns, when
//     the rows are not 16-byte aligned).  Group j takes k = j mod 32/G and
//     issues the row loads of U = 16 such k before it sums any, so at D =
//     32 a row's 64 gathers are in flight at once: one round trip for the
//     ids and one for the rows, not K/8 x 2 (16 k a group ran faster than
//     8 for the fm terms at B 4096 on the H100).
//   * every entry is summed, padding included (a padding entry multiplies
//     table row 0 by 0, which matters if that row holds inf or NaN, as in
//     the JAX forward); ids are clamped (clamp_id).
//   * the groups' partial sums meet in a fixed xor shuffle tree and are
//     written as float4, so the output needs no memset.  When B alone
//     leaves the card short of about eight warps per SM (B 128), the
//     launcher splits k over up to 8 warps a row, and the block adds their
//     partials from shared memory in k order.
// Every order is fixed by B, K and D, so results are bit-equal from call to
// call; they are allclose, not bit-equal, to the in-order sum of the plain
// version.

#pragma once

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowThreads = 256;
constexpr int kRowWarps = kRowThreads / 32;

// `split` warps per row b, each over a contiguous slice of k; kRowWarps /
// split rows per block.  Every warp reaches every shuffle and barrier (a
// warp past the last row loads nothing and writes nothing).  out1 is read
// only when SUM::N == 2.
template <class SUM, bool VEC4, int G>
__global__ void __launch_bounds__(kRowThreads)
warp_rows_kernel(const int* __restrict__ ids, const float* __restrict__ vals,
                 const float* __restrict__ table, float* __restrict__ out0,
                 float* __restrict__ out1, int B, int K, int F, int D,
                 int split) {
  using S = WarpShape<G, 16>;
  constexpr int P = S::P, U = S::U, E = S::E, M = S::M;
  constexpr int W = VEC4 ? 4 : 1;
  constexpr int N = SUM::N;
  __shared__ float part[kRowWarps][N][32 * W];
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int g = lane / G;                 // this lane's k in a step
  const int j = lane % G;                 // this lane's column in the group
  const int64_t b = (int64_t)blockIdx.x * (kRowWarps / split) + warp / split;
  const bool live = b < B;                // warp-uniform
  const int kc = (K + split - 1) / split;
  const int k0 = min(K, (warp % split) * kc), k1 = min(K, k0 + kc);
  const int* id_row = ids + b * K;
  const float* val_row = vals + b * K;
  const int ncols = VEC4 ? D / 4 : D;

  for (int c0 = 0; c0 < ncols; c0 += G) {
    const int col = c0 + j;
    const bool has_col = col < ncols;
    float acc[W][N];
#pragma unroll
    for (int w = 0; w < W; ++w) {
#pragma unroll
      for (int n = 0; n < N; ++n) acc[w][n] = 0.0f;
    }
    for (int base = k0; live && base < k1; base += E) {
      // the iteration's ids and values, coalesced
      int mid[M];
      float mval[M];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int k = base + m * 32 + lane;
        const bool ok = m * 32 + lane < E && k < k1;
        mid[m] = ok ? __ldg(id_row + k) : 0;
        mval[m] = ok ? __ldg(val_row + k) : 0.0f;
      }
      // group g takes k = base + u * P + g: every row in flight first
      float v[U], x[U][W];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int slot = (u * P) >> 5, src = (u * P + g) & 31;
        const int id = __shfl_sync(kFull, mid[slot], src);
        v[u] = __shfl_sync(kFull, mval[slot], src);
        if (has_col && base + u * P + g < k1) {
          load_row<W>(table + clamp_id(id, F) * D + (int64_t)col * W, x[u]);
        } else {
#pragma unroll
          for (int w = 0; w < W; ++w) x[u][w] = 0.0f;
          v[u] = 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int w = 0; w < W; ++w) SUM::add(v[u], x[u][w], acc[w]);
      }
    }
    // the groups' partial sums, by a fixed xor tree
#pragma unroll
    for (int off = G; off < 32; off <<= 1) {
#pragma unroll
      for (int w = 0; w < W; ++w) {
#pragma unroll
        for (int n = 0; n < N; ++n) {
          acc[w][n] += __shfl_xor_sync(kFull, acc[w][n], off);
        }
      }
    }
    if (split > 1) {                      // the row's warps, in k order
      if (g == 0) {
#pragma unroll
        for (int w = 0; w < W; ++w) {
#pragma unroll
          for (int n = 0; n < N; ++n) part[warp][n][j * W + w] = acc[w][n];
        }
      }
      __syncthreads();
      if (warp % split == 0 && g == 0) {
        for (int r = 1; r < split; ++r) {
#pragma unroll
          for (int w = 0; w < W; ++w) {
#pragma unroll
            for (int n = 0; n < N; ++n) {
              acc[w][n] += part[warp + r][n][j * W + w];
            }
          }
        }
      }
      __syncthreads();
    }
    if (live && warp % split == 0 && g == 0 && has_col) {
      const int64_t at = b * D + (int64_t)col * W;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        float* o = n == 0 ? out0 : out1;
        if constexpr (W == 4) {
          *reinterpret_cast<float4*>(o + at) =
              make_float4(acc[0][n], acc[1][n], acc[2][n], acc[3][n]);
        } else {
          o[at] = acc[0][n];
        }
      }
    }
  }
}

// Launch warp_rows_kernel<SUM> on [B, K] rows.  vec4 != 0 requires D % 4
// == 0 and a 16-byte aligned table and outputs.  Returns a cudaError_t.
template <class SUM>
cudaError_t launch_warp_rows(const int* ids, const float* vals,
                             const float* table, float* out0, float* out1,
                             int B, int K, int F, int D, int vec4,
                             cudaStream_t s) {
  if (B <= 0 || D <= 0) return cudaSuccess;
  // split k over up to kRowWarps warps a row while B alone leaves the card
  // short of ~8 warps per SM and each warp keeps >= 8 k
  const int64_t warps_wanted = 8 * (int64_t)sm_count();
  int split = 1;
  while (split < kRowWarps && (int64_t)B * split < warps_wanted &&
         K / (2 * split) >= 8) {
    split *= 2;
  }
  const int rows = kRowWarps / split;
  const unsigned blocks = (unsigned)((B + rows - 1) / rows);
  return with_group(group_size(D, vec4), [&](auto gc) {
    constexpr int G = decltype(gc)::value;
    if (vec4) {
      warp_rows_kernel<SUM, true, G><<<blocks, kRowThreads, 0, s>>>(
          ids, vals, table, out0, out1, B, K, F, D, split);
    } else {
      warp_rows_kernel<SUM, false, G><<<blocks, kRowThreads, 0, s>>>(
          ids, vals, table, out0, out1, B, K, F, D, split);
    }
    return cudaGetLastError();
  });
}

}  // namespace
