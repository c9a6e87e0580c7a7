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
//   * forward: one warp per row b, several rows per 256-thread block.  The
//     warp loads the row's ids and values with coalesced loads, E at a time
//     (WarpShape in common.cuh), and splits into 32/G groups of G = D/4
//     lanes (float4; D lanes, capped at 32 and looping over columns, when
//     the rows are not 16-byte aligned).  Group j takes k = j mod 32/G and
//     issues the float4 row loads of U = 16 such k before it sums any, so
//     at D = 32 a row's 64 gathers are in flight at once: one round trip
//     for the ids and one for the rows, not K/8 x 2 (16 k a group ran
//     faster than 8 at B 4096 on the H100).  The
//     groups' partial s1 and s2 meet in a fixed xor shuffle tree and are
//     written as float4.  When B alone leaves the card short of about eight
//     warps per SM (the serving bucket, B 128), the launcher splits k over
//     up to 8 warps a row, and the block adds their partials from shared
//     memory in k order.  Every order is fixed by B, K and D, so results
//     are bit-equal from call to call; they are allclose, not bit-equal,
//     to the in-order sum of the plain version.
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

#include "common.cuh"

namespace {

// ---------------------------------------------------------------- forward --

constexpr unsigned kFull = 0xffffffffu;
constexpr int kFwdThreads = 256;
constexpr int kFwdWarps = kFwdThreads / 32;

// `split` warps per row b, each over a contiguous slice of k; kFwdWarps /
// split rows per block.  Every warp reaches every shuffle and barrier (a
// warp past the last row loads nothing and writes nothing).
template <bool VEC4, int G>
__global__ void __launch_bounds__(kFwdThreads)
fm_terms_kernel(const int* __restrict__ ids, const float* __restrict__ vals,
                const float* __restrict__ table, float* __restrict__ s1,
                float* __restrict__ s2, int B, int K, int F, int D,
                int split) {
  using S = WarpShape<G, 16>;
  constexpr int P = S::P, U = S::U, E = S::E, M = S::M;
  constexpr int W = VEC4 ? 4 : 1;
  __shared__ float part[kFwdWarps][2][32 * W];
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int g = lane / G;                 // this lane's k in a step
  const int j = lane % G;                 // this lane's column in the group
  const int64_t b = (int64_t)blockIdx.x * (kFwdWarps / split) + warp / split;
  const bool live = b < B;                // warp-uniform
  const int kc = (K + split - 1) / split;
  const int k0 = min(K, (warp % split) * kc), k1 = min(K, k0 + kc);
  const int* id_row = ids + b * K;
  const float* val_row = vals + b * K;
  const int ncols = VEC4 ? D / 4 : D;

  for (int c0 = 0; c0 < ncols; c0 += G) {
    const int col = c0 + j;
    const bool has_col = col < ncols;
    float a1[W], a2[W];
#pragma unroll
    for (int w = 0; w < W; ++w) a1[w] = a2[w] = 0.0f;
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
        for (int w = 0; w < W; ++w) {
          a1[w] += v[u] * x[u][w];
          a2[w] += (v[u] * v[u]) * (x[u][w] * x[u][w]);
        }
      }
    }
    // the groups' partial sums, by a fixed xor tree
#pragma unroll
    for (int off = G; off < 32; off <<= 1) {
#pragma unroll
      for (int w = 0; w < W; ++w) {
        a1[w] += __shfl_xor_sync(kFull, a1[w], off);
        a2[w] += __shfl_xor_sync(kFull, a2[w], off);
      }
    }
    if (split > 1) {                      // the row's warps, in k order
      if (g == 0) {
#pragma unroll
        for (int w = 0; w < W; ++w) {
          part[warp][0][j * W + w] = a1[w];
          part[warp][1][j * W + w] = a2[w];
        }
      }
      __syncthreads();
      if (warp % split == 0 && g == 0) {
        for (int r = 1; r < split; ++r) {
#pragma unroll
          for (int w = 0; w < W; ++w) {
            a1[w] += part[warp + r][0][j * W + w];
            a2[w] += part[warp + r][1][j * W + w];
          }
        }
      }
      __syncthreads();
    }
    if (live && warp % split == 0 && g == 0 && has_col) {
      const int64_t at = b * D + (int64_t)col * W;
      if constexpr (W == 4) {
        *reinterpret_cast<float4*>(s1 + at) =
            make_float4(a1[0], a1[1], a1[2], a1[3]);
        *reinterpret_cast<float4*>(s2 + at) =
            make_float4(a2[0], a2[1], a2[2], a2[3]);
      } else {
        s1[at] = a1[0];
        s2[at] = a2[0];
      }
    }
  }
}

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
  if (B <= 0 || D <= 0) return 0;
  // split k over up to kFwdWarps warps a row while B alone leaves the card
  // short of ~8 warps per SM and each warp keeps >= 8 k
  const int64_t warps_wanted = 8 * (int64_t)sm_count();
  int split = 1;
  while (split < kFwdWarps && (int64_t)B * split < warps_wanted &&
         K / (2 * split) >= 8) {
    split *= 2;
  }
  const int rows = kFwdWarps / split;
  const unsigned blocks = (unsigned)((B + rows - 1) / rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_group(group_size(D, vec4), [&](auto gc) {
    constexpr int G = decltype(gc)::value;
    if (vec4) {
      fm_terms_kernel<true, G><<<blocks, kFwdThreads, 0, s>>>(
          ids, vals, table, s1, s2, B, K, F, D, split);
    } else {
      fm_terms_kernel<false, G><<<blocks, kFwdThreads, 0, s>>>(
          ids, vals, table, s1, s2, B, K, F, D, split);
    }
    return cudaGetLastError();
  });
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
