// Decode of the v3 compact wire for Hopper (sm_90a): one launch a batch.
//
// Replaces no Pallas kernel.  The JAX package decodes the v3 wire in XLA
// (dmlc_core_tpu/pipeline/device_loader.py make_decoder, the jnp branch for
// id_width != 0); on the card its plain PyTorch version
// (wire_decode.py::wire_decode_reference) is about a dozen small launches a
// batch, issued from the loader's transfer thread on a path whose host
// enqueue already outlasts the device's work.  This kernel is that decode
// in one launch.
//
// The v3 buffer (int32 words, B = the nnz bucket, w = the id width,
// d = the dictionary bits, 0 for raw values):
//
//   [0, IW)            ids, w bits each, packed LSB first   IW = ceil(B*w/32)
//   d > 0:  [IW, IW+CW) codes, d bits each                   CW = ceil(B*d/32)
//           [.., +DW)   the dictionary, f32 bits             DW = 2^d
//   d == 0: [IW, IW+B)  raw f32 bits
//   [voff, voff+rows+1) row_ptr, then labels and weights (left as views)
//
// What it computes, for every entry i < B:
//   ids[i]      = the w-bit field at bit i*w (one or two words)
//   vals[i]     = dict[the d-bit code at bit i*d], or raw[i]; bit patterns
//                 are copied, never converted, so the result is bit-exact
//   segments[i] = the number of r in [1, rows] with row_ptr[r] <= i: the
//                 row r with row_ptr[r] <= i < row_ptr[r+1], rows (the
//                 scratch row) for padding i >= row_ptr[rows], and row 0
//                 for every i < row_ptr[1] (row_ptr[0] is never read),
//                 exactly what searchsorted(row_ptr[1:], i, right=True)
//                 gives
//
// What bounds it: bytes (the buffer read once, 0.5-0.7 MB at the training
// batch, and 1.2 MB written), but at that size the launch and two or three
// dependent device-memory latencies dominate.  Design, a tile window with
// a scan (not a row-owner fill: a row that holds most of the batch would
// then have to be split across blocks, and the scratch row's padding is a
// second range of the same kind; a tile window makes every block's work
// the same size whatever the rows look like):
//   * A block of 64 threads takes a tile of 256 consecutive entries, each
//     thread 4 of them, so the three outputs go out as 16-byte stores
//     (scalar at the batch's tail or on unaligned outputs).  384 blocks at
//     B 98,304: about three resident on each of the 132 SMs.
//   * The id, code and raw-value words and the first row_ptr probes are
//     loaded before anything waits on one of them.  The dictionary gather
//     (code word, then a dictionary word at random: one L2 sector an
//     entry) and the row search (probe, then window word) are two chains
//     of dependent loads whose costs add up rather than overlap, whichever
//     of them the code issues first (on an H100: each alone 1.2-1.9 us
//     above a kernel that loads and stores a word a thread, both 3.1).
//   * Segments without a per-entry search and without staging row_ptr:
//     the block finds the rows that start inside its tile with a
//     cooperative k-ary search over row_ptr (64 probes a round, one a
//     thread; one round at 4096 rows, two at 65,536) that narrows the
//     window of row_ptr words which can matter to the tile to at most 512
//     (about 140 at 4096 rows), then reads that window once (at most 8
//     independent loads a thread).  A word <= the tile's first entry
//     counts into the tile's first row; a word inside the tile marks its
//     entry with its row in shared memory (atomicMax: of several empty
//     rows starting at one entry, the last one owns it).  A block
//     max-scan of the marks, from
//     the first row on, gives each entry its row.  Each row_ptr word is
//     read by the window of the tile it starts in and by those of a few
//     tiles before it, plus the probes (the same 64 words in every block
//     of a batch, served from L2): about 200 words a block at 4096 rows,
//     against all 4097 for a block that stages row_ptr.  Where the window
//     cannot shrink (more than ~512 rows start inside one tile), it is
//     read in chunks, each word still once.
//   * Shared memory is the tile's marks (1 KB) and a few words; nothing is
//     sized by rows.
// The launch uses the caller's stream and allocates nothing, so it records
// into a CUDA graph.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;                   // two warps
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;                        // consecutive entries a thread
constexpr int kTile = kThreads * kPer;         // entries a block
constexpr int kProbes = 1;                     // probes a thread a round
constexpr int kProbesBlock = kThreads * kProbes;
constexpr int kWindowLoads = 8;                // window words a thread a chunk
constexpr int kWindow = kThreads * kWindowLoads;

// The w-bit field (1 <= w <= 32) at bit position bit of words; the second
// word is read only when the field crosses into it, so a field never reads
// past the region.
__device__ __forceinline__ uint32_t field(const uint32_t* __restrict__ words,
                                          uint64_t bit, int w) {
  const uint64_t word = bit >> 5;
  const uint32_t off = static_cast<uint32_t>(bit & 31);
  uint32_t v = __ldg(words + word) >> off;
  if (off != 0 && off + w > 32) v |= __ldg(words + word + 1) << (32 - off);
  return w == 32 ? v : (v & ((1u << w) - 1u));
}

// The block's sum of v, in every thread.  red holds a word a warp; the
// leading barrier keeps a previous call's readers ahead of this call's
// writers (and orders every thread's shared-memory work before it).
__device__ __forceinline__ int block_sum(int v, int* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) s += red[k];
  return s;
}

// Loads this thread's probes of one search round: row_ptr at the
// candidates lo + 1 + j*s, j = threadIdx.x + k*kThreads (INT_MAX past hi).
__device__ __forceinline__ void load_probes(const int* __restrict__ rp,
                                            int lo, int hi, int s,
                                            int (&pv)[kProbes]) {
#pragma unroll
  for (int k = 0; k < kProbes; ++k) {
    const int64_t q = lo + 1 + static_cast<int64_t>(threadIdx.x +
                                                    k * kThreads) * s;
    pv[k] = q <= hi ? __ldg(rp + q) : INT_MAX;
  }
}

__global__ void __launch_bounds__(kThreads)
wire_decode_v3(const int* __restrict__ buf, int* __restrict__ ids,
               int* __restrict__ vals, int* __restrict__ segs, int B,
               int rows, int w, int dbits, int64_t code_off,
               int64_t dict_off, int64_t val_off, int64_t rp_off, int vec) {
  // marks[p]: the largest row that starts at entry t0 + p (0: none)
  __shared__ __align__(16) int marks[kTile];
  __shared__ int red[kWarps];
  __shared__ int wmax[kWarps];
  const uint32_t* words = reinterpret_cast<const uint32_t*>(buf);
  const int* __restrict__ rp = buf + rp_off;
  const int t0 = blockIdx.x * kTile;
  const int tend = t0 + kTile - 1;             // the tile's last entry
  const int i0 = t0 + threadIdx.x * kPer;
  const int n = min(kPer, B - i0);             // this thread's entries

  // The search keeps lo <= first <= last <= hi, where first (last) is the
  // number of row_ptr[1..rows] words <= t0 (<= tend); the window is the
  // words lo+1 .. hi.  The first round's probes are loaded here, ahead of
  // the id and value loads, so that nothing below waits for them alone.
  int lo = 0, hi = rows;
  int pv[kProbes] = {};
  int s = (hi - lo + kProbesBlock - 1) / kProbesBlock;
  if (hi - lo > kWindow) load_probes(rp, lo, hi, s, pv);

  int id[kPer] = {}, val[kPer] = {}, code[kPer] = {};
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (j < n) {
      const uint64_t i = static_cast<uint64_t>(i0 + j);
      id[j] = static_cast<int>(field(words, i * w, w));
      if (dbits)
        code[j] = static_cast<int>(field(words + code_off, i * dbits, dbits));
      else
        val[j] = __ldg(buf + val_off + i);
    }
  }
  if (dbits) {
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (j < n) val[j] = __ldg(buf + dict_off + code[j]);
  }

  reinterpret_cast<int4*>(marks)[threadIdx.x] = make_int4(0, 0, 0, 0);

  bool first_round = true;
  while (hi - lo > kWindow) {
    const int span = hi - lo;
    s = (span + kProbesBlock - 1) / kProbesBlock;
    if (!first_round) load_probes(rp, lo, hi, s, pv);
    first_round = false;
    int c = 0;                                  // (<= t0) | (<= tend) << 16
#pragma unroll
    for (int k = 0; k < kProbes; ++k)
      c += (pv[k] <= t0) + ((pv[k] <= tend) << 16);
    c = block_sum(c, red);
    const int c1 = c & 0xFFFF, c2 = c >> 16;
    const int valid = (span - 1) / s + 1;      // probes at or below hi
    const int nlo = c1 > 0 ? lo + 1 + (c1 - 1) * s : lo;
    const int nhi = c2 < valid ? lo + c2 * s : hi;
    lo = nlo;
    hi = nhi;
    if (2 * (hi - lo) > span) break;           // no longer shrinking
  }
  __syncthreads();                              // marks zeroed

  int below = 0;                                // window words <= t0
  for (int base = lo + 1; base <= hi; base += kWindow) {
    int v[kWindowLoads];
#pragma unroll
    for (int k = 0; k < kWindowLoads; ++k) {
      const int64_t r = static_cast<int64_t>(base) + threadIdx.x +
                        k * kThreads;
      v[k] = r <= hi ? __ldg(rp + r) : INT_MAX;
    }
#pragma unroll
    for (int k = 0; k < kWindowLoads; ++k) {
      const int r = base + threadIdx.x + k * kThreads;
      if (v[k] <= t0)
        ++below;
      else if (v[k] <= tend)
        atomicMax(&marks[v[k] - t0], r);
    }
  }
  const int first = lo + block_sum(below, red);

  // each entry's row: the running max of the marks from the first row on
  const int4 mk = reinterpret_cast<const int4*>(marks)[threadIdx.x];
  int m[kPer] = {mk.x, max(mk.x, mk.y), 0, 0};
  m[2] = max(m[1], mk.z);
  m[3] = max(m[2], mk.w);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = m[3];                                 // inclusive scan over lanes
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x = max(x, y);
  }
  int carry = __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == 0) carry = 0;
  if (lane == 31) wmax[warp] = x;
  __syncthreads();
  for (int k = 0; k < warp; ++k) carry = max(carry, wmax[k]);
  carry = max(carry, first);

  if (n == kPer && vec) {
    reinterpret_cast<int4*>(ids)[i0 / kPer] =
        make_int4(id[0], id[1], id[2], id[3]);
    reinterpret_cast<int4*>(vals)[i0 / kPer] =
        make_int4(val[0], val[1], val[2], val[3]);
    reinterpret_cast<int4*>(segs)[i0 / kPer] =
        make_int4(max(carry, m[0]), max(carry, m[1]), max(carry, m[2]),
                  max(carry, m[3]));
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (j < n) {
        ids[i0 + j] = id[j];
        vals[i0 + j] = val[j];
        segs[i0 + j] = max(carry, m[j]);
      }
    }
  }
}

}  // namespace

// Decodes ids, vals (f32 bits) and segments, B each, from the v3 buffer buf
// (see above; the offsets are the host's layout arithmetic).  Returns a
// cudaError_t (0 = launched).
extern "C" int wire_decode_v3_launch(const int* buf, int* ids, float* vals,
                                     int* segs, int B, int rows, int w,
                                     int dbits, int64_t code_off,
                                     int64_t dict_off, int64_t val_off,
                                     int64_t rp_off, void* stream) {
  if (B <= 0) return 0;
  if (w < 1 || w > 32 || dbits < 0 || dbits > 16 || rows < 0 ||
      B > INT_MAX - kTile)
    return cudaErrorInvalidValue;
  const int blocks = (B + kTile - 1) / kTile;
  const int vec = ((reinterpret_cast<uintptr_t>(ids) |
                    reinterpret_cast<uintptr_t>(vals) |
                    reinterpret_cast<uintptr_t>(segs)) & 15) == 0;
  wire_decode_v3<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      buf, ids, reinterpret_cast<int*>(vals), segs, B, rows, w, dbits,
      code_off, dict_off, val_off, rp_off, vec);
  return cudaGetLastError();
}
