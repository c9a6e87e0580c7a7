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
// Each thread decodes entries i of its block's tile:
//   ids[i]      = the w-bit field at bit i*w (one or two words)
//   vals[i]     = dict[the d-bit code at bit i*d], or raw[i]; bit patterns
//                 are copied, never converted, so the result is bit-exact
//   segments[i] = the row r with row_ptr[r] <= i < row_ptr[r+1]: a binary
//                 search of row_ptr, rows (the scratch row) for padding
//                 i >= row_ptr[rows]
//
// What bounds it: bytes, and at the training batch's size (B 131,072) the
// launch itself: the buffer read once (0.3-1 MB) and 1.5 MB written.
// Design: a block of 256 threads takes a tile of 1024 entries (4 a thread,
// strided so a warp's stores are coalesced); row_ptr is staged in shared
// memory when it fits in the default 48 KB (rows <= 12,287: every batch
// shape the repo runs), else the search reads it from global memory.  The
// launch uses the caller's stream and allocates nothing, so it records into
// a CUDA graph.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;
constexpr int kSmemWords = 48 * 1024 / 4;

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

// The last row r in [0, rows] with rp[r] <= i (rows when i is padding).
__device__ __forceinline__ int row_of(const int* rp, int rows, int i) {
  int lo = 0, hi = rows;       // invariant: rp[lo] <= i, answer in [lo, hi]
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (rp[mid] <= i) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
wire_decode_v3(const int* __restrict__ buf, int* __restrict__ ids,
               int* __restrict__ vals, int* __restrict__ segs, int B,
               int rows, int w, int dbits, int64_t code_off,
               int64_t dict_off, int64_t val_off, int64_t rp_off,
               int stage) {
  __shared__ int rp_s[kSmemWords];
  const int* rp = buf + rp_off;
  if (stage) {
    for (int r = threadIdx.x; r <= rows; r += kThreads) rp_s[r] = rp[r];
    __syncthreads();
    rp = rp_s;
  }
  const uint32_t* words = reinterpret_cast<const uint32_t*>(buf);
  const int n_real = rp[rows];
  const int base = blockIdx.x * kTile + threadIdx.x;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int i = base + j * kThreads;
    if (i >= B) return;
    ids[i] = static_cast<int>(field(words, (uint64_t)i * w, w));
    if (dbits) {
      const uint32_t code = field(words + code_off, (uint64_t)i * dbits,
                                  dbits);
      vals[i] = __ldg(buf + dict_off + code);
    } else {
      vals[i] = __ldg(buf + val_off + i);
    }
    // every entry past the real ones is padding: the scratch row
    segs[i] = i >= n_real ? rows : row_of(rp, rows, i);
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
  if (w < 1 || w > 32 || dbits < 0 || dbits > 16 || rows < 0)
    return cudaErrorInvalidValue;
  const int blocks = (B + kTile - 1) / kTile;
  const int stage = rows + 1 <= kSmemWords;
  wire_decode_v3<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      buf, ids, reinterpret_cast<int*>(vals), segs, B, rows, w, dbits,
      code_off, dict_off, val_off, rp_off, stage);
  return cudaGetLastError();
}
