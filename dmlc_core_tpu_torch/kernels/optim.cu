// Fused multi-tensor optimizer steps: optax.adam and the JAX package's FTRL.
//
// No Pallas counterpart: the JAX package leaves both updates to XLA
// (optax.adam = scale_by_adam + scale(-lr) + apply_updates, and
// dmlc_core_tpu/models/ftrl.py:57-66).  Each entry point is ONE launch over
// every parameter tensor of a model: per-tensor pointers and sizes travel by
// value in the kernel's arguments (a table of at most kMaxTensors a launch,
// as apex's multi_tensor_apply chunks them), so a step copies nothing from
// the host and a CUDA graph can capture it.
//
// What bounds it on an H100: bytes.  Every element is read once (p, g and
// the two state tensors) and written once (p and the two state tensors):
// 28 bytes an element and a handful of flops.  The design streams each
// tensor in turn over the whole grid with float4 loads (where the four
// pointers are 16-byte aligned), several independent 16-byte loads a
// thread in flight, and no shared memory.
//
// The arithmetic follows the reference's order of operations op by op,
// each rounded on its own (__f*_rn: no contraction into fma), so the kernel
// and its plain PyTorch version (kernels/optim.py) agree to the last bit
// wherever both round the same way.
//
// Adam's step count is an int32 on the device.  Every block reads it first;
// the last block to finish (a ticket counter) writes it back incremented,
// with optax's saturation at INT32_MAX, and resets the ticket.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

namespace {

constexpr int kMaxTensors = 24;
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

// One launch's tensors: p (params), g (grads), a and b (Adam: mu, nu;
// FTRL: z, n), n elements each; vec4[k] != 0 when all four are 16-byte
// aligned.
struct Tensors {
  float* p[kMaxTensors];
  const float* g[kMaxTensors];
  float* a[kMaxTensors];
  float* b[kMaxTensors];
  int64_t n[kMaxTensors];
  int vec4[kMaxTensors];
  int count;
};

struct AdamHyper {
  float b1, omb1, b2, omb2, eps, eps_root, neg_lr;
};

struct FtrlHyper {
  float alpha, beta, l1, l2;
};

// optax: mu = (1-b1)·g + b1·mu; nu = (1-b2)·g² + b2·nu; mu_hat = mu / bc1;
// nu_hat = nu / bc2; u = mu_hat / (sqrt(nu_hat + eps_root) + eps);
// p = p + (-lr)·u.
struct AdamOp {
  AdamHyper h;
  float bc1, bc2;
  __device__ __forceinline__ void operator()(float& p, float g, float& m,
                                             float& v) const {
    m = __fadd_rn(__fmul_rn(h.omb1, g), __fmul_rn(h.b1, m));
    v = __fadd_rn(__fmul_rn(h.omb2, __fmul_rn(g, g)), __fmul_rn(h.b2, v));
    const float mh = __fdiv_rn(m, bc1);
    const float vh = __fdiv_rn(v, bc2);
    const float den = __fadd_rn(__fsqrt_rn(__fadd_rn(vh, h.eps_root)), h.eps);
    p = __fadd_rn(p, __fmul_rn(h.neg_lr, __fdiv_rn(mh, den)));
  }
};

// dmlc_core_tpu/models/ftrl.py:57-66, then optax.apply_updates:
// p = w + (w_new - w).
struct FtrlOp {
  FtrlHyper h;
  __device__ __forceinline__ void operator()(float& w, float g, float& z,
                                             float& n) const {
    const float gg = __fmul_rn(g, g);
    const float sigma =
        __fdiv_rn(__fsub_rn(__fsqrt_rn(__fadd_rn(n, gg)), __fsqrt_rn(n)),
                  h.alpha);
    const float z1 = __fsub_rn(__fadd_rn(z, g), __fmul_rn(sigma, w));
    const float n1 = __fadd_rn(n, gg);
    const float den =
        __fadd_rn(__fdiv_rn(__fadd_rn(h.beta, __fsqrt_rn(n1)), h.alpha),
                  h.l2);
    float w1 = 0.f;
    if (fabsf(z1) > h.l1) {
      const float sgn = z1 > 0.f ? 1.f : (z1 < 0.f ? -1.f : 0.f);
      w1 = __fdiv_rn(-__fsub_rn(z1, __fmul_rn(sgn, h.l1)), den);
    }
    w = __fadd_rn(w, __fsub_rn(w1, w));
    z = z1;
    n = n1;
  }
};

// Each tensor in turn, over the whole grid: float4 groups, then the tail.
template <typename Op>
__device__ __forceinline__ void apply_all(const Tensors& t, const Op& op) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int k = 0; k < t.count; ++k) {
    const int64_t n = t.n[k];
    int64_t head = 0;
    if (t.vec4[k]) {
      head = n / 4 * 4;
      float4* p4 = reinterpret_cast<float4*>(t.p[k]);
      const float4* g4 = reinterpret_cast<const float4*>(t.g[k]);
      float4* a4 = reinterpret_cast<float4*>(t.a[k]);
      float4* b4 = reinterpret_cast<float4*>(t.b[k]);
      for (int64_t i = tid; i < n / 4; i += stride) {
        float4 p = p4[i];
        const float4 g = __ldg(g4 + i);
        float4 a = a4[i];
        float4 b = b4[i];
        op(p.x, g.x, a.x, b.x);
        op(p.y, g.y, a.y, b.y);
        op(p.z, g.z, a.z, b.z);
        op(p.w, g.w, a.w, b.w);
        p4[i] = p;
        a4[i] = a;
        b4[i] = b;
      }
    }
    for (int64_t i = head + tid; i < n; i += stride) {
      float p = t.p[k][i];
      float a = t.a[k][i];
      float b = t.b[k][i];
      op(p, __ldg(t.g[k] + i), a, b);
      t.p[k][i] = p;
      t.a[k][i] = a;
      t.b[k][i] = b;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    adam_kernel(Tensors t, AdamHyper h, int* count, unsigned* ticket,
                int bump) {
  const int c = count ? *reinterpret_cast<volatile int*>(count) : 0;
  const int c1 = c < INT_MAX ? c + 1 : INT_MAX;
  AdamOp op{h, __fsub_rn(1.f, powf(h.b1, (float)c1)),
            __fsub_rn(1.f, powf(h.b2, (float)c1))};
  apply_all(t, op);
  if (bump) {
    __syncthreads();  // every thread of this block has read the count
    if (threadIdx.x == 0) {
      __threadfence();
      if (atomicAdd(ticket, 1u) == gridDim.x - 1) {  // the last block
        *count = c1;
        *ticket = 0u;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    ftrl_kernel(Tensors t, FtrlHyper h) {
  apply_all(t, FtrlOp{h});
}

inline int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

// Fills `t` with tensors [first, last) and returns the grid that covers the
// largest of them with one float4 group a thread, at most kBlocksPerSm
// blocks an SM.
inline int fill(Tensors& t, float* const* p, const float* const* g,
                float* const* a, float* const* b, const long long* n,
                const int* vec4, int first, int last) {
  t.count = last - first;
  int64_t most = 1;
  for (int k = 0; k < t.count; ++k) {
    t.p[k] = p[first + k];
    t.g[k] = g[first + k];
    t.a[k] = a[first + k];
    t.b[k] = b[first + k];
    t.n[k] = n[first + k];
    t.vec4[k] = vec4[first + k];
    most = std::max<int64_t>(most, t.vec4[k] ? (n[first + k] + 3) / 4
                                             : n[first + k]);
  }
  const int64_t want = (most + kThreads - 1) / kThreads;
  return (int)std::min<int64_t>(want, (int64_t)sm_count() * kBlocksPerSm);
}

}  // namespace

// Adam over `ntensors` tensors (p, g, mu, nu, sizes, float4 flags as
// arrays on the host); `count` (int32) and `ticket` (uint32, 0 between
// launches) are on the device.  omb1 and omb2 are 1 - b1 and 1 - b2 as the
// caller rounds them (optax: in double, then to float32).  bump == 0 reads
// the count without moving it (count may then be null).  More than kMaxTensors tensors take several
// launches, the count moving with the last; ntensors == 0 is one launch
// that touches no tensor (it loads the module, and measures a launch with
// no work).  Returns a cudaError_t (0 = launched).
extern "C" int optim_adam_launch(float* const* p, const float* const* g,
                                 float* const* mu, float* const* nu,
                                 const long long* n, const int* vec4,
                                 int ntensors, int* count, unsigned* ticket,
                                 float lr, float b1, float omb1, float b2,
                                 float omb2, float eps, float eps_root,
                                 int bump, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const AdamHyper h{b1, omb1, b2, omb2, eps, eps_root, -lr};
  int first = 0;
  do {
    const int last = std::min(ntensors, first + kMaxTensors);
    Tensors t{};
    const int blocks = fill(t, p, g, mu, nu, n, vec4, first, last);
    adam_kernel<<<blocks, kThreads, 0, s>>>(t, h, count, ticket,
                                            bump && last == ntensors);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    first = last;
  } while (first < ntensors);
  return 0;
}

// FTRL over `ntensors` tensors (w = p, g, z, n as for Adam; ntensors == 0
// as for Adam).
extern "C" int optim_ftrl_launch(float* const* p, const float* const* g,
                                 float* const* z, float* const* nsq,
                                 const long long* n, const int* vec4,
                                 int ntensors, float alpha, float beta,
                                 float l1, float l2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const FtrlHyper h{alpha, beta, l1, l2};
  int first = 0;
  do {
    const int last = std::min(ntensors, first + kMaxTensors);
    Tensors t{};
    const int blocks = fill(t, p, g, z, nsq, n, vec4, first, last);
    ftrl_kernel<<<blocks, kThreads, 0, s>>>(t, h);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    first = last;
  } while (first < ntensors);
  return 0;
}
