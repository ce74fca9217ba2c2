// Fused SGD and Adam parameter updates for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of the JAX package:
//   ff_fused_sgd_update_multi <- flexflow_tpu/kernels/fused_optimizer.py:63 _sgd_kernel
//   ff_fused_adam_update      <- flexflow_tpu/kernels/fused_optimizer.py:110 _adam_kernel
// with the reference's update rules (optimizer_kernel.cu:23-40, :206-225):
//   SGD:  g' = g + wd*w;  m = mu*m + g';
//         w -= lr*(g' + mu*m) (nesterov) | lr*m (momentum) | lr*g' (mu == 0)
//   Adam: g' = g + wd*w;  m = b1*m + (1-b1)*g';  v = b2*v + (1-b2)*g'^2;
//         w -= alpha_t*m / (sqrt(v) + eps)   (alpha_t carries the bias correction)
//
// Bound: device-memory bytes.  Each element is read once and written once,
// a handful of flops per 4-byte word, far below the ~295 flop/byte ridge:
//   SGD with momentum  20 B/elem (read w g m, write w m)
//   SGD, mu == 0       12 B/elem (read w g, write w; m is never touched)
//   Adam               28 B/elem (read w g m v, write w m v)
// At AlexNet's 57,044,810 parameters that is 1.14 GB, 0.68 GB and 1.60 GB per
// step, or 0.34 ms, 0.20 ms and 0.48 ms at the 3.35 TB/s data-sheet rate.
//
// SGD design: one launch per optimizer step over a table of leaves (up to
// kMaxLeaves; the wrapper splits a longer list into further launches).
// Per-leaf launches cost 16-47 us of host time each (ctypes, checks, the
// stream lookup), which put 16 of them behind torch's one multi-tensor
// launch and made 54 of them a host cost on the transformer's step.  The
// table is a kernel parameter, passed by value (3 KB, under the 4 KB
// limit) and read in place (__grid_constant__), so a launch copies nothing
// to the device first.  Each leaf is cut into chunks of `chunk` elements
// (a multiple of 4), one block a chunk; a block finds its leaf by binary
// search over the leaves' first chunks.  The hardware hands out blocks as
// SMs free up, so small leaves and ragged last chunks balance themselves.
// Adam keeps one launch per leaf (a grid-stride loop).  Both move float4
// (16-byte) words when every pointer of the leaf is 16-byte aligned, with
// a scalar tail; otherwise (a view at an odd offset) the leaf goes through
// the scalar loop.  The TPU kernel's (rows, 128) padding is its tiling and
// is not carried over.
// w, m and v are updated in place: the counterpart of the Pallas call's
// input_output_aliases, so no parameter-sized temporary exists.  The
// time-varying scalars are read from device memory, the counterpart of the
// TPU kernels' SMEM operand: `scalars` is a float32 vector, [0] the step
// size (lr for SGD, alpha_t for Adam) and [1] a skip flag.  A block that
// finds skip != 0 returns before it reads or writes anything, so a step
// that the non-finite guard skips leaves w, m and v bitwise as they were.
// Because nothing that changes from step to step is a launch argument, a
// launch captured in a CUDA graph stays right when lr, alpha_t or the flag
// change between replays (they are written in place, outside the graph).
// wd, momentum/betas and eps are fixed per optimizer and stay arguments;
// nothing is allocated here.
// Built with -fmad=false (see kernels/fused_optimizer.py), each line below
// rounds as the plain PyTorch version's separate tensor operations do.
// Each entry point launches on the caller's stream and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 4096;

template <bool MOMENTUM, bool NESTEROV>
__device__ __forceinline__ void sgd_elem(float& w, float g, float& m, float lr,
                                         float wd, float mu) {
  g = g + wd * w;
  float upd = g;
  if (MOMENTUM) {
    m = mu * m + g;
    upd = NESTEROV ? g + mu * m : m;
  }
  w = w - lr * upd;
}

__device__ __forceinline__ void adam_elem(float& w, float g, float& m, float& v,
                                          float alpha_t, float wd, float b1,
                                          float one_m_b1, float b2, float one_m_b2,
                                          float eps) {
  g = g + wd * w;
  m = b1 * m + one_m_b1 * g;
  v = b2 * v + one_m_b2 * g * g;
  w = w - alpha_t * m / (sqrtf(v) + eps);
}

// One leaf of the SGD table.  m is NULL when momentum is 0.
struct SgdLeaf {
  float* w;
  const float* g;
  float* m;
  int64_t n;       // elements
  int64_t chunk0;  // the leaf's first chunk: the block that starts it
  int vec;         // every pointer 16-byte aligned: float4 words
};

constexpr int kMaxLeaves = 64;

struct SgdTable {
  SgdLeaf leaf[kMaxLeaves];
  int count;
};
static_assert(sizeof(SgdTable) + 64 <= 4096, "kernel parameters above 4 KB");

template <bool MOMENTUM, bool NESTEROV>
__global__ void __launch_bounds__(kThreads)
sgd_kernel(const __grid_constant__ SgdTable t, int64_t chunk, const float* __restrict__ scalars,
           float wd, float mu) {
  if (scalars[1] != 0.f) return;  // a skipped step
  const float lr = scalars[0];
  // this block's leaf: the last one whose first chunk is at or before it
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.leaf[mid].chunk0 <= (int64_t)blockIdx.x) lo = mid; else hi = mid - 1;
  }
  const SgdLeaf& leaf = t.leaf[lo];
  const int64_t begin = ((int64_t)blockIdx.x - leaf.chunk0) * chunk;
  const int64_t rest = leaf.n - begin;
  const int64_t n = rest < chunk ? rest : chunk;
  float* __restrict__ w = leaf.w + begin;
  const float* __restrict__ g = leaf.g + begin;
  float* __restrict__ m = MOMENTUM ? leaf.m + begin : nullptr;
  int64_t head = 0;
  if (leaf.vec) {  // begin is a multiple of 4, so w, g, m stay 16-byte aligned
    const int64_t n4 = n >> 2;
    float4* w4 = reinterpret_cast<float4*>(w);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* m4 = reinterpret_cast<float4*>(m);
#pragma unroll 4
    for (int64_t i = threadIdx.x; i < n4; i += kThreads) {
      float4 wv = w4[i];
      const float4 gv = g4[i];
      float4 mv = MOMENTUM ? m4[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      sgd_elem<MOMENTUM, NESTEROV>(wv.x, gv.x, mv.x, lr, wd, mu);
      sgd_elem<MOMENTUM, NESTEROV>(wv.y, gv.y, mv.y, lr, wd, mu);
      sgd_elem<MOMENTUM, NESTEROV>(wv.z, gv.z, mv.z, lr, wd, mu);
      sgd_elem<MOMENTUM, NESTEROV>(wv.w, gv.w, mv.w, lr, wd, mu);
      w4[i] = wv;
      if (MOMENTUM) m4[i] = mv;
    }
    head = n4 << 2;
  }
  for (int64_t i = head + threadIdx.x; i < n; i += kThreads) {
    float wv = w[i];
    float mv = MOMENTUM ? m[i] : 0.f;
    sgd_elem<MOMENTUM, NESTEROV>(wv, g[i], mv, lr, wd, mu);
    w[i] = wv;
    if (MOMENTUM) m[i] = mv;
  }
}

__global__ void __launch_bounds__(kThreads)
adam_kernel(float* __restrict__ w, const float* __restrict__ g,
            float* __restrict__ m, float* __restrict__ v, int64_t n, bool vec,
            const float* __restrict__ scalars, float wd, float b1, float one_m_b1,
            float b2, float one_m_b2, float eps) {
  if (scalars[1] != 0.f) return;  // a skipped step
  const float alpha_t = scalars[0];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t head = 0;
  if (vec) {
    const int64_t n4 = n >> 2;
    float4* w4 = reinterpret_cast<float4*>(w);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* m4 = reinterpret_cast<float4*>(m);
    float4* v4 = reinterpret_cast<float4*>(v);
    for (int64_t i = tid; i < n4; i += stride) {
      float4 wv = w4[i];
      const float4 gv = g4[i];
      float4 mv = m4[i];
      float4 vv = v4[i];
      adam_elem(wv.x, gv.x, mv.x, vv.x, alpha_t, wd, b1, one_m_b1, b2, one_m_b2, eps);
      adam_elem(wv.y, gv.y, mv.y, vv.y, alpha_t, wd, b1, one_m_b1, b2, one_m_b2, eps);
      adam_elem(wv.z, gv.z, mv.z, vv.z, alpha_t, wd, b1, one_m_b1, b2, one_m_b2, eps);
      adam_elem(wv.w, gv.w, mv.w, vv.w, alpha_t, wd, b1, one_m_b1, b2, one_m_b2, eps);
      w4[i] = wv;
      m4[i] = mv;
      v4[i] = vv;
    }
    head = n4 << 2;
  }
  for (int64_t i = head + tid; i < n; i += stride) {
    float wv = w[i], mv = m[i], vv = v[i];
    adam_elem(wv, g[i], mv, vv, alpha_t, wd, b1, one_m_b1, b2, one_m_b2, eps);
    w[i] = wv;
    m[i] = mv;
    v[i] = vv;
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

inline int blocks_for(int64_t work) {
  int64_t b = (work + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return (int)b;
}

// Work items of one launch: float4 words plus the scalar tail, or all
// elements on the scalar path.
inline int64_t work_items(int64_t n, bool vec) {
  return vec ? (n >> 2) + (n & 3) : n;
}

}  // namespace

// One SGD step over `count` leaves (1..kMaxLeaves) in one launch.  `table`
// holds a row of five int64 per leaf, in the order the wrapper's
// sgd_launch_plan gives: w, g, m (0 when momentum is 0), element count
// (> 0) and first chunk (0 for the first leaf, then the running sum of
// ceil(n / chunk)).  `scalars` is the device vector (lr, skip).
extern "C" int ff_fused_sgd_update_multi(const int64_t* table, int count, int64_t chunk,
                                         const float* scalars, float wd, float momentum,
                                         int nesterov, void* stream) {
  if (count <= 0 || count > kMaxLeaves || chunk <= 0 || chunk % 4 != 0 || !scalars)
    return (int)cudaErrorInvalidValue;
  const bool use_m = momentum > 0.f;
  SgdTable t{};
  t.count = count;
  for (int i = 0; i < count; ++i) {
    const int64_t* row = table + 5 * i;
    SgdLeaf& leaf = t.leaf[i];
    leaf.w = reinterpret_cast<float*>(row[0]);
    leaf.g = reinterpret_cast<const float*>(row[1]);
    leaf.m = use_m ? reinterpret_cast<float*>(row[2]) : nullptr;
    leaf.n = row[3];
    leaf.chunk0 = row[4];
    leaf.vec = aligned16(leaf.w) && aligned16(leaf.g) && (!use_m || aligned16(leaf.m));
  }
  const SgdLeaf& last = t.leaf[count - 1];
  const int64_t blocks = last.chunk0 + (last.n + chunk - 1) / chunk;
  if (blocks <= 0 || blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)blocks;
  if (use_m && nesterov) {
    sgd_kernel<true, true><<<grid, kThreads, 0, s>>>(t, chunk, scalars, wd, momentum);
  } else if (use_m) {
    sgd_kernel<true, false><<<grid, kThreads, 0, s>>>(t, chunk, scalars, wd, momentum);
  } else {
    sgd_kernel<false, false><<<grid, kThreads, 0, s>>>(t, chunk, scalars, wd, 0.f);
  }
  return (int)cudaGetLastError();
}

// `scalars` is the device vector (alpha_t, skip).
extern "C" int ff_fused_adam_update(float* w, const float* g, float* m, float* v,
                                    int64_t n, const float* scalars, float wd, float beta1,
                                    float one_minus_beta1, float beta2,
                                    float one_minus_beta2, float eps, void* stream) {
  if (n <= 0) return 0;
  if (!scalars) return (int)cudaErrorInvalidValue;
  const bool vec = aligned16(w) && aligned16(g) && aligned16(m) && aligned16(v);
  const int blocks = blocks_for(work_items(n, vec));
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  adam_kernel<<<blocks, kThreads, 0, s>>>(w, g, m, v, n, vec, scalars, wd, beta1,
                                          one_minus_beta1, beta2, one_minus_beta2, eps);
  return (int)cudaGetLastError();
}
