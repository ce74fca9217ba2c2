// Flash attention forward and backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of the JAX package
// (flexflow_tpu/kernels/flash_attention.py):
//   ff_flash_fwd       <- :53  _fwd_kernel       online-softmax forward, O and lse
//   ff_flash_bwd_dkdv  <- :145 _bwd_dkdv_kernel  dK, dV for one k-tile over all q-tiles
//   ff_flash_bwd_dq    <- :195 _bwd_dq_kernel    dQ for one q-tile over all k-tiles
// Layout: q (BH, Sq, D), k and v (BH, Sk, D), contiguous, f32 or bf16; lse,
// delta and g_lse (BH, Sq) f32.  Scores, softmax statistics and every
// accumulator are f32, as in the TPU kernel (astype(f32) on load); O, dQ, dK
// and dV are written in the input type.  Causal masking is top-left
// (q_idx >= k_idx), and tiles wholly above the diagonal are skipped.  A row
// that sees no key gets O = 0 and lse = -1e30 (_finish, :94-101).
//
// Backward: dS = p * (dP - delta + g_lse) * scale, with p = exp(s - lse),
// dP = dO V^T and delta = rowsum(O * dO) (computed by the caller).  g_lse is
// the cotangent of the forward's lse output; the TPU kernel's VJP drops it
// (:239), these kernels take it (NULL means zero).
//
// Bound on this card: at the main path's shape (B*H = 128, S = 512, D = 64,
// bf16, causal) each kernel needs 4.3-8.6 GFLOP on 34-51 MB, so at the
// data-sheet rates (989 TFLOP/s bf16 on tensor cores, 3.35 TB/s) the least
// time is set by bytes, 10-15 us.
//
// The bf16 forward keeps S, P and O in mma.sync registers and pipelines
// the K/V loads with cp.async (section "bf16 forward: registers").  Why
// mma.sync and not wgmma/TMA: the forward is bound by bytes (10 us), and
// its products at the tensor-core peak take 4.3 us (6.5 us with P's hi +
// lo pair); at the two thirds of peak that mma.sync reaches they stay
// near the byte bound, so the gain is in keeping tiles out of shared
// memory and overlapping the loads, which mma.sync does with far less
// machinery.  Measured at that shape (chip_smoke.py, H100 80GB HBM3 at
// 700 W): 0.0370-0.0375 ms, against 0.149 ms for the wmma design it
// replaced and 0.024 ms for PyTorch's SDPA forward.  It issues its
// products at about the rate SDPA does, but has 1.5 times as many: a copy
// with P rounded to bf16 alone (SDPA's choice; not kept, see below) takes
// 0.030 ms (tools/flash_fwd_p_split.py).
// The backward kernels are first designs that are right, with the score
// tile staged in shared memory between the products (wmma).
//
// Common design: each block owns one (b*h, 64-row tile) and loops over the
// 64-row tiles it sweeps: the sequential grid axis that Pallas carried in
// VMEM scratch becomes a loop inside the block.  Each block owns its output
// tile, so there are no atomics and results are deterministic.  The ragged
// tail of S is masked inside the kernel (rows and keys past the end load as
// zero and get p = 0), instead of the TPU wrapper's gcd block fallback
// (:37-46).  Shared memory above 48 KB is opted into with
// cudaFuncSetAttribute.  Each entry point launches on the caller's stream
// and returns cudaGetLastError().
//
// f32 inputs (true f32, no TF32): FMAs on the CUDA cores, whose 67 TFLOP/s
// peak is their limit.  256 threads; the tile's rows and each swept tile
// are staged as f32 with a row stride of D + 1 floats, so the column walks
// are free of bank conflicts.  A thread owns rows ty + 16*i (i < 4) and
// score columns tx + 16*j (j < 4) of the 64x64 score tile, and output
// columns tx + 16*jj (jj < D/16); the 16 threads of a row are one half-warp,
// so row max and row sum are four shuffles; accumulators live in registers.
//
// bf16 inputs: tensor cores, see the section "bf16: tensor cores" below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // q rows and k rows per tile
constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kPLd = kTile + 1;
constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF, for lse of empty rows

// Stage rows [row0, row0 + 64) of a (rows, D) f32 matrix into shared memory
// with row stride D + 1; rows at or past `rows` read as zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          int row0, int rows) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int g = row0 + r;
    dst[r * (D + 1) + c] = g < rows ? src[(size_t)g * D + c] : 0.f;
  }
}

// acc[i][j] += sum_d A[ty + 16i][d] * B[tx + 16j][d] over two staged tiles.
template <int D>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* A,
                                         const float* B, int tx, int ty) {
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o, 16));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o, 16);
  return x;
}

__device__ __forceinline__ bool visible(int qi, int kj, int sq, int sk, bool causal) {
  return qi < sq && kj < sk && (!causal || qi >= kj);
}

// ------------------------------------------------------------------ forward

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * kTile * (D + 1) + kTile * kPLd);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                 float* __restrict__ o, float* __restrict__ lse, int n_qtiles, int sq, int sk,
                 float scale, bool causal) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile * (D + 1);
  float* Vs = Ks + kTile * (D + 1);
  float* Ps = Vs + kTile * (D + 1);
  constexpr int DC = D / 16;
  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  q += (size_t)bh * sq * D;
  k += (size_t)bh * sk * D;
  v += (size_t)bh * sk * D;
  o += (size_t)bh * sq * D;
  lse += (size_t)bh * sq;

  load_tile<D>(Qs, q, q0, sq);
  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) acc[i][jj] = 0.f;
  }
  // keys past the tile's last row are masked for every row: skip them
  const int k_end = causal ? min(sk, q0 + kTile) : sk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(Ks, k, k0, sk);
    load_tile<D>(Vs, v, k0, sk);
    __syncthreads();
    float s[4][4] = {};
    tile_dot<D>(s, Qs, Ks, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = visible(q0 + r, k0 + tx + 16 * j, sq, sk, causal) ? s[i][j] * scale
                                                                    : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      // m_new is -inf only while the row has seen no key
      const float alpha = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        Ps[r * kPLd + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = alpha * l[i] + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float p[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * kPLd + c];
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) vv[jj] = Vs[c * (D + 1) + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < DC; ++jj) acc[i][jj] = fmaf(p[i], vv[jj], acc[i][jj]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= sq) continue;
    const float inv = l[i] == 0.f ? 0.f : 1.f / l[i];
#pragma unroll
    for (int jj = 0; jj < DC; ++jj)
      o[(size_t)qi * D + tx + 16 * jj] = acc[i][jj] * inv;
    if (tx == 0) lse[qi] = l[i] == 0.f ? kNegInf : m[i] + logf(l[i]);
  }
}

// ------------------------------------------------------------------ backward

// p and dS of one (q-tile, k-tile) pair, in the score-tile layout:
// p = exp(s*scale - lse), dS = p * (dP - (delta - g_lse)) * scale.
template <int D>
__device__ __forceinline__ void probs_and_dscores(
    float (&p)[4][4], float (&ds)[4][4], const float* Qs, const float* Ks,
    const float* Vs, const float* dOs, const float* lse_s, const float* dd_s, int q0,
    int k0, int sq, int sk, float scale, bool causal, int tx, int ty) {
  float s[4][4] = {}, dp[4][4] = {};
  tile_dot<D>(s, Qs, Ks, tx, ty);
  tile_dot<D>(dp, dOs, Vs, tx, ty);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      p[i][j] = visible(q0 + r, k0 + tx + 16 * j, sq, sk, causal)
                    ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
      ds[i][j] = p[i][j] * (dp[i][j] - dd_s[r]) * scale;
    }
  }
}

// Per-row lse and delta - g_lse of rows [q0, q0 + 64); zero past the end.
__device__ __forceinline__ void load_rows(float* lse_s, float* dd_s, const float* lse,
                                          const float* delta, const float* g_lse, int q0,
                                          int sq) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const int g = q0 + r;
    lse_s[r] = g < sq ? lse[g] : 0.f;
    dd_s[r] = g < sq ? delta[g] - (g_lse ? g_lse[g] : 0.f) : 0.f;
  }
}

template <int D>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (4 * kTile * (D + 1) + 2 * kTile * kPLd + 2 * kTile);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      const float* __restrict__ g_lse, float* __restrict__ dk,
                      float* __restrict__ dv, int n_ktiles, int sq, int sk, float scale,
                      bool causal) {
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTile * (D + 1);
  float* Qs = Vs + kTile * (D + 1);
  float* dOs = Qs + kTile * (D + 1);
  float* Ps = dOs + kTile * (D + 1);
  float* dSs = Ps + kTile * kPLd;
  float* lse_s = dSs + kTile * kPLd;
  float* dd_s = lse_s + kTile;
  constexpr int DC = D / 16;
  const int bh = blockIdx.x / n_ktiles;
  const int k0 = (blockIdx.x % n_ktiles) * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  q += (size_t)bh * sq * D;
  dout += (size_t)bh * sq * D;
  k += (size_t)bh * sk * D;
  v += (size_t)bh * sk * D;
  dk += (size_t)bh * sk * D;
  dv += (size_t)bh * sk * D;
  lse += (size_t)bh * sq;
  delta += (size_t)bh * sq;
  if (g_lse) g_lse += (size_t)bh * sq;

  load_tile<D>(Ks, k, k0, sk);
  load_tile<D>(Vs, v, k0, sk);
  float acc_dk[4][DC] = {}, acc_dv[4][DC] = {};
  // q rows before k0 see none of this tile's keys
  for (int q0 = causal ? k0 : 0; q0 < sq; q0 += kTile) {
    __syncthreads();
    load_tile<D>(Qs, q, q0, sq);
    load_tile<D>(dOs, dout, q0, sq);
    load_rows(lse_s, dd_s, lse, delta, g_lse, q0, sq);
    __syncthreads();
    float p[4][4], ds[4][4];
    probs_and_dscores<D>(p, ds, Qs, Ks, Vs, dOs, lse_s, dd_s, q0, k0, sq, sk, scale,
                         causal, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        Ps[(ty + 16 * i) * kPLd + tx + 16 * j] = p[i][j];
        dSs[(ty + 16 * i) * kPLd + tx + 16 * j] = ds[i][j];
      }
    __syncthreads();
    // dV[kr] += sum_q p[q][kr] dO[q];  dK[kr] += sum_q dS[q][kr] Q[q]
#pragma unroll 4
    for (int r = 0; r < kTile; ++r) {
      float pk[4], dsk[4], o_[DC], q_[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pk[i] = Ps[r * kPLd + ty + 16 * i];
        dsk[i] = dSs[r * kPLd + ty + 16 * i];
      }
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) {
        o_[jj] = dOs[r * (D + 1) + tx + 16 * jj];
        q_[jj] = Qs[r * (D + 1) + tx + 16 * jj];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < DC; ++jj) {
          acc_dv[i][jj] = fmaf(pk[i], o_[jj], acc_dv[i][jj]);
          acc_dk[i][jj] = fmaf(dsk[i], q_[jj], acc_dk[i][jj]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = k0 + ty + 16 * i;
    if (kr >= sk) continue;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj) {
      dk[(size_t)kr * D + tx + 16 * jj] = acc_dk[i][jj];
      dv[(size_t)kr * D + tx + 16 * jj] = acc_dv[i][jj];
    }
  }
}

template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * kTile * (D + 1) + kTile * kPLd + 2 * kTile);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const float* __restrict__ g_lse, float* __restrict__ dq, int n_qtiles,
                    int sq, int sk, float scale, bool causal) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kTile * (D + 1);
  float* Ks = dOs + kTile * (D + 1);
  float* Vs = Ks + kTile * (D + 1);
  float* dSs = Vs + kTile * (D + 1);
  float* lse_s = dSs + kTile * kPLd;
  float* dd_s = lse_s + kTile;
  constexpr int DC = D / 16;
  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  q += (size_t)bh * sq * D;
  dout += (size_t)bh * sq * D;
  dq += (size_t)bh * sq * D;
  k += (size_t)bh * sk * D;
  v += (size_t)bh * sk * D;
  lse += (size_t)bh * sq;
  delta += (size_t)bh * sq;
  if (g_lse) g_lse += (size_t)bh * sq;

  load_tile<D>(Qs, q, q0, sq);
  load_tile<D>(dOs, dout, q0, sq);
  load_rows(lse_s, dd_s, lse, delta, g_lse, q0, sq);
  float acc[4][DC] = {};
  const int k_end = causal ? min(sk, q0 + kTile) : sk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();
    load_tile<D>(Ks, k, k0, sk);
    load_tile<D>(Vs, v, k0, sk);
    __syncthreads();
    float p[4][4], ds[4][4];
    probs_and_dscores<D>(p, ds, Qs, Ks, Vs, dOs, lse_s, dd_s, q0, k0, sq, sk, scale,
                         causal, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dSs[(ty + 16 * i) * kPLd + tx + 16 * j] = ds[i][j];
    __syncthreads();
    // dQ[qr] += sum_k dS[qr][k] K[k]
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float d_[4], k_[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) d_[i] = dSs[(ty + 16 * i) * kPLd + c];
#pragma unroll
      for (int jj = 0; jj < DC; ++jj) k_[jj] = Ks[c * (D + 1) + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < DC; ++jj) acc[i][jj] = fmaf(d_[i], k_[jj], acc[i][jj]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= sq) continue;
#pragma unroll
    for (int jj = 0; jj < DC; ++jj)
      dq[(size_t)qi * D + tx + 16 * jj] = acc[i][jj];
  }
}

// ------------------------------------------------------------------ bf16: tensor cores
//
// bf16 inputs run their products on the tensor cores (f32 accumulators).
// Q, K, V and dO are bf16 already, so their products are exact in f32 up
// to summation order.  The second operand of the P*V, P^T*dO, dS^T*Q and
// dS*K products is computed in f32; it enters the tensor cores as two bf16
// terms, hi = bf16(x) and lo = bf16(x - hi), which keep about 16 of its 24
// mantissa bits (two products each), so the kernels stay within the f32
// plain version's tolerance.  One block of four warps per (b*h, 64-row
// tile); a warp owns 16 of the tile's rows.
//
// The backward kernels (dK/dV, dQ) use nvcuda::wmma (16x16x16 tiles):
// each warp keeps its scores and probabilities in its own slice of shared
// memory and works on them with __syncwarp only; the swept tiles are
// shared and fenced by __syncthreads.  The forward keeps everything in
// registers instead (see "bf16 forward: registers" below).

namespace wm = nvcuda::wmma;
using bf16 = __nv_bfloat16;
using FragA = wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major>;
using FragBcol = wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major>;
using FragBrow = wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major>;
using FragC = wm::fragment<wm::accumulator, 16, 16, 16, float>;

constexpr int kWarps = 4;
constexpr int kTcThreads = 32 * kWarps;
constexpr int kSLd = kTile + 4;  // f32 score rows (a multiple of 4, as wmma needs)
constexpr int kBLd = kTile + 8;  // bf16 probability rows (a multiple of 8)

// bf16 tile rows: a multiple of 8 elements, as wmma needs
template <int D> __host__ __device__ constexpr int ld_tile() { return D + 8; }

// Bytes of each shared-memory region, all multiples of 32 so every wmma
// pointer stays 256-bit aligned.
template <int D> __host__ __device__ constexpr size_t tile_bytes() {
  return kTile * ld_tile<D>() * sizeof(bf16);
}
constexpr size_t kScoreBytes = kWarps * 16 * kSLd * sizeof(float);
constexpr size_t kProbBytes = kWarps * 16 * kBLd * sizeof(bf16);

// Rows [row0, row0 + 64) of a (rows, D) bf16 matrix into shared memory with
// 16-byte copies; rows at or past `rows` are zero.
template <int D>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* __restrict__ src,
                                               int row0, int rows) {
  constexpr int kChunks = D / 8;
  for (int idx = threadIdx.x; idx < kTile * kChunks; idx += kTcThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    const int g = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (g < rows) val = reinterpret_cast<const uint4*>(src + (size_t)g * D)[c];
    *reinterpret_cast<uint4*>(dst + r * ld_tile<D>() + c * 8) = val;
  }
}

// out[r][n] = sum_d A[r][d] * B[n][d] for the warp's 16 rows of A and the
// 64 rows of B (both staged bf16 tiles): a 16 x 64 f32 block, row stride kSLd.
template <int D>
__device__ __forceinline__ void rows_dot_tile(float* out, const bf16* A, const bf16* B) {
  FragA a[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wm::load_matrix_sync(a[kk], A + kk * 16, ld_tile<D>());
#pragma unroll
  for (int n = 0; n < kTile / 16; ++n) {
    FragC c;
    wm::fill_fragment(c, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragBcol b;
      wm::load_matrix_sync(b, B + n * 16 * ld_tile<D>() + kk * 16, ld_tile<D>());
      wm::mma_sync(c, a[kk], b, c);
    }
    wm::store_matrix_sync(out + n * 16, c, kSLd, wm::mem_row_major);
  }
}

// acc[n] += (hi + lo)(16 x 64) * B(64 x D): the split f32 operand times a
// staged bf16 tile.
template <int D>
__device__ __forceinline__ void acc_split_dot_tile(FragC (&acc)[D / 16], const bf16* hi,
                                                   const bf16* lo, const bf16* B) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    FragA ah, al;
    wm::load_matrix_sync(ah, hi + kk * 16, kBLd);
    wm::load_matrix_sync(al, lo + kk * 16, kBLd);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      FragBrow b;
      wm::load_matrix_sync(b, B + kk * 16 * ld_tile<D>() + n * 16, ld_tile<D>());
      wm::mma_sync(acc[n], ah, b, acc[n]);
      wm::mma_sync(acc[n], al, b, acc[n]);
    }
  }
}

__device__ __forceinline__ void split_store(bf16* hi, bf16* lo, float x) {
  const bf16 h = __float2bfloat16_rn(x);
  *hi = h;
  *lo = __float2bfloat16_rn(x - __bfloat162float(h));
}

// Write the warp's 16 x D f32 accumulators to global rows row0.. as bf16,
// through its staging slice `stage` (row stride D + 4).
template <int D>
__device__ __forceinline__ void write_rows(bf16* __restrict__ dst, FragC (&acc)[D / 16],
                                           float* stage, int row0, int rows) {
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wm::store_matrix_sync(stage + n * 16, acc[n], D + 4, wm::mem_row_major);
  __syncwarp();
  const int lane = threadIdx.x & 31, r = lane >> 1, h = lane & 1;
  if (row0 + r < rows) {
#pragma unroll 4
    for (int j = 0; j < D / 2; ++j)
      dst[(size_t)(row0 + r) * D + 2 * j + h] = __float2bfloat16_rn(stage[r * (D + 4) + 2 * j + h]);
  }
  __syncwarp();
}

// ------------------------------------------------------------------ bf16 forward: registers
//
// K3's bf16 path, in the manner of FlashAttention-2 on mma.sync
// (m16n8k16, bf16 operands, f32 accumulators).  One block of four warps
// per (b*h, 64-row q-tile); a warp owns 16 q rows and keeps all of their
// state in registers:
//   - Q as A fragments, loaded once with ldmatrix;
//   - the 16 x 64 score tile S = Q K^T, 32 floats a thread.  The
//     accumulator layout puts each row on the 4 lanes of a quad, so the
//     online softmax's row max and row sum are two xor-shuffles;
//   - P: two adjacent n8 accumulator tiles are one k16 A fragment, so P
//     goes from the score accumulators to bf16 hi and lo A fragments in
//     registers (as split_store's pair) and never touches shared memory;
//   - the 16 x D output accumulator, rescaled in place.
// Scores are kept in log2 units (scaled by scale * log2(e)), so each
// probability is one ex2; lse converts back once per row.
// K and V are double-buffered in shared memory: tile j+1 is copied with
// cp.async (16 bytes, zero-filled past Sk, so nothing past the tensor is
// read) while tile j is computed, with one __syncthreads per tile.  Rows
// are padded to D + 8 elements, so ldmatrix (plain for K, .trans for V)
// is free of bank conflicts.  Shared memory is the Q tile and two K and
// two V tiles: 45 KB at D = 64, room for four blocks on an SM (the
// registers, below, allow three).  The causal
// mask is applied only on the tiles that cross a warp's diagonal or Sk;
// tiles wholly above the diagonal are never loaded.  Blocks take the
// q-tiles with the most k-tiles first, so the short ones fill the last
// wave.  The epilogue stages O as bf16 in the warp's own rows of the Q
// tile and writes 16-byte words; lse is written once per row.
// Registers: 32 score, D/2 output and D/4 Q-fragment words a thread; ptxas
// gives 96, 133 and 235 registers at D = 32, 64 and 128, with no spills
// (chip_smoke.py prints the report), so D = 128 keeps this layout.  At
// D = 64, 133 registers allow three blocks an SM; capping them at 128 for
// a fourth block, two row tiles a warp (128-row blocks), and skipping the
// 16-key steps wholly above a warp's diagonal were each tried on the card
// and were no faster on the causal main path.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global-to-shared copy; when `valid` is false nothing is read and
// the destination is zero-filled.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// Wait for every cp.async this thread has issued.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}

// c += a (16 x 16, row major) * b (16 x 8, column major): bf16 in, f32 out.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return reinterpret_cast<const uint32_t&>(v);
}

// hi = bf16(x), lo = bf16(x - hi) of a pair (x0 in the low half), as
// split_store does for one value.
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// Rows [row0, row0 + 64) of a (rows, D) bf16 matrix into shared memory
// (row stride D + 8) with cp.async; rows at or past `rows` are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* __restrict__ src,
                                                int row0, int rows) {
  constexpr int kChunks = D / 8;
  static_assert(kTile * kChunks % kTcThreads == 0, "whole copies per thread");
#pragma unroll
  for (int i = 0; i < kTile * kChunks / kTcThreads; ++i) {
    const int idx = threadIdx.x + i * kTcThreads;
    const int r = idx / kChunks, c = idx % kChunks;
    const int g = row0 + r;
    const bool valid = g < rows;
    cp_async_16(dst + r * ld_tile<D>() + c * 8, src + (size_t)(valid ? g : 0) * D + c * 8,
                valid);
  }
}

template <int D>
constexpr size_t fwd_mma_smem() {
  return 5 * tile_bytes<D>();  // Q, two K and two V tiles
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int n_bh, int n_qtiles, int sq, int sk,
                     float scale, bool causal) {
  constexpr int LD = ld_tile<D>();
  constexpr int KT = D / 16;     // k16 steps of Q K^T
  constexpr int NT = kTile / 8;  // n8 tiles of a score row block
  constexpr int DT = D / 8;      // n8 tiles of an output row block
  constexpr float kLog2e = 1.4426950408889634f;
  constexpr float kLn2 = 0.6931471805599453f;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kTile * LD;      // two buffers
  bf16* Vs = Ks + 2 * kTile * LD;  // two buffers
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qr = lane >> 2, qc = lane & 3;  // the lane's row and column pair in a quad
  // the q-tiles with the most k-tiles first
  const int bh = blockIdx.x % n_bh;
  const int q0 = (n_qtiles - 1 - blockIdx.x / n_bh) * kTile;
  q += (size_t)bh * sq * D;
  k += (size_t)bh * sk * D;
  v += (size_t)bh * sk * D;
  o += (size_t)bh * sq * D;
  lse += (size_t)bh * sq;
  const int w0 = q0 + warp * 16;  // the warp's first row; the lane's are w0 + qr and + 8
  const int k_end = causal ? min(sk, q0 + kTile) : sk;
  const int nk = (k_end + kTile - 1) / kTile;
  const float scale2 = scale * kLog2e;

  load_tile_async<D>(Qs, q, q0, sq);
  if (nk > 0) {
    load_tile_async<D>(Ks, k, 0, sk);
    load_tile_async<D>(Vs, v, 0, sk);
  }
  cp_async_wait_all();
  __syncthreads();
  uint32_t qf[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk)
    ldsm_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows qr and qr + 8, log2 units
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * kTile;
    if (j > 0) {
      cp_async_wait_all();  // this thread's copies of tile j have landed
      __syncthreads();      // everyone's have, and tile j - 1 is no longer read
    }
    if (j + 1 < nk) {
      const int nb = (j + 1) & 1;
      load_tile_async<D>(Ks + nb * kTile * LD, k, k0 + kTile, sk);
      load_tile_async<D>(Vs + nb * kTile * LD, v, k0 + kTile, sk);
    }
    const bf16* Kb = Ks + (j & 1) * kTile * LD;
    const bf16* Vb = Vs + (j & 1) * kTile * LD;

    // S = Q K^T; one ldmatrix.x4 gives the B fragments of two n8 tiles
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b, Kb + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                       ((lane >> 3) & 1) * 8);
        mma_16816(s[2 * np], qf[kk], b[0], b[1]);
        mma_16816(s[2 * np + 1], qf[kk], b[2], b[3]);
      }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] *= scale2;
    // element e of tile nt: row w0 + qr + 8*(e >> 1), key k0 + 8*nt + 2*qc + (e & 1)
    if (k0 + kTile > sk || (causal && k0 + kTile - 1 > w0)) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0 + nt * 8 + 2 * qc + (e & 1);
          const int qi = w0 + qr + (e >> 1) * 8;
          if (kj >= sk || (causal && kj > qi)) s[nt][e] = -INFINITY;
        }
    }

    // online softmax, per row on the quad's 4 lanes
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
    float base[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      // m_new is -inf only while the row has seen no key: exponentiate
      // against 0 then, so every p and alpha is 0 and never NaN
      base[i] = m_new == -INFINITY ? 0.f : m_new;
      alpha[i] = exp2f(m[i] - base[i]);
      m[i] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(s[nt][e] - base[e >> 1]);
        rs[e >> 1] += s[nt][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l[i] = alpha[i] * l[i] + rs[i];
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }

    // O += P V: P as bf16 hi + lo A fragments straight from the score
    // accumulators, V's B fragments through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_pair(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_pair(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_pair(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_pair(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t b[4];
        ldsm_x4_trans(b, Vb + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dp * 16 +
                             (lane >> 4) * 8);
        mma_16816(acc[2 * dp], ph, b[0], b[1]);
        mma_16816(acc[2 * dp], pl, b[0], b[1]);
        mma_16816(acc[2 * dp + 1], ph, b[2], b[3]);
        mma_16816(acc[2 * dp + 1], pl, b[2], b[3]);
      }
    }
  }

  // epilogue: O / l as bf16 through the warp's rows of the Q tile (only this
  // warp read them), then 16-byte stores of whole rows
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) inv[i] = l[i] == 0.f ? 0.f : 1.f / l[i];
  bf16* stage = Qs + warp * 16 * LD;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int c = dt * 8 + 2 * qc;
    *reinterpret_cast<__nv_bfloat162*>(stage + qr * LD + c) =
        __floats2bfloat162_rn(acc[dt][0] * inv[0], acc[dt][1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(stage + (qr + 8) * LD + c) =
        __floats2bfloat162_rn(acc[dt][2] * inv[1], acc[dt][3] * inv[1]);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * DT / 32; ++i) {
    const int idx = lane + 32 * i;
    const int r = idx / DT, c = idx % DT;
    if (w0 + r < sq)
      *reinterpret_cast<uint4*>(o + (size_t)(w0 + r) * D + c * 8) =
          *reinterpret_cast<const uint4*>(stage + r * LD + c * 8);
  }
  if (qc == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = w0 + qr + 8 * i;
      if (qi < sq) lse[qi] = l[i] == 0.f ? kNegInf : m[i] * kLn2 + logf(l[i]);
    }
  }
}

template <int D>
constexpr size_t dkdv_tc_smem() {
  return 4 * tile_bytes<D>() + 2 * kScoreBytes + 4 * kProbBytes + 2 * kTile * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const float* __restrict__ g_lse, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int n_ktiles, int sq, int sk, float scale,
                         bool causal) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* p = smem_raw;
  bf16* Ks = reinterpret_cast<bf16*>(p);  p += tile_bytes<D>();
  bf16* Vs = reinterpret_cast<bf16*>(p);  p += tile_bytes<D>();
  bf16* Qs = reinterpret_cast<bf16*>(p);  p += tile_bytes<D>();
  bf16* dOs = reinterpret_cast<bf16*>(p);  p += tile_bytes<D>();
  float* St = reinterpret_cast<float*>(p) + warp * 16 * kSLd;  p += kScoreBytes;
  float* dPt = reinterpret_cast<float*>(p) + warp * 16 * kSLd;  p += kScoreBytes;
  bf16* Phi = reinterpret_cast<bf16*>(p) + warp * 16 * kBLd;  p += kProbBytes;
  bf16* Plo = reinterpret_cast<bf16*>(p) + warp * 16 * kBLd;  p += kProbBytes;
  bf16* dShi = reinterpret_cast<bf16*>(p) + warp * 16 * kBLd;  p += kProbBytes;
  bf16* dSlo = reinterpret_cast<bf16*>(p) + warp * 16 * kBLd;  p += kProbBytes;
  float* lse_s = reinterpret_cast<float*>(p);
  float* dd_s = lse_s + kTile;
  const int bh = blockIdx.x / n_ktiles;
  const int k0 = (blockIdx.x % n_ktiles) * kTile;
  q += (size_t)bh * sq * D;
  dout += (size_t)bh * sq * D;
  k += (size_t)bh * sk * D;
  v += (size_t)bh * sk * D;
  dk += (size_t)bh * sk * D;
  dv += (size_t)bh * sk * D;
  lse += (size_t)bh * sq;
  delta += (size_t)bh * sq;
  if (g_lse) g_lse += (size_t)bh * sq;

  load_tile_bf16<D>(Ks, k, k0, sk);
  load_tile_bf16<D>(Vs, v, k0, sk);
  FragC acc_dk[D / 16], acc_dv[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wm::fill_fragment(acc_dk[n], 0.f);
    wm::fill_fragment(acc_dv[n], 0.f);
  }
  // this lane's key row of the warp's 16, and its half of the query columns
  const int r = lane >> 1, h = lane & 1;
  const int kj = k0 + warp * 16 + r;
  for (int q0 = causal ? k0 : 0; q0 < sq; q0 += kTile) {
    __syncthreads();
    load_tile_bf16<D>(Qs, q, q0, sq);
    load_tile_bf16<D>(dOs, dout, q0, sq);
    load_rows(lse_s, dd_s, lse, delta, g_lse, q0, sq);
    __syncthreads();
    // transposed tiles: S^T = K Q^T and dP^T = V dO^T, keys in rows
    rows_dot_tile<D>(St, Ks + warp * 16 * ld_tile<D>(), Qs);
    rows_dot_tile<D>(dPt, Vs + warp * 16 * ld_tile<D>(), dOs);
    __syncwarp();
#pragma unroll 4
    for (int j = 0; j < kTile / 2; ++j) {
      const int c = 2 * j + h;
      const float pj = visible(q0 + c, kj, sq, sk, causal)
                           ? expf(St[r * kSLd + c] * scale - lse_s[c]) : 0.f;
      const float ds = pj * (dPt[r * kSLd + c] - dd_s[c]) * scale;
      split_store(Phi + r * kBLd + c, Plo + r * kBLd + c, pj);
      split_store(dShi + r * kBLd + c, dSlo + r * kBLd + c, ds);
    }
    __syncwarp();
    acc_split_dot_tile<D>(acc_dv, Phi, Plo, dOs);   // dV += P^T dO
    acc_split_dot_tile<D>(acc_dk, dShi, dSlo, Qs);  // dK += dS^T Q
  }
  __syncthreads();  // Q and dO tiles are free: stage the outputs there
  float* stage = reinterpret_cast<float*>(Qs) + warp * 16 * (D + 4);
  write_rows<D>(dk, acc_dk, stage, k0 + warp * 16, sk);
  write_rows<D>(dv, acc_dv, stage, k0 + warp * 16, sk);
}

template <int D>
constexpr size_t dq_tc_smem() {
  return 4 * tile_bytes<D>() + 2 * kScoreBytes + 2 * kProbBytes + 2 * kTile * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       const float* __restrict__ g_lse, bf16* __restrict__ dq, int n_qtiles,
                       int sq, int sk, float scale, bool causal) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* p = smem_raw;
  bf16* Qs = reinterpret_cast<bf16*>(p);  p += tile_bytes<D>();
  bf16* dOs = reinterpret_cast<bf16*>(p);  p += tile_bytes<D>();
  bf16* Ks = reinterpret_cast<bf16*>(p);  p += tile_bytes<D>();
  bf16* Vs = reinterpret_cast<bf16*>(p);  p += tile_bytes<D>();
  float* Sw = reinterpret_cast<float*>(p) + warp * 16 * kSLd;  p += kScoreBytes;
  float* dPw = reinterpret_cast<float*>(p) + warp * 16 * kSLd;  p += kScoreBytes;
  bf16* dShi = reinterpret_cast<bf16*>(p) + warp * 16 * kBLd;  p += kProbBytes;
  bf16* dSlo = reinterpret_cast<bf16*>(p) + warp * 16 * kBLd;  p += kProbBytes;
  float* lse_s = reinterpret_cast<float*>(p);
  float* dd_s = lse_s + kTile;
  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kTile;
  q += (size_t)bh * sq * D;
  dout += (size_t)bh * sq * D;
  dq += (size_t)bh * sq * D;
  k += (size_t)bh * sk * D;
  v += (size_t)bh * sk * D;
  lse += (size_t)bh * sq;
  delta += (size_t)bh * sq;
  if (g_lse) g_lse += (size_t)bh * sq;

  load_tile_bf16<D>(Qs, q, q0, sq);
  load_tile_bf16<D>(dOs, dout, q0, sq);
  load_rows(lse_s, dd_s, lse, delta, g_lse, q0, sq);
  FragC acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wm::fill_fragment(acc[n], 0.f);
  const int r = lane >> 1, h = lane & 1;
  const int rr = warp * 16 + r;  // this lane's row of the block's tile
  const int k_end = causal ? min(sk, q0 + kTile) : sk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();
    load_tile_bf16<D>(Ks, k, k0, sk);
    load_tile_bf16<D>(Vs, v, k0, sk);
    __syncthreads();
    rows_dot_tile<D>(Sw, Qs + warp * 16 * ld_tile<D>(), Ks);
    rows_dot_tile<D>(dPw, dOs + warp * 16 * ld_tile<D>(), Vs);
    __syncwarp();
#pragma unroll 4
    for (int j = 0; j < kTile / 2; ++j) {
      const int c = 2 * j + h;
      const float pj = visible(q0 + rr, k0 + c, sq, sk, causal)
                           ? expf(Sw[r * kSLd + c] * scale - lse_s[rr]) : 0.f;
      split_store(dShi + r * kBLd + c, dSlo + r * kBLd + c,
                  pj * (dPw[r * kSLd + c] - dd_s[rr]) * scale);
    }
    __syncwarp();
    acc_split_dot_tile<D>(acc, dShi, dSlo, Ks);  // dQ += dS K
  }
  __syncthreads();  // K and V tiles are free: stage the output there
  write_rows<D>(dq, acc, reinterpret_cast<float*>(Ks) + warp * 16 * (D + 4), q0 + warp * 16,
                sq);
}

// ------------------------------------------------------------------ launches

// Opt a kernel into its dynamic shared memory (above 48 KB a launch is
// refused without this).  Set before every launch: the attribute is per
// device, and the call is cheap beside the kernel.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Launch `kernel` over `blocks` blocks with its shared memory opted into.
template <typename K, typename... Args>
cudaError_t launch(K kernel, int blocks, int threads, size_t smem, cudaStream_t s,
                   Args... args) {
  const cudaError_t attr = allow_smem(kernel, smem);
  if (attr != cudaSuccess) return attr;
  kernel<<<(unsigned)blocks, threads, smem, s>>>(args...);
  return cudaGetLastError();
}

inline int tiles(int n) { return (n + kTile - 1) / kTile; }

// dtype 0: float32 on the CUDA cores; dtype 1: bfloat16 on the tensor cores.
template <int D>
cudaError_t launch_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
                       float* lse, int bh, int sq, int sk, float scale, bool causal,
                       cudaStream_t s) {
  const int nq = tiles(sq);
  if (dtype == 1) {
    // a hint: the most shared memory the SM can give, so more blocks fit
    const cudaError_t carve = cudaFuncSetAttribute(
        flash_fwd_mma_kernel<D>, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
    if (carve != cudaSuccess) return carve;
    return launch(flash_fwd_mma_kernel<D>, bh * nq, kTcThreads, fwd_mma_smem<D>(), s,
                  (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, lse, bh, nq, sq,
                  sk, scale, causal);
  }
  return launch(flash_fwd_kernel<D>, bh * nq, kThreads, fwd_smem<D>(), s,
                (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, nq, sq,
                sk, scale, causal);
}

template <int D>
cudaError_t launch_dkdv(int dtype, const void* q, const void* k, const void* v,
                        const void* dout, const float* lse, const float* delta,
                        const float* g_lse, void* dk, void* dv, int bh, int sq, int sk,
                        float scale, bool causal, cudaStream_t s) {
  const int nk = tiles(sk);
  if (dtype == 1)
    return launch(flash_bwd_dkdv_tc_kernel<D>, bh * nk, kTcThreads, dkdv_tc_smem<D>(), s,
                  (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse,
                  delta, g_lse, (bf16*)dk, (bf16*)dv, nk, sq, sk, scale, causal);
  return launch(flash_bwd_dkdv_kernel<D>, bh * nk, kThreads, dkdv_smem<D>(), s,
                (const float*)q, (const float*)k, (const float*)v, (const float*)dout, lse,
                delta, g_lse, (float*)dk, (float*)dv, nk, sq, sk, scale, causal);
}

template <int D>
cudaError_t launch_dq(int dtype, const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      const float* g_lse, void* dq, int bh, int sq, int sk, float scale,
                      bool causal, cudaStream_t s) {
  const int nq = tiles(sq);
  if (dtype == 1)
    return launch(flash_bwd_dq_tc_kernel<D>, bh * nq, kTcThreads, dq_tc_smem<D>(), s,
                  (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse,
                  delta, g_lse, (bf16*)dq, nq, sq, sk, scale, causal);
  return launch(flash_bwd_dq_kernel<D>, bh * nq, kThreads, dq_smem<D>(), s,
                (const float*)q, (const float*)k, (const float*)v, (const float*)dout, lse,
                delta, g_lse, (float*)dq, nq, sq, sk, scale, causal);
}

// Dispatch on the head dim (32, 64 and 128 are compiled) and dtype (0 or 1).
#define FF_DISPATCH(FN, ...)                                                   \
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;             \
  switch (d) {                                                                 \
    case 32: return (int)FN<32>(dtype, __VA_ARGS__);                           \
    case 64: return (int)FN<64>(dtype, __VA_ARGS__);                           \
    case 128: return (int)FN<128>(dtype, __VA_ARGS__);                         \
    default: return (int)cudaErrorInvalidValue;                                \
  }

}  // namespace

extern "C" int ff_flash_fwd(const void* q, const void* k, const void* v, void* o,
                            float* lse, int bh, int sq, int sk, int d, int dtype,
                            float scale, int causal, void* stream) {
  if (bh <= 0 || sq <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  FF_DISPATCH(launch_fwd, q, k, v, o, lse, bh, sq, sk, scale, causal != 0, s)
}

extern "C" int ff_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse, const float* delta,
                                 const float* g_lse, void* dk, void* dv, int bh, int sq,
                                 int sk, int d, int dtype, float scale, int causal,
                                 void* stream) {
  if (bh <= 0 || sk <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  FF_DISPATCH(launch_dkdv, q, k, v, dout, lse, delta, g_lse, dk, dv, bh, sq, sk, scale,
              causal != 0, s)
}

extern "C" int ff_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse, const float* delta,
                               const float* g_lse, void* dq, int bh, int sq, int sk, int d,
                               int dtype, float scale, int causal, void* stream) {
  if (bh <= 0 || sq <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  FF_DISPATCH(launch_dq, q, k, v, dout, lse, delta, g_lse, dq, bh, sq, sk, scale,
              causal != 0, s)
}
