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
// time is set by bytes, 10-15 us.  Both designs below are far from it:
// they are first designs that are right, with the score tile staged in
// shared memory between the products.  wgmma/TMA pipelines are later work.
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
// bf16 inputs run their products on the tensor cores through nvcuda::wmma
// (16x16x16 bf16 tiles, f32 accumulators).  Q, K, V and dO are bf16
// already, so their products are exact in f32 up to summation order.  The
// second operand of the P*V, P^T*dO, dS^T*Q and dS*K products is computed
// in f32; it enters the tensor cores as two bf16 terms, hi = bf16(x) and
// lo = bf16(x - hi), which keep about 16 of its 24 mantissa bits (two
// products each), so the kernels stay within the f32 plain version's
// tolerance.  One block of four warps per (b*h, 64-row tile); a warp owns
// 16 of the tile's rows, keeps its scores, probabilities and (forward) its
// output rows in its own slice of shared memory, and works on them with
// __syncwarp only; the swept tiles are shared and fenced by __syncthreads.

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
template <int D> __host__ __device__ constexpr size_t out_bytes() {
  return kWarps * 16 * (D + 4) * sizeof(float);
}

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

template <int D>
constexpr size_t fwd_tc_smem() {
  return 3 * tile_bytes<D>() + kScoreBytes + 2 * kProbBytes + out_bytes<D>();
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    float* __restrict__ lse, int n_qtiles, int sq, int sk, float scale,
                    bool causal) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* p = smem_raw;
  bf16* Qs = reinterpret_cast<bf16*>(p);  p += tile_bytes<D>();
  bf16* Ks = reinterpret_cast<bf16*>(p);  p += tile_bytes<D>();
  bf16* Vs = reinterpret_cast<bf16*>(p);  p += tile_bytes<D>();
  float* Sw = reinterpret_cast<float*>(p) + warp * 16 * kSLd;  p += kScoreBytes;
  bf16* Phi = reinterpret_cast<bf16*>(p) + warp * 16 * kBLd;  p += kProbBytes;
  bf16* Plo = reinterpret_cast<bf16*>(p) + warp * 16 * kBLd;  p += kProbBytes;
  float* Ow = reinterpret_cast<float*>(p) + warp * 16 * (D + 4);
  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kTile;
  q += (size_t)bh * sq * D;
  k += (size_t)bh * sk * D;
  v += (size_t)bh * sk * D;
  o += (size_t)bh * sq * D;
  lse += (size_t)bh * sq;

  load_tile_bf16<D>(Qs, q, q0, sq);
  for (int i = lane; i < 16 * (D + 4); i += 32) Ow[i] = 0.f;
  __syncwarp();
  // this lane's row of the warp's 16, and its half (even or odd columns)
  const int r = lane >> 1, h = lane & 1;
  const int qi = q0 + warp * 16 + r;
  float m = -INFINITY, l = 0.f;
  const int k_end = causal ? min(sk, q0 + kTile) : sk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();
    load_tile_bf16<D>(Ks, k, k0, sk);
    load_tile_bf16<D>(Vs, v, k0, sk);
    __syncthreads();
    rows_dot_tile<D>(Sw, Qs + warp * 16 * ld_tile<D>(), Ks);
    __syncwarp();
    float sv[kTile / 2], mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kTile / 2; ++j) {
      const int c = 2 * j + h;
      sv[j] = visible(qi, k0 + c, sq, sk, causal) ? Sw[r * kSLd + c] * scale : -INFINITY;
      mx = fmaxf(mx, sv[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = m_new == -INFINITY ? 1.f : expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kTile / 2; ++j) {
      const float pj = sv[j] == -INFINITY ? 0.f : expf(sv[j] - m_new);
      split_store(Phi + r * kBLd + 2 * j + h, Plo + r * kBLd + 2 * j + h, pj);
      sum += pj;
    }
    l = alpha * l + sum + __shfl_xor_sync(0xffffffffu, sum, 1);
    m = m_new;
#pragma unroll 4
    for (int j = 0; j < D / 2; ++j) Ow[r * (D + 4) + 2 * j + h] *= alpha;
    __syncwarp();
    FragC acc[D / 16];
#pragma unroll
    for (int n = 0; n < D / 16; ++n)
      wm::load_matrix_sync(acc[n], Ow + n * 16, D + 4, wm::mem_row_major);
    acc_split_dot_tile<D>(acc, Phi, Plo, Vs);
#pragma unroll
    for (int n = 0; n < D / 16; ++n)
      wm::store_matrix_sync(Ow + n * 16, acc[n], D + 4, wm::mem_row_major);
    __syncwarp();
  }
  if (qi < sq) {
    const float inv = l == 0.f ? 0.f : 1.f / l;
#pragma unroll 4
    for (int j = 0; j < D / 2; ++j)
      o[(size_t)qi * D + 2 * j + h] = __float2bfloat16_rn(Ow[r * (D + 4) + 2 * j + h] * inv);
    if (h == 0) lse[qi] = l == 0.f ? kNegInf : m + logf(l);
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
  if (dtype == 1)
    return launch(flash_fwd_tc_kernel<D>, bh * nq, kTcThreads, fwd_tc_smem<D>(), s,
                  (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, lse, nq, sq,
                  sk, scale, causal);
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
