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
// All three bf16 kernels keep their score tiles, probabilities and
// accumulators in mma.sync registers and pipeline the swept tiles with
// cp.async (sections "bf16 forward: registers" and "bf16 backward:
// registers").  Why mma.sync and not wgmma/TMA: each kernel is bound by
// bytes (10-15 us), and its products at the tensor-core peak take 4-9 us
// (more with the hi + lo pairs); at the two thirds of peak that mma.sync
// reaches they stay near the byte bound, so the gain is in keeping tiles
// out of shared memory and overlapping the loads, which mma.sync does
// with far less machinery.  What bounds them now is the rate at which
// one warp issues its products (K3: about 172 TFLOP/s of issued products
// against 0.0375 ms at that shape, chip_smoke.py on an H100 80GB HBM3 at
// 700 W; 0.024 ms for PyTorch's SDPA forward, which issues a third fewer:
// P rounded to bf16 once, 0.030 ms in tools/flash_fwd_p_split.py).
// Warp-specialised wgmma with TMA loads, which issues at the card's full
// rate, is the next step once these numbers stand.
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
// bf16 inputs run their products on the tensor cores with mma.sync
// m16n8k16 (bf16 operands, f32 accumulators).  Q, K, V and dO are bf16
// already, so their products are exact in f32 up to summation order.  The
// second operand of the P V, P^T dO, dS^T Q and dS K products is computed
// in f32; it enters the tensor cores as two bf16 terms, hi = bf16(x) and
// lo = bf16(x - hi), which keep about 16 of its 24 mantissa bits (two
// products each), so the kernels stay within the f32 plain version's
// tolerance.  One block of four warps per (b*h, 64-row tile); a warp owns
// 16 of the tile's rows and keeps their state in registers.  Swept tiles
// are double-buffered in shared memory with cp.async, rows padded to
// D + 8 elements so that ldmatrix is free of bank conflicts.

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kTcThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// bf16 tile rows: D + 8 elements (16-byte rows for cp.async, and a padding
// that spreads the 8 rows of an ldmatrix over all 32 banks)
template <int D> __host__ __device__ constexpr int ld_tile() { return D + 8; }

// Bytes of one staged 64-row bf16 tile, a multiple of 128.
template <int D> __host__ __device__ constexpr size_t tile_bytes() {
  return kTile * ld_tile<D>() * sizeof(bf16);
}

// ------------------------------------------------------------------ bf16 forward: registers
//
// K3's bf16 path, in the manner of FlashAttention-2.  A warp owns 16 q rows
// and keeps in registers: Q as A fragments (ldmatrix, once); the 16 x 64
// score tile S = Q K^T, 32 floats a thread, whose accumulator layout puts
// each row on the 4 lanes of a quad, so the online softmax's row max and
// row sum are two xor-shuffles; P, turned from the score accumulators into
// bf16 hi and lo A fragments (split_frag); and the 16 x D output
// accumulator, rescaled in place.  Scores are kept in log2 units (scaled
// by scale * log2(e)), so each probability is one ex2; lse converts back
// once per row.  K and V are double-buffered: tile j+1 is copied with
// cp.async (16 bytes, zero-filled past Sk, so nothing past the tensor is
// read) while tile j is computed, with one __syncthreads per tile;
// ldmatrix is plain for K, .trans for V.  Shared memory is the Q tile and
// two K and two V tiles: 45 KB at D = 64.  The causal mask is applied only
// on the tiles that cross a warp's diagonal or Sk; tiles wholly above the
// diagonal are never loaded.  Blocks take the q-tiles with the most
// k-tiles first, so the short ones fill the last wave.  O is written by
// store_rows, lse once per row.
// Registers: ptxas gives 96, 133 and 239 at D = 32, 64 and 128, with no
// spills, so D = 128 keeps this layout.  At D = 64, 133 registers allow
// three blocks an SM; capping them at 128 for a fourth block, two row
// tiles a warp (128-row blocks), and skipping the 16-key steps wholly above
// a warp's diagonal were each tried on the card and were no faster on the
// causal main path.

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

// hi = bf16(x), lo = bf16(x - hi) of a pair (x0 in the low half): the two
// bf16 terms of an f32 operand (see "bf16: tensor cores").
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// Two adjacent n8 accumulator tiles (c0, c1) are, element for element, the
// A fragment of one k16 step: its bf16 hi and lo terms.
__device__ __forceinline__ void split_frag(const float (&c0)[4], const float (&c1)[4],
                                           uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_pair(c0[0], c0[1], hi[0], lo[0]);
  split_pair(c0[2], c0[3], hi[1], lo[1]);
  split_pair(c1[0], c1[1], hi[2], lo[2]);
  split_pair(c1[2], c1[3], hi[3], lo[3]);
}

// The A fragment of k16 step kk of 16 rows of a staged tile (`rows` is the
// first row).
template <int D>
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const bf16* rows, int kk) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, rows + (lane & 15) * ld_tile<D>() + kk * 16 + (lane >> 4) * 8);
}

// B fragments for k16 step kk of two n8 tiles whose columns are rows
// 16*n16 .. 16*n16 + 15 of a staged tile (as K in Q K^T): b[0], b[1] for
// the first tile, b[2], b[3] for the second.
template <int D>
__device__ __forceinline__ void ldsm_b(uint32_t (&b)[4], const bf16* tile, int n16, int kk) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(b, tile + (n16 * 16 + (lane & 7) + ((lane >> 4) << 3)) * ld_tile<D>() + kk * 16 +
                 ((lane >> 3) & 1) * 8);
}

// B fragments for k16 step kk (rows 16*kk ..) of two n8 tiles that are
// columns 16*n16 .. 16*n16 + 15 of a staged row-major tile (as V in P V),
// through ldmatrix.trans; same order as ldsm_b.
template <int D>
__device__ __forceinline__ void ldsm_bt(uint32_t (&b)[4], const bf16* tile, int kk, int n16) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_trans(b, tile + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld_tile<D>() +
                       n16 * 16 + (lane >> 4) * 8);
}

// Write a warp's 16 x D accumulator tile as bf16 to rows row0 .. row0 + 15
// of a (rows, D) matrix, those below `rows`; the lane's rows qr and qr + 8
// are scaled by f0 and f1.  Staged in `stage`, 16 rows of a tile that only
// this warp reads, then stored in 16-byte words.
template <int D>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, const float (&acc)[D / 8][4],
                                           float f0, float f1, bf16* stage, int row0, int rows) {
  constexpr int LD = ld_tile<D>();
  constexpr int DT = D / 8;
  const int lane = threadIdx.x & 31, qr = lane >> 2, qc = lane & 3;
  __syncwarp();  // the warp's last reads of `stage` are done
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int c = dt * 8 + 2 * qc;
    *reinterpret_cast<__nv_bfloat162*>(stage + qr * LD + c) =
        __floats2bfloat162_rn(acc[dt][0] * f0, acc[dt][1] * f0);
    *reinterpret_cast<__nv_bfloat162*>(stage + (qr + 8) * LD + c) =
        __floats2bfloat162_rn(acc[dt][2] * f1, acc[dt][3] * f1);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * DT / 32; ++i) {
    const int idx = lane + 32 * i;
    const int r = idx / DT, c = idx % DT;
    if (row0 + r < rows)
      *reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * D + c * 8) =
          *reinterpret_cast<const uint4*>(stage + r * LD + c * 8);
  }
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
    ldsm_a<D>(qf[kk], Qs + warp * 16 * LD, kk);

  float acc[DT][4] = {};
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
    float s[NT][4] = {};
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldsm_b<D>(b, Kb, np, kk);
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
      split_frag(s[2 * kk], s[2 * kk + 1], ph, pl);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t b[4];
        ldsm_bt<D>(b, Vb, kk, dp);
        mma_16816(acc[2 * dp], ph, b[0], b[1]);
        mma_16816(acc[2 * dp], pl, b[0], b[1]);
        mma_16816(acc[2 * dp + 1], ph, b[2], b[3]);
        mma_16816(acc[2 * dp + 1], pl, b[2], b[3]);
      }
    }
  }

  // epilogue: O / l through the warp's rows of the Q tile (only it read them)
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) inv[i] = l[i] == 0.f ? 0.f : 1.f / l[i];
  store_rows<D>(o, acc, inv[0], inv[1], Qs + warp * 16 * LD, w0, sq);
  if (qc == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = w0 + qr + 8 * i;
      if (qi < sq) lse[qi] = l[i] == 0.f ? kNegInf : m[i] * kLn2 + logf(l[i]);
    }
  }
}

// ------------------------------------------------------------------ bf16 backward: registers
//
// K4 (dK, dV) and K5 (dQ) on the forward's building blocks.  A block owns
// one 64-row output tile and sweeps the other side's tiles, which are
// double-buffered with cp.async (one __syncthreads per tile); a warp owns
// 16 output rows and keeps their accumulators, score tiles and
// probabilities in registers.  p = exp2(s * scale * log2(e) - lse *
// log2(e)) for the lse of the forward, and dS = p * (dP - (delta - g_lse))
// * scale, are formed in the score accumulators, and become bf16 hi + lo
// A fragments there (split_frag), so no score tile touches shared memory.
// A masked entry gets p = 0 by a select, never by a product, so an exp2
// that overflows on it cannot give NaN; the mask is applied only on tiles
// that cross a warp's diagonal or the ragged end.  The outputs are staged
// as bf16 in the warp's own rows of a tile that only it read, and written
// in 16-byte words (store_rows).
//
// K5, flash_bwd_dq_mma_kernel: a block per (b*h, q-tile), the q-tiles with
// the most k-tiles first.  S = Q K^T and dP = dO V^T take K's and V's B
// fragments through plain ldmatrix, dQ += dS K takes K's through
// ldmatrix.trans.  The lse and delta - g_lse of the lane's two rows stay in
// registers.
//
// K4, flash_bwd_dkdv_mma_kernel: a block per (b*h, k-tile).  A causal
// sweep starts at the q-tile of the block's first key, so the blocks are
// ordered by k0, the most q-tiles first.  It works on transposed tiles,
// keys in rows, so that every product's A operand comes from registers:
// S^T = K Q^T and dP^T = V dO^T (Q's and dO's B fragments through plain
// ldmatrix), then dV += P^T dO and dK += dS^T Q (their B fragments through
// ldmatrix.trans of the row-major tiles).  An accumulator element holds
// one q column, whose lse and delta - g_lse are staged per q-tile in
// shared memory beside Q and dO.
//
// Registers.  K5 reads the A fragments of its rows (Q, dO) from the staged
// tiles, which stay in shared memory, at each k16 step: holding them in
// registers was no faster.  K4's layout is two template parameters: kHold,
// whether a warp loads the A fragments of its keys (K, V) once and holds
// them or reads them at each k16 step, and QC, the q columns of a pass over
// a q-tile.  At D <= 64 it holds them and makes one pass; at D = 128 that
// would not fit in 255 registers beside the D-wide accumulators, so it
// reads them and makes two 32-column passes, which halves its S^T and dP^T
// tiles.  The ptxas report (chip_smoke.py prints it) shows no spills;
// tools/flash_bwd_layouts.py times K4's four layouts at D = 64.

// s += a B1 and d += ao B2 for k16 step kk of NT n8 tiles whose columns
// are rows of the staged tiles t1 and t2 (B fragments through ldmatrix).
template <int D, int NT>
__device__ __forceinline__ void mma_rows_pair(float (&s)[NT][4], float (&d)[NT][4],
                                              const uint32_t (&a)[4], const uint32_t (&ao)[4],
                                              const bf16* t1, const bf16* t2, int kk) {
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    uint32_t b[4];
    ldsm_b<D>(b, t1, np, kk);
    mma_16816(s[2 * np], a, b[0], b[1]);
    mma_16816(s[2 * np + 1], a, b[2], b[3]);
    ldsm_b<D>(b, t2, np, kk);
    mma_16816(d[2 * np], ao, b[0], b[1]);
    mma_16816(d[2 * np + 1], ao, b[2], b[3]);
  }
}

// What thread t stages for the q-tile at q0: the lse of row q0 + t in log2
// units (t < 64), or delta - g_lse of row q0 + t - 64; zero past Sq.
__device__ __forceinline__ float row_value(const float* __restrict__ lse,
                                           const float* __restrict__ delta,
                                           const float* __restrict__ g_lse, int q0, int sq) {
  static_assert(kTcThreads == 2 * kTile, "one value a thread");
  const int r = q0 + (threadIdx.x & (kTile - 1));
  if (r >= sq) return 0.f;
  return threadIdx.x < kTile ? lse[r] * kLog2e : delta[r] - (g_lse ? g_lse[r] : 0.f);
}

template <int D>
constexpr size_t dq_mma_smem() {
  return 6 * tile_bytes<D>();  // Q, dO, two K and two V tiles
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const float* __restrict__ g_lse, bf16* __restrict__ dq, int n_bh,
                        int n_qtiles, int sq, int sk, float scale, bool causal) {
  constexpr int LD = ld_tile<D>();
  constexpr int KT = D / 16;     // k16 steps of Q K^T and dO V^T
  constexpr int NT = kTile / 8;  // n8 tiles of a score row block
  constexpr int DT = D / 8;      // n8 tiles of an output row block
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + kTile * LD;
  bf16* Ks = dOs + kTile * LD;     // two buffers
  bf16* Vs = Ks + 2 * kTile * LD;  // two buffers
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qr = lane >> 2, qc = lane & 3;  // the lane's row and column pair in a quad
  // the q-tiles with the most k-tiles first
  const int bh = blockIdx.x % n_bh;
  const int q0 = (n_qtiles - 1 - blockIdx.x / n_bh) * kTile;
  q += (size_t)bh * sq * D;
  dout += (size_t)bh * sq * D;
  dq += (size_t)bh * sq * D;
  k += (size_t)bh * sk * D;
  v += (size_t)bh * sk * D;
  lse += (size_t)bh * sq;
  delta += (size_t)bh * sq;
  if (g_lse) g_lse += (size_t)bh * sq;
  const int w0 = q0 + warp * 16;  // the warp's first row; the lane's are w0 + qr and + 8
  const int k_end = causal ? min(sk, q0 + kTile) : sk;
  const int nk = (k_end + kTile - 1) / kTile;
  const float scale2 = scale * kLog2e;

  load_tile_async<D>(Qs, q, q0, sq);
  load_tile_async<D>(dOs, dout, q0, sq);
  if (nk > 0) {
    load_tile_async<D>(Ks, k, 0, sk);
    load_tile_async<D>(Vs, v, 0, sk);
  }
  float lse2[2], dd[2];  // rows w0 + qr and + 8: lse in log2 units, delta - g_lse
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = w0 + qr + 8 * i;
    lse2[i] = r < sq ? lse[r] * kLog2e : 0.f;
    dd[i] = r < sq ? delta[r] - (g_lse ? g_lse[r] : 0.f) : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();
  bf16* Qw = Qs + warp * 16 * LD;  // the warp's rows
  const bf16* dOw = dOs + warp * 16 * LD;

  float acc[DT][4] = {};
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

    // S = Q K^T and dP = dO V^T
    float s[NT][4] = {}, dp[NT][4] = {};
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t a[4], ao[4];
      ldsm_a<D>(a, Qw, kk);
      ldsm_a<D>(ao, dOw, kk);
      mma_rows_pair<D>(s, dp, a, ao, Kb, Vb, kk);
    }
    // p and dS; element e of tile nt: row w0 + qr + 8*(e >> 1), key
    // k0 + 8*nt + 2*qc + (e & 1)
    const bool edge = k0 + kTile > sk || (causal && k0 + kTile - 1 > w0);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[nt][e], scale2, -lse2[e >> 1]));
        if (edge) {
          const int kj = k0 + nt * 8 + 2 * qc + (e & 1);
          const int qi = w0 + qr + (e >> 1) * 8;
          if (kj >= sk || (causal && kj > qi)) p = 0.f;
        }
        s[nt][e] = p * (dp[nt][e] - dd[e >> 1]) * scale;
      }

    // dQ += dS K: dS as hi + lo A fragments, K's B fragments through
    // ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t dh[4], dl[4];
      split_frag(s[2 * kk], s[2 * kk + 1], dh, dl);
#pragma unroll
      for (int n16 = 0; n16 < DT / 2; ++n16) {
        uint32_t b[4];
        ldsm_bt<D>(b, Kb, kk, n16);
        mma_16816(acc[2 * n16], dh, b[0], b[1]);
        mma_16816(acc[2 * n16], dl, b[0], b[1]);
        mma_16816(acc[2 * n16 + 1], dh, b[2], b[3]);
        mma_16816(acc[2 * n16 + 1], dl, b[2], b[3]);
      }
    }
  }
  store_rows<D>(dq, acc, 1.f, 1.f, Qw, w0, sq);
}

template <int D>
constexpr size_t dkdv_mma_smem() {
  // K, V, two Q and two dO tiles; lse and delta - g_lse rows of two q-tiles
  return 6 * tile_bytes<D>() + 2 * 2 * kTile * sizeof(float);
}

template <int D, bool kHold = (D <= 64), int QC = kHold ? kTile : kTile / 2>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const float* __restrict__ g_lse, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, int n_bh, int sq, int sk, float scale,
                          bool causal) {
  constexpr int LD = ld_tile<D>();
  constexpr int KT = D / 16;  // k16 steps of K Q^T and V dO^T
  constexpr int NT = QC / 8;  // n8 tiles of a pass's score row block (QC q columns)
  constexpr int DT = D / 8;   // n8 tiles of an output row block
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kTile * LD;
  bf16* Qs = Vs + kTile * LD;       // two buffers
  bf16* dOs = Qs + 2 * kTile * LD;  // two buffers
  // buffer b: lse in log2 units at rows_s[128 b ..], delta - g_lse at [128 b + 64 ..]
  float* rows_s = reinterpret_cast<float*>(dOs + 2 * kTile * LD);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qr = lane >> 2, qc = lane & 3;
  // k-tiles in order of k0: for causal, the most q-tiles first
  const int bh = blockIdx.x % n_bh;
  const int k0 = blockIdx.x / n_bh * kTile;
  q += (size_t)bh * sq * D;
  dout += (size_t)bh * sq * D;
  k += (size_t)bh * sk * D;
  v += (size_t)bh * sk * D;
  dk += (size_t)bh * sk * D;
  dv += (size_t)bh * sk * D;
  lse += (size_t)bh * sq;
  delta += (size_t)bh * sq;
  if (g_lse) g_lse += (size_t)bh * sq;
  const int kw0 = k0 + warp * 16;  // the warp's first key; the lane's are kw0 + qr and + 8
  const int q_begin = causal ? k0 : 0;  // q rows before k0 see none of the tile's keys
  const int nq = q_begin < sq ? (sq - q_begin + kTile - 1) / kTile : 0;
  const float scale2 = scale * kLog2e;

  load_tile_async<D>(Ks, k, k0, sk);
  load_tile_async<D>(Vs, v, k0, sk);
  if (nq > 0) {
    load_tile_async<D>(Qs, q, q_begin, sq);
    load_tile_async<D>(dOs, dout, q_begin, sq);
    rows_s[threadIdx.x] = row_value(lse, delta, g_lse, q_begin, sq);
  }
  cp_async_wait_all();
  __syncthreads();
  bf16* Kw = Ks + warp * 16 * LD;  // the warp's keys
  bf16* Vw = Vs + warp * 16 * LD;
  uint32_t kf[kHold ? KT : 1][4], vf[kHold ? KT : 1][4];
  if constexpr (kHold) {
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      ldsm_a<D>(kf[kk], Kw, kk);
      ldsm_a<D>(vf[kk], Vw, kk);
    }
  }

  float acc_dk[DT][4] = {}, acc_dv[DT][4] = {};
  for (int i = 0; i < nq; ++i) {
    const int q0 = q_begin + i * kTile;
    if (i > 0) {
      cp_async_wait_all();  // this thread's copies of q-tile i have landed
      __syncthreads();      // everyone's have, and q-tile i - 1 is no longer read
    }
    float next_row = 0.f;
    if (i + 1 < nq) {
      const int nb = (i + 1) & 1;
      load_tile_async<D>(Qs + nb * kTile * LD, q, q0 + kTile, sq);
      load_tile_async<D>(dOs + nb * kTile * LD, dout, q0 + kTile, sq);
      next_row = row_value(lse, delta, g_lse, q0 + kTile, sq);
    }
    const bf16* Qb = Qs + (i & 1) * kTile * LD;
    const bf16* dOb = dOs + (i & 1) * kTile * LD;
    const float* lse_b = rows_s + (i & 1) * 2 * kTile;
    const float* dd_b = lse_b + kTile;
    const bool edge = q0 + kTile > sq || (causal && kw0 + 15 > q0);
#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += QC) {
      // S^T = K Q^T and dP^T = V dO^T over q columns c0 .. c0 + QC - 1
      float st[NT][4] = {}, dpt[NT][4] = {};
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t a[4], av[4];
        if constexpr (kHold) {
#pragma unroll
          for (int j = 0; j < 4; ++j) a[j] = kf[kk][j], av[j] = vf[kk][j];
        } else {
          ldsm_a<D>(a, Kw, kk);
          ldsm_a<D>(av, Vw, kk);
        }
        mma_rows_pair<D>(st, dpt, a, av, Qb + c0 * LD, dOb + c0 * LD, kk);
      }
      // P^T and dS^T; element e of tile nt: key kw0 + qr + 8*(e >> 1),
      // q column q0 + c + (e & 1) with c = c0 + 8*nt + 2*qc
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = c0 + nt * 8 + 2 * qc;
        const float2 l2 = *reinterpret_cast<const float2*>(lse_b + c);
        const float2 d2 = *reinterpret_cast<const float2*>(dd_b + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(fmaf(st[nt][e], scale2, -((e & 1) ? l2.y : l2.x)));
          if (edge) {
            const int qi = q0 + c + (e & 1);
            const int kj = kw0 + qr + (e >> 1) * 8;
            if (qi >= sq || (causal && kj > qi)) p = 0.f;
          }
          dpt[nt][e] = p * (dpt[nt][e] - ((e & 1) ? d2.y : d2.x)) * scale;
          st[nt][e] = p;
        }
      }
      // dV += P^T dO and dK += dS^T Q: P^T and dS^T as hi + lo A
      // fragments, dO's and Q's B fragments through ldmatrix.trans.  The
      // two products share a loop: in two loops ptxas spills at D = 128.
#pragma unroll
      for (int kk = 0; kk < QC / 16; ++kk) {
        uint32_t ph[4], pl[4], sh[4], sl[4];
        split_frag(st[2 * kk], st[2 * kk + 1], ph, pl);
        split_frag(dpt[2 * kk], dpt[2 * kk + 1], sh, sl);
#pragma unroll
        for (int n16 = 0; n16 < DT / 2; ++n16) {
          uint32_t b[4];
          ldsm_bt<D>(b, dOb + c0 * LD, kk, n16);
          mma_16816(acc_dv[2 * n16], ph, b[0], b[1]);
          mma_16816(acc_dv[2 * n16], pl, b[0], b[1]);
          mma_16816(acc_dv[2 * n16 + 1], ph, b[2], b[3]);
          mma_16816(acc_dv[2 * n16 + 1], pl, b[2], b[3]);
          ldsm_bt<D>(b, Qb + c0 * LD, kk, n16);
          mma_16816(acc_dk[2 * n16], sh, b[0], b[1]);
          mma_16816(acc_dk[2 * n16], sl, b[0], b[1]);
          mma_16816(acc_dk[2 * n16 + 1], sh, b[2], b[3]);
          mma_16816(acc_dk[2 * n16 + 1], sl, b[2], b[3]);
        }
      }
    }
    // q-tile i - 1's rows buffer is free since the __syncthreads above
    if (i + 1 < nq) rows_s[((i + 1) & 1) * 2 * kTile + threadIdx.x] = next_row;
  }
  store_rows<D>(dk, acc_dk, 1.f, 1.f, Kw, kw0, sk);
  store_rows<D>(dv, acc_dv, 1.f, 1.f, Vw, kw0, sk);
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

// Launch a bf16 tensor-core kernel, with a hint to give the SM the most
// shared memory it can, so more blocks fit.
template <typename K, typename... Args>
cudaError_t launch_tc(K kernel, int blocks, size_t smem, cudaStream_t s, Args... args) {
  const cudaError_t carve = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, (int)cudaSharedmemCarveoutMaxShared);
  if (carve != cudaSuccess) return carve;
  return launch(kernel, blocks, kTcThreads, smem, s, args...);
}

inline int tiles(int n) { return (n + kTile - 1) / kTile; }

// dtype 0: float32 on the CUDA cores; dtype 1: bfloat16 on the tensor cores.
template <int D>
cudaError_t launch_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
                       float* lse, int bh, int sq, int sk, float scale, bool causal,
                       cudaStream_t s) {
  const int nq = tiles(sq);
  if (dtype == 1)
    return launch_tc(flash_fwd_mma_kernel<D>, bh * nq, fwd_mma_smem<D>(), s, (const bf16*)q,
                     (const bf16*)k, (const bf16*)v, (bf16*)o, lse, bh, nq, sq, sk, scale,
                     causal);
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
    return launch_tc(flash_bwd_dkdv_mma_kernel<D>, bh * nk, dkdv_mma_smem<D>(), s,
                     (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse,
                     delta, g_lse, (bf16*)dk, (bf16*)dv, bh, sq, sk, scale, causal);
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
    return launch_tc(flash_bwd_dq_mma_kernel<D>, bh * nq, dq_mma_smem<D>(), s,
                     (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse,
                     delta, g_lse, (bf16*)dq, bh, nq, sq, sk, scale, causal);
  return launch(flash_bwd_dq_kernel<D>, bh * nq, kThreads, dq_smem<D>(), s,
                (const float*)q, (const float*)k, (const float*)v, (const float*)dout, lse,
                delta, g_lse, (float*)dq, nq, sq, sk, scale, causal);
}

// Dispatch on the head dim (16, 32, 64 and 128 are compiled) and dtype (0
// or 1).  At D = 16 every loop above runs whole: one k16 step (KT = 1),
// two n8 output tiles (DT = 2), two 16-byte chunks a row, so one cp.async a
// thread per 64-row tile and one 16-byte store a lane in store_rows; a
// staged row is 24 elements (48 bytes), still a multiple of 16 bytes for
// cp.async and ldmatrix, and its 12-bank stride keeps the 8 rows of an
// ldmatrix on distinct banks.  K4 holds K and V in registers and makes one
// 64-column pass, as at D <= 64.
#define FF_DISPATCH(FN, ...)                                                   \
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;             \
  switch (d) {                                                                 \
    case 16: return (int)FN<16>(dtype, __VA_ARGS__);                           \
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
