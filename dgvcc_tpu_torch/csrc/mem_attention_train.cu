// Two-view prototype-memory attention for training, on Hopper (sm_90a):
// the forward and the backward of
//
//     p_i   = softmax_S(y_i . M / sqrt(K))             (f32)      i = 1, 2
//     out_i = (p_i rounded to M's type) . M^T          (f32 accumulation)
//     loss  = mean_{rows, S} (p_1 - p_2)^2
//
// y_i: (rows, K) row-major, M: (K, S) row-major, out_i in y's type.
//
// Replaces the Pallas TPU kernels of dgvcc_tpu/ops/mem_attention_train.py:
//   * mem_attention_train_fwd replaces _fwd_kernel (pallas_call in
//     _make_op._fwd): the kernel mat_fwd_* below, then sum_partials;
//   * mem_attention_train_bwd replaces _bwd_kernel (pallas_call in
//     _make_op.bwd_rule): mat_bwd_rows_*, mat_bwd_cols_*, then
//     reduce_splits.
// The TPU kernels hold all of M in VMEM and run their grid in order,
// carrying the loss and dM from one grid step to the next. Hopper blocks
// run in no order and a block has 227 KB of shared memory, so here M
// streams through shared memory in S-chunks and every cross-block sum is
// written per block and then reduced in a fixed order by a second launch:
// no float atomics, the results are deterministic.
//
// Forward. A block takes 64 rows of BOTH views: 8 warps, warps 0-3 view 1
// and warps 4-7 view 2, 16 rows each, so a lane of warp w and the same lane
// of warp w + 4 hold the same (row, s) of the two views. Two sweeps over S:
// (1) each row's max and sum; (2) exact normalized p in f32, the loss term
// (p1 - p2)^2 (view 2 hands its p to view 1 through shared memory), and
// out_i += round_bf16(p_i) . M^T. Each row's logsumexp is saved for the
// backward (2 x rows f32). sum_partials adds the per-block loss terms in
// a fixed order (one block) and divides by rows * S.
//
// Backward (g = the loss's cotangent, gc = 2 g / (rows * S), D = <dp, p>_S):
//     dp_i = dout_i . M  +/-  gc (p1 - p2)
//     dl_i = p_i (dp_i - D_i)
//     dy_i = dl_i . M^T / sqrt(K)
//     dM   = sum_i dout_i^T . round(p_i) + y_i^T . dl_i / sqrt(K)
//   (a) mat_bwd_rows: per 64-row tile of both views, p from the saved
//       logsumexp; one sweep over S for D, a second for dl and dy. Writes
//       dy and D.
//   (b) mat_bwd_cols: a block owns a (K x 64) slice of dM and a range of
//       row tiles (`splits` ranges, so 16 S-tiles x splits blocks fill the
//       card); it recomputes p and dl on its slice and writes its partial
//       dM to a (splits, K, S) f32 scratch.
//   (c) reduce_splits sums the scratch over splits in order.
// dl is rounded to bf16 (after the 1/sqrt(K) scale, a power of two at
// K = 16, 64, 256) for the tensor-core products dl . M^T and y^T . dl.
//
// Bound on the H100 at the training shapes (B = 16, P = 6400, K = 256,
// S = 1024, bf16; scripts/kernel_bounds.py, the work the TPU kernels do):
// forward 214.7 GFLOP / 210.2 MB -> 0.2171 ms; backward 536.9 GFLOP /
// 316.1 MB -> 0.5428 ms, both bound by the tensor cores. This design does
// more products than that count: the forward computes the logits twice
// (6 products of rows x K x S per view pair instead of 4: 322.1 GFLOP,
// 1.5x), the backward recomputes the logits and dout . M in both (a) and
// (b) and takes one extra sweep for D (18 products instead of 10:
// 966.4 GFLOP, 1.8x). In exchange nothing of size rows x S ever reaches
// device memory: 16 x 6400 x 1024 f32 is 419 MB per tensor.
//
// f32 kernels: the same structure in plain f32 FMA on the CUDA cores (no
// TF32), 32 rows a block, 4 threads a row, for holding the kernels against
// the plain version at 1e-4.
//
// Any number of rows (masked tail) and any S (masked tail); K in {16, 256}.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using namespace mma_sm90;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // every kernel: 8 warps
constexpr int kRows = 64;      // bf16: rows of each view per block, 16 a warp
constexpr int kChunkF = 64;    // bf16 forward: prototypes per S-chunk
constexpr int kChunkB = 32;    // bf16 backward rows: prototypes per S-chunk
constexpr int kCols = 64;      // bf16 backward cols: the block's S-slice
constexpr int kRowsF32 = 32;   // f32: rows of each view per block
constexpr int kColsF32 = 32;   // f32: prototypes per S-chunk / S-slice

template <int K>
__host__ __device__ constexpr int ld_rows() { return K + 8; }  // bf16 pitch of a row tile

// 64 rows of a (rows, K) bf16 array -> shared (pitch K + 8), rows past the
// end zero-filled (cp.async)
template <int K>
__device__ void load_rows(const bf16* __restrict__ src, int64_t rows, int64_t row0,
                          bf16* dst) {
  constexpr int kVec = K / 8;
  for (int i = threadIdx.x; i < kRows * kVec; i += kThreads) {
    const int r = i / kVec, v = i % kVec;
    const bool in = row0 + r < rows;
    cp_async16(dst + r * ld_rows<K>() + v * 8, in ? src + (row0 + r) * K + v * 8 : src,
               in ? 16 : 0);
  }
}

// acc[kN/8][4] = A(16 rows x K, shared, pitch K + 8) . Mc(K x kN, shared,
// pitch kN + 8); `a` is the warp's first row
template <int K, int kN>
__device__ __forceinline__ void rows_x_m(const bf16* a, const bf16* mc, int lane,
                                         float (&acc)[kN / 8][4]) {
  constexpr int kLdM = kN + 8;
  const int mi = lane >> 3, mr = lane & 7;
  const bf16* pa = a + ((mi & 1) * 8 + mr) * ld_rows<K>() + (mi >> 1) * 8;
#pragma unroll
  for (int n = 0; n < kN / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t fa[4];
    ldmatrix_x4(fa, pa + kk * 16);
#pragma unroll
    for (int np = 0; np < kN / 16; ++np) {
      uint32_t fb[4];
      ldmatrix_x4_trans(fb, mc + (kk * 16 + (mi & 1) * 8 + mr) * kLdM + np * 16 + (mi >> 1) * 8);
      mma_bf16(acc[2 * np], fa, fb[0], fb[1]);
      mma_bf16(acc[2 * np + 1], fa, fb[2], fb[3]);
    }
  }
}

// o[K/8][4] += round_bf16(x)(16 x kN) . Mc^T, x in the accumulator layout
template <int K, int kN>
__device__ __forceinline__ void p_x_mt(const float (&x)[kN / 8][4], const bf16* mc,
                                       int lane, float (&o)[K / 8][4]) {
  constexpr int kLdM = kN + 8;
  const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int j = 0; j < kN / 16; ++j) {
    uint32_t fa[4];
    fa[0] = pack_bf16(x[2 * j][0], x[2 * j][1]);
    fa[1] = pack_bf16(x[2 * j][2], x[2 * j][3]);
    fa[2] = pack_bf16(x[2 * j + 1][0], x[2 * j + 1][1]);
    fa[3] = pack_bf16(x[2 * j + 1][2], x[2 * j + 1][3]);
#pragma unroll
    for (int np = 0; np < K / 16; ++np) {
      uint32_t fb[4];
      ldmatrix_x4(fb, mc + (np * 16 + (mi >> 1) * 8 + mr) * kLdM + j * 16 + (mi & 1) * 8);
      mma_bf16(o[2 * np], fa, fb[0], fb[1]);
      mma_bf16(o[2 * np + 1], fa, fb[2], fb[3]);
    }
  }
}

// the warp's 16 x K accumulator -> bf16 rows of `out`, staged through the
// warp's own 16 rows of a shared row tile
template <int K>
__device__ void store_rows(const float (&o)[K / 8][4], bf16* stage,
                           bf16* __restrict__ out, int64_t rows, int64_t row0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  constexpr int kLd = ld_rows<K>();
#pragma unroll
  for (int n = 0; n < K / 8; ++n) {
    *reinterpret_cast<uint32_t*>(stage + g * kLd + n * 8 + 2 * t) =
        pack_bf16(o[n][0], o[n][1]);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * kLd + n * 8 + 2 * t) =
        pack_bf16(o[n][2], o[n][3]);
  }
  __syncwarp();
  for (int i = lane; i < 16 * (K / 8); i += 32) {
    const int r = i / (K / 8), v = i % (K / 8);
    if (row0 + r < rows)
      *reinterpret_cast<uint4*>(out + (row0 + r) * K + v * 8) =
          *reinterpret_cast<const uint4*>(stage + r * kLd + v * 8);
  }
}

// sum over a block's 256 threads into thread 0 (fixed order); `red` (8
// floats of shared memory) may be a buffer the block was still reading
__device__ float block_sum(float v, float* red) {
  __syncthreads();
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  return s;
}

// ============================================================ bf16 forward
template <int K>
struct FwdSmem {
  static constexpr size_t tile = size_t(kRows) * ld_rows<K>() * 2;
  static constexpr size_t stage = size_t(K) * (kChunkF + 8) * 2;
  static constexpr size_t y = 0;                    // 2 row tiles (views)
  static constexpr size_t m = 2 * tile;             // 2 M stages
  static constexpr size_t x = m + 2 * stage;        // p exchange, f32
  static constexpr size_t bytes = x + size_t(4) * (kChunkF / 2) * 32 * 4;
};

template <int K>
__global__ void __launch_bounds__(kThreads, 1)
mat_fwd_bf16(const bf16* __restrict__ y1, const bf16* __restrict__ y2,
             const bf16* __restrict__ mem, bf16* __restrict__ out1,
             bf16* __restrict__ out2, float* __restrict__ lse,
             float* __restrict__ partial, int64_t rows, int S, float scale) {
  using L = FwdSmem<K>;
  constexpr int kN = kChunkF;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ys = reinterpret_cast<bf16*>(smem + L::y);
  bf16* ms = reinterpret_cast<bf16*>(smem + L::m);
  float* xch = reinterpret_cast<float*>(smem + L::x);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int view = warp >> 2, wr = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int64_t row0 = int64_t(blockIdx.x) * kRows;
  const int n_chunks = (S + kN - 1) / kN;
  constexpr int kStage = K * (kN + 8);

  load_rows<K>(y1, rows, row0, ys);
  load_rows<K>(y2, rows, row0, ys + kRows * ld_rows<K>());
  load_m_chunk<K, kN, kThreads>(mem, S, 0, ms);
  cp_async_commit();

  const bf16* ya = ys + (view * kRows + wr * 16) * ld_rows<K>();
  float* xw = xch + wr * (kN / 2) * 32;
  float o[K / 8][4];
#pragma unroll
  for (int n = 0; n < K / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f}, inv_l[2];
  float loss = 0.f;
  const bool valid[2] = {row0 + wr * 16 + g < rows, row0 + wr * 16 + g + 8 < rows};

  // sweep 1 (it < n_chunks): row max and sum; sweep 2: p, loss, out
  for (int it = 0; it < 2 * n_chunks; ++it) {
    const int c = it % n_chunks, s0 = c * kN;
    const bf16* mc = ms + (it & 1) * kStage;
    if (it + 1 < 2 * n_chunks) {
      load_m_chunk<K, kN, kThreads>(mem, S, ((it + 1) % n_chunks) * kN,
                                    ms + ((it + 1) & 1) * kStage);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float sc[kN / 8][4];
    rows_x_m<K, kN>(ya, mc, lane, sc);
#pragma unroll
    for (int n = 0; n < kN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[n][e] = s0 + n * 8 + 2 * t + (e & 1) < S ? sc[n][e] * scale : -INFINITY;

    if (it < n_chunks) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < kN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m_run[h], mx[h]);
        l_run[h] *= __expf(m_run[h] - m_new);
        m_run[h] = m_new;
      }
#pragma unroll
      for (int n = 0; n < kN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) l_run[e >> 1] += __expf(sc[n][e] - m_run[e >> 1]);
    } else {
      if (it == n_chunks) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
          l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
          inv_l[h] = 1.f / l_run[h];
        }
      }
#pragma unroll
      for (int n = 0; n < kN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[n][e] = __expf(sc[n][e] - m_run[e >> 1]) * inv_l[e >> 1];
      if (view == 1) {
#pragma unroll
        for (int n = 0; n < kN / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) xw[(n * 4 + e) * 32 + lane] = sc[n][e];
      }
      __syncthreads();
      if (view == 0) {
#pragma unroll
        for (int n = 0; n < kN / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float d = sc[n][e] - xw[(n * 4 + e) * 32 + lane];
            loss += valid[e >> 1] ? d * d : 0.f;
          }
      }
      p_x_mt<K, kN>(sc, mc, lane, o);
    }
    __syncthreads();  // stage and exchange are free for the next chunk
  }

  store_rows<K>(o, const_cast<bf16*>(ya), view ? out2 : out1, rows,
                row0 + wr * 16, lane);
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (valid[h])
        lse[view * rows + row0 + wr * 16 + g + 8 * h] = m_run[h] + logf(l_run[h]);
  }
  const float s = block_sum(loss, xch);
  if (threadIdx.x == 0) partial[blockIdx.x] = s;
}

// ====================================================== bf16 backward rows
template <int K>
struct RowsSmem {
  static constexpr size_t tile = size_t(kRows) * ld_rows<K>() * 2;
  static constexpr size_t stage = size_t(K) * (kChunkB + 8) * 2;
  static constexpr size_t y = 0;                    // 2 row tiles of y
  static constexpr size_t dout = 2 * tile;          // 2 row tiles of dout
  static constexpr size_t m = 4 * tile;             // 2 M stages
  static constexpr size_t x = m + 2 * stage;        // exchange, f32
  static constexpr size_t bytes = x + size_t(4) * (kChunkB / 2) * 32 * 4;
};

// p (exact, from the saved logsumexp) and dp = dout . M +/- gc (p1 - p2)
// of the warp's 16 rows on one S-chunk; the views trade p through `xw`
template <int K, int kN>
__device__ __forceinline__ void p_and_dp(const bf16* ya, const bf16* da, const bf16* mc,
                                         int lane, int view, int s0, int S, float scale,
                                         const float (&lse_r)[2], float gc, float* xw,
                                         float (&p)[kN / 8][4], float (&dp)[kN / 8][4]) {
  const int t = lane & 3;
  rows_x_m<K, kN>(ya, mc, lane, p);
  rows_x_m<K, kN>(da, mc, lane, dp);
#pragma unroll
  for (int n = 0; n < kN / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p[n][e] = s0 + n * 8 + 2 * t + (e & 1) < S ? __expf(p[n][e] * scale - lse_r[e >> 1])
                                                 : 0.f;
  if (view == 1) {
#pragma unroll
    for (int n = 0; n < kN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) xw[(n * 4 + e) * 32 + lane] = p[n][e];
  }
  __syncthreads();
  if (view == 0) {
#pragma unroll
    for (int n = 0; n < kN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d = p[n][e] - xw[(n * 4 + e) * 32 + lane];
        xw[(n * 4 + e) * 32 + lane] = d;
        dp[n][e] += gc * d;
      }
  }
  __syncthreads();
  if (view == 1) {
#pragma unroll
    for (int n = 0; n < kN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[n][e] -= gc * xw[(n * 4 + e) * 32 + lane];
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads, 1)
mat_bwd_rows_bf16(const bf16* __restrict__ y1, const bf16* __restrict__ y2,
                  const bf16* __restrict__ mem, const bf16* __restrict__ do1,
                  const bf16* __restrict__ do2, const float* __restrict__ lse,
                  const float* __restrict__ g_ct, bf16* __restrict__ dy1,
                  bf16* __restrict__ dy2, float* __restrict__ dsum, int64_t rows,
                  int S, float scale, float inv_n2) {
  using L = RowsSmem<K>;
  constexpr int kN = kChunkB;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ys = reinterpret_cast<bf16*>(smem + L::y);
  bf16* ds = reinterpret_cast<bf16*>(smem + L::dout);
  bf16* ms = reinterpret_cast<bf16*>(smem + L::m);
  float* xch = reinterpret_cast<float*>(smem + L::x);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int view = warp >> 2, wr = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int64_t row0 = int64_t(blockIdx.x) * kRows;
  const int n_chunks = (S + kN - 1) / kN;
  constexpr int kStage = K * (kN + 8);
  const float gc = *g_ct * inv_n2;

  load_rows<K>(y1, rows, row0, ys);
  load_rows<K>(y2, rows, row0, ys + kRows * ld_rows<K>());
  load_rows<K>(do1, rows, row0, ds);
  load_rows<K>(do2, rows, row0, ds + kRows * ld_rows<K>());
  load_m_chunk<K, kN, kThreads>(mem, S, 0, ms);
  cp_async_commit();

  const int off = (view * kRows + wr * 16) * ld_rows<K>();
  const bf16* ya = ys + off;
  const bf16* da = ds + off;
  float* xw = xch + wr * (kN / 2) * 32;
  int64_t row[2];
  float lse_r[2], dsum_r[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = row0 + wr * 16 + g + 8 * h;
    lse_r[h] = row[h] < rows ? lse[view * rows + row[h]] : INFINITY;
  }
  float o[K / 8][4];
#pragma unroll
  for (int n = 0; n < K / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  // sweep 1 (it < n_chunks): D = <dp, p>_S; sweep 2: dl and dy
  for (int it = 0; it < 2 * n_chunks; ++it) {
    const int s0 = (it % n_chunks) * kN;
    const bf16* mc = ms + (it & 1) * kStage;
    if (it + 1 < 2 * n_chunks) {
      load_m_chunk<K, kN, kThreads>(mem, S, ((it + 1) % n_chunks) * kN,
                                    ms + ((it + 1) & 1) * kStage);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float p[kN / 8][4], dp[kN / 8][4];
    p_and_dp<K, kN>(ya, da, mc, lane, view, s0, S, scale, lse_r, gc, xw, p, dp);
    if (it < n_chunks) {
#pragma unroll
      for (int n = 0; n < kN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dsum_r[e >> 1] += dp[n][e] * p[n][e];
    } else {
      if (it == n_chunks) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          dsum_r[h] += __shfl_xor_sync(0xffffffffu, dsum_r[h], 1);
          dsum_r[h] += __shfl_xor_sync(0xffffffffu, dsum_r[h], 2);
          if (t == 0 && row[h] < rows) dsum[view * rows + row[h]] = dsum_r[h];
        }
      }
#pragma unroll
      for (int n = 0; n < kN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[n][e] = p[n][e] * (dp[n][e] - dsum_r[e >> 1]) * scale;  // dl / sqrt(K)
      p_x_mt<K, kN>(p, mc, lane, o);
    }
    __syncthreads();
  }
  store_rows<K>(o, const_cast<bf16*>(ya), view ? dy2 : dy1, rows, row0 + wr * 16,
                lane);
}

// ====================================================== bf16 backward cols
template <int K>
struct ColsSmem {
  static constexpr int kLdP = kCols + 8;
  static constexpr size_t tile = size_t(kRows) * ld_rows<K>() * 2;
  static constexpr size_t ptile = size_t(kRows) * kLdP * 2;
  static constexpr size_t m = 0;                               // M slice
  static constexpr size_t y = size_t(K) * kLdP * 2;            // 2 row tiles of y
  static constexpr size_t dout = y + 2 * tile;                 // 2 row tiles of dout
  static constexpr size_t ph = dout + 2 * tile;                // 2 tiles of round(p)
  static constexpr size_t dl = ph + 2 * ptile;                 // 2 tiles of dl/sqrt(K)
  static constexpr size_t x = dl + 2 * ptile;                  // exchange, f32
  static constexpr size_t bytes = x + size_t(4) * (kCols / 2) * 32 * 4;
};

template <int K>
__global__ void __launch_bounds__(kThreads, 1)
mat_bwd_cols_bf16(const bf16* __restrict__ y1, const bf16* __restrict__ y2,
                  const bf16* __restrict__ mem, const bf16* __restrict__ do1,
                  const bf16* __restrict__ do2, const float* __restrict__ lse,
                  const float* __restrict__ dsum, const float* __restrict__ g_ct,
                  float* __restrict__ scratch, int64_t rows, int S, float scale,
                  float inv_n2, int tiles_per_split) {
  static_assert(kCols / 8 == kThreads / 32, "one n8 column tile of dM per warp");
  using L = ColsSmem<K>;
  constexpr int kLd = ld_rows<K>(), kLdP = L::kLdP;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ms = reinterpret_cast<bf16*>(smem + L::m);
  bf16* ys = reinterpret_cast<bf16*>(smem + L::y);
  bf16* ds = reinterpret_cast<bf16*>(smem + L::dout);
  bf16* ps = reinterpret_cast<bf16*>(smem + L::ph);
  bf16* ls = reinterpret_cast<bf16*>(smem + L::dl);
  float* xch = reinterpret_cast<float*>(smem + L::x);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int view = warp >> 2, wr = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;
  const int s0 = blockIdx.x * kCols;
  const int n_tiles = int((rows + kRows - 1) / kRows);
  const int tile0 = blockIdx.y * tiles_per_split;
  const int tile1 = min(n_tiles, tile0 + tiles_per_split);
  const float gc = *g_ct * inv_n2;

  load_m_chunk<K, kCols, kThreads>(mem, S, s0, ms);
  cp_async_commit();
  const int off = (view * kRows + wr * 16) * kLd;
  const int poff = (view * kRows + wr * 16) * kLdP;
  float* xw = xch + wr * (kCols / 2) * 32;
  float acc[K / 16][4];  // dM rows mt*16 + (g, g+8), columns s0 + 8 warp + 2t (+1)
#pragma unroll
  for (int mt = 0; mt < K / 16; ++mt) acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;

  for (int tile = tile0; tile < tile1; ++tile) {
    const int64_t row0 = int64_t(tile) * kRows;
    load_rows<K>(y1, rows, row0, ys);
    load_rows<K>(y2, rows, row0, ys + kRows * kLd);
    load_rows<K>(do1, rows, row0, ds);
    load_rows<K>(do2, rows, row0, ds + kRows * kLd);
    cp_async_commit();
    float lse_r[2], dsum_r[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t row = row0 + wr * 16 + g + 8 * h;
      lse_r[h] = row < rows ? lse[view * rows + row] : INFINITY;
      dsum_r[h] = row < rows ? dsum[view * rows + row] : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();
    float p[kCols / 8][4], dp[kCols / 8][4];
    p_and_dp<K, kCols>(ys + off, ds + off, ms, lane, view, s0, S, scale, lse_r, gc, xw,
                       p, dp);
    bf16* pw = ps + poff;
    bf16* lw = ls + poff;
#pragma unroll
    for (int n = 0; n < kCols / 8; ++n) {
      *reinterpret_cast<uint32_t*>(pw + g * kLdP + n * 8 + 2 * t) = pack_bf16(p[n][0], p[n][1]);
      *reinterpret_cast<uint32_t*>(pw + (g + 8) * kLdP + n * 8 + 2 * t) =
          pack_bf16(p[n][2], p[n][3]);
#pragma unroll
      for (int e = 0; e < 4; ++e) p[n][e] = p[n][e] * (dp[n][e] - dsum_r[e >> 1]) * scale;
      *reinterpret_cast<uint32_t*>(lw + g * kLdP + n * 8 + 2 * t) = pack_bf16(p[n][0], p[n][1]);
      *reinterpret_cast<uint32_t*>(lw + (g + 8) * kLdP + n * 8 + 2 * t) =
          pack_bf16(p[n][2], p[n][3]);
    }
    __syncthreads();
    // dM[:, this warp's 8 columns] += dout^T . round(p) + y^T . dl / sqrt(K),
    // the tile's 64 rows of both views as the reduction axis
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const bf16* dv = ds + v * kRows * kLd;
      const bf16* yv = ys + v * kRows * kLd;
#pragma unroll
      for (int kk = 0; kk < kRows / 32; ++kk) {
        uint32_t bp[4], bl[4];
        const int prow = (v * kRows + kk * 32 + mi * 8 + mr) * kLdP + warp * 8;
        ldmatrix_x4_trans(bp, ps + prow);
        ldmatrix_x4_trans(bl, ls + prow);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = kk * 32 + half * 16 + (mi >> 1) * 8 + mr;
#pragma unroll
          for (int mt = 0; mt < K / 16; ++mt) {
            uint32_t fa[4];
            ldmatrix_x4_trans(fa, dv + r * kLd + mt * 16 + (mi & 1) * 8);
            mma_bf16(acc[mt], fa, bp[2 * half], bp[2 * half + 1]);
            ldmatrix_x4_trans(fa, yv + r * kLd + mt * 16 + (mi & 1) * 8);
            mma_bf16(acc[mt], fa, bl[2 * half], bl[2 * half + 1]);
          }
        }
      }
    }
    __syncthreads();  // row tiles and p / dl tiles are free for the next tile
  }
  cp_async_wait<0>();  // a block with no row tile still waits for its M slice
  float* dst = scratch + size_t(blockIdx.y) * K * S;
#pragma unroll
  for (int mt = 0; mt < K / 16; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = mt * 16 + g + 8 * (e >> 1), s = s0 + warp * 8 + 2 * t + (e & 1);
      if (s < S) dst[size_t(k) * S + s] = acc[mt][e];
    }
}

// ========================================================== f32 / CUDA cores
// Thread (view, r, q): row r of its view's 32-row tile, columns q + 4j of
// an S-chunk (4 threads a row, consecutive lanes).
constexpr int kLdC = kColsF32 + 1;

template <int K>
__device__ void f32_load_rows(const float* __restrict__ src, int64_t rows, int64_t row0,
                              float* dst) {
  for (int i = threadIdx.x; i < kRowsF32 * K; i += kThreads) {
    const int r = i / K, k = i % K;
    dst[r * (K + 1) + k] = row0 + r < rows ? src[(row0 + r) * K + k] : 0.f;
  }
}

template <int K>
__device__ void f32_load_m(const float* __restrict__ mem, int S, int s0, float* dst) {
  for (int i = threadIdx.x; i < K * kColsF32; i += kThreads) {
    const int k = i / kColsF32, s = i % kColsF32;
    dst[k * kLdC + s] = s0 + s < S ? mem[int64_t(k) * S + s0 + s] : 0.f;
  }
}

template <int K>
__device__ __forceinline__ void f32_row_x_m(const float* a, const float* mc, int q,
                                            float (&acc)[kColsF32 / 4]) {
#pragma unroll
  for (int j = 0; j < kColsF32 / 4; ++j) acc[j] = 0.f;
  for (int k = 0; k < K; ++k) {
    const float x = a[k];
#pragma unroll
    for (int j = 0; j < kColsF32 / 4; ++j) acc[j] = fmaf(x, mc[k * kLdC + q + 4 * j], acc[j]);
  }
}

// the f32 twin of p_and_dp; `xr` is row r of the exchange tile
template <int K>
__device__ __forceinline__ void f32_p_and_dp(const float* ya, const float* da,
                                             const float* mc, int q, int view, int s0,
                                             int S, float scale, float lse_r, float gc,
                                             float* xr, float (&p)[kColsF32 / 4],
                                             float (&dp)[kColsF32 / 4]) {
  f32_row_x_m<K>(ya, mc, q, p);
  f32_row_x_m<K>(da, mc, q, dp);
#pragma unroll
  for (int j = 0; j < kColsF32 / 4; ++j)
    p[j] = s0 + q + 4 * j < S ? expf(p[j] * scale - lse_r) : 0.f;
  if (view == 1)
#pragma unroll
    for (int j = 0; j < kColsF32 / 4; ++j) xr[q + 4 * j] = p[j];
  __syncthreads();
  if (view == 0)
#pragma unroll
    for (int j = 0; j < kColsF32 / 4; ++j) {
      const float d = p[j] - xr[q + 4 * j];
      xr[q + 4 * j] = d;
      dp[j] += gc * d;
    }
  __syncthreads();
  if (view == 1)
#pragma unroll
    for (int j = 0; j < kColsF32 / 4; ++j) dp[j] -= gc * xr[q + 4 * j];
}

// acc[i] += sum_s x[s] M[q + 4i, s] over the chunk; x[s] lives in lane q = s % 4
template <int K>
__device__ __forceinline__ void f32_x_mt(const float (&x)[kColsF32 / 4], const float* mc,
                                         int q, unsigned group, float (&acc)[K / 4]) {
#pragma unroll
  for (int s = 0; s < kColsF32; ++s) {
    const float v = __shfl_sync(0xffffffffu, x[s / 4], group | (s % 4));
#pragma unroll
    for (int i = 0; i < K / 4; ++i) acc[i] = fmaf(v, mc[(q + 4 * i) * kLdC + s], acc[i]);
  }
}

template <int K>
__host__ __device__ constexpr size_t f32_tile_floats() {
  return size_t(kRowsF32) * (K + 1);
}

template <int K>
__global__ void __launch_bounds__(kThreads, 1)
mat_fwd_f32(const float* __restrict__ y1, const float* __restrict__ y2,
            const float* __restrict__ mem, float* __restrict__ out1,
            float* __restrict__ out2, float* __restrict__ lse,
            float* __restrict__ partial, int64_t rows, int S, float scale) {
  extern __shared__ float fsm[];
  float* ys = fsm;                                // 2 row tiles
  float* ms = ys + 2 * f32_tile_floats<K>();      // K x kLdC
  float* xs = ms + K * kLdC;                      // 32 x kLdC exchange
  const int view = threadIdx.x / 128, r = (threadIdx.x % 128) / 4, q = threadIdx.x % 4;
  const unsigned group = (threadIdx.x & 31) & ~3u;
  const int64_t row = int64_t(blockIdx.x) * kRowsF32 + r;
  const bool valid = row < rows;
  f32_load_rows<K>(y1, rows, row - r, ys);
  f32_load_rows<K>(y2, rows, row - r, ys + f32_tile_floats<K>());
  const float* ya = ys + view * f32_tile_floats<K>() + r * (K + 1);
  const int n_chunks = (S + kColsF32 - 1) / kColsF32;
  float m_run = -INFINITY, l_run = 0.f, loss = 0.f;
  float acc[K / 4];
#pragma unroll
  for (int i = 0; i < K / 4; ++i) acc[i] = 0.f;

  for (int pass = 0; pass < 2; ++pass) {
    const float inv_l = pass ? 1.f / l_run : 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      const int s0 = c * kColsF32;
      __syncthreads();
      f32_load_m<K>(mem, S, s0, ms);
      __syncthreads();
      float lg[kColsF32 / 4];
      f32_row_x_m<K>(ya, ms, q, lg);
#pragma unroll
      for (int j = 0; j < kColsF32 / 4; ++j)
        lg[j] = s0 + q + 4 * j < S ? lg[j] * scale : -INFINITY;
      if (pass == 0) {
        float cmax = -INFINITY;
#pragma unroll
        for (int j = 0; j < kColsF32 / 4; ++j) cmax = fmaxf(cmax, lg[j]);
        cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, 1));
        cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, 2));
        const float m_new = fmaxf(m_run, cmax);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kColsF32 / 4; ++j) sum += expf(lg[j] - m_new);
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l_run = l_run * expf(m_run - m_new) + sum;
        m_run = m_new;
      } else {
#pragma unroll
        for (int j = 0; j < kColsF32 / 4; ++j) lg[j] = expf(lg[j] - m_run) * inv_l;
        if (view == 1)
#pragma unroll
          for (int j = 0; j < kColsF32 / 4; ++j) xs[r * kLdC + q + 4 * j] = lg[j];
        __syncthreads();
        if (view == 0 && valid)
#pragma unroll
          for (int j = 0; j < kColsF32 / 4; ++j) {
            const float d = lg[j] - xs[r * kLdC + q + 4 * j];
            loss += d * d;
          }
        f32_x_mt<K>(lg, ms, q, group, acc);
      }
    }
  }
  if (valid) {
    float* out = view ? out2 : out1;
#pragma unroll
    for (int i = 0; i < K / 4; ++i) out[row * K + q + 4 * i] = acc[i];
    if (q == 0) lse[view * rows + row] = m_run + logf(l_run);
  }
  const float s = block_sum(loss, xs);
  if (threadIdx.x == 0) partial[blockIdx.x] = s;
}

template <int K>
__global__ void __launch_bounds__(kThreads, 1)
mat_bwd_rows_f32(const float* __restrict__ y1, const float* __restrict__ y2,
                 const float* __restrict__ mem, const float* __restrict__ do1,
                 const float* __restrict__ do2, const float* __restrict__ lse,
                 const float* __restrict__ g_ct, float* __restrict__ dy1,
                 float* __restrict__ dy2, float* __restrict__ dsum, int64_t rows, int S,
                 float scale, float inv_n2) {
  extern __shared__ float fsm[];
  float* ys = fsm;                                // 2 row tiles of y
  float* ds = ys + 2 * f32_tile_floats<K>();      // 2 row tiles of dout
  float* ms = ds + 2 * f32_tile_floats<K>();      // K x kLdC
  float* xs = ms + K * kLdC;                      // 32 x kLdC exchange
  const int view = threadIdx.x / 128, r = (threadIdx.x % 128) / 4, q = threadIdx.x % 4;
  const unsigned group = (threadIdx.x & 31) & ~3u;
  const int64_t row = int64_t(blockIdx.x) * kRowsF32 + r;
  const bool valid = row < rows;
  const float gc = *g_ct * inv_n2;
  f32_load_rows<K>(y1, rows, row - r, ys);
  f32_load_rows<K>(y2, rows, row - r, ys + f32_tile_floats<K>());
  f32_load_rows<K>(do1, rows, row - r, ds);
  f32_load_rows<K>(do2, rows, row - r, ds + f32_tile_floats<K>());
  const size_t off = view * f32_tile_floats<K>() + r * (K + 1);
  const float lse_r = valid ? lse[view * rows + row] : INFINITY;
  const int n_chunks = (S + kColsF32 - 1) / kColsF32;
  float dsum_r = 0.f;
  float acc[K / 4];
#pragma unroll
  for (int i = 0; i < K / 4; ++i) acc[i] = 0.f;

  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1) {
      dsum_r += __shfl_xor_sync(0xffffffffu, dsum_r, 1);
      dsum_r += __shfl_xor_sync(0xffffffffu, dsum_r, 2);
      if (valid && q == 0) dsum[view * rows + row] = dsum_r;
    }
    for (int c = 0; c < n_chunks; ++c) {
      const int s0 = c * kColsF32;
      __syncthreads();
      f32_load_m<K>(mem, S, s0, ms);
      __syncthreads();
      float p[kColsF32 / 4], dp[kColsF32 / 4];
      f32_p_and_dp<K>(ys + off, ds + off, ms, q, view, s0, S, scale, lse_r, gc,
                      xs + r * kLdC, p, dp);
      if (pass == 0) {
#pragma unroll
        for (int j = 0; j < kColsF32 / 4; ++j) dsum_r += dp[j] * p[j];
      } else {
#pragma unroll
        for (int j = 0; j < kColsF32 / 4; ++j) p[j] = p[j] * (dp[j] - dsum_r) * scale;
        f32_x_mt<K>(p, ms, q, group, acc);
      }
    }
  }
  if (valid) {
    float* dy = view ? dy2 : dy1;
#pragma unroll
    for (int i = 0; i < K / 4; ++i) dy[row * K + q + 4 * i] = acc[i];
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads, 1)
mat_bwd_cols_f32(const float* __restrict__ y1, const float* __restrict__ y2,
                 const float* __restrict__ mem, const float* __restrict__ do1,
                 const float* __restrict__ do2, const float* __restrict__ lse,
                 const float* __restrict__ dsum, const float* __restrict__ g_ct,
                 float* __restrict__ scratch, int64_t rows, int S, float scale,
                 float inv_n2, int tiles_per_split) {
  constexpr int kPer = K * kColsF32 / kThreads;   // dM entries per thread
  extern __shared__ float fsm[];
  float* ms = fsm;                                // K x kLdC, the block's S-slice
  float* ys = ms + K * kLdC;                      // 2 row tiles of y
  float* ds = ys + 2 * f32_tile_floats<K>();      // 2 row tiles of dout
  float* ps = ds + 2 * f32_tile_floats<K>();      // 2 x 32 x kLdC: p
  float* ls = ps + 2 * kRowsF32 * kLdC;           // 2 x 32 x kLdC: dl / sqrt(K)
  float* xs = ls + 2 * kRowsF32 * kLdC;           // 32 x kLdC exchange
  const int view = threadIdx.x / 128, r = (threadIdx.x % 128) / 4, q = threadIdx.x % 4;
  const int s0 = blockIdx.x * kColsF32;
  const int n_tiles = int((rows + kRowsF32 - 1) / kRowsF32);
  const int tile0 = blockIdx.y * tiles_per_split;
  const int tile1 = min(n_tiles, tile0 + tiles_per_split);
  const float gc = *g_ct * inv_n2;
  const size_t off = view * f32_tile_floats<K>() + r * (K + 1);
  f32_load_m<K>(mem, S, s0, ms);
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;

  for (int tile = tile0; tile < tile1; ++tile) {
    const int64_t row0 = int64_t(tile) * kRowsF32, row = row0 + r;
    __syncthreads();
    f32_load_rows<K>(y1, rows, row0, ys);
    f32_load_rows<K>(y2, rows, row0, ys + f32_tile_floats<K>());
    f32_load_rows<K>(do1, rows, row0, ds);
    f32_load_rows<K>(do2, rows, row0, ds + f32_tile_floats<K>());
    __syncthreads();
    const float lse_r = row < rows ? lse[view * rows + row] : INFINITY;
    const float dsum_r = row < rows ? dsum[view * rows + row] : 0.f;
    float p[kColsF32 / 4], dp[kColsF32 / 4];
    f32_p_and_dp<K>(ys + off, ds + off, ms, q, view, s0, S, scale, lse_r, gc,
                    xs + r * kLdC, p, dp);
#pragma unroll
    for (int j = 0; j < kColsF32 / 4; ++j) {
      ps[(view * kRowsF32 + r) * kLdC + q + 4 * j] = p[j];
      ls[(view * kRowsF32 + r) * kLdC + q + 4 * j] = p[j] * (dp[j] - dsum_r) * scale;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = threadIdx.x + kThreads * i, k = idx / kColsF32, c = idx % kColsF32;
      float a = acc[i];
      for (int v = 0; v < 2; ++v) {
        const float* dv = ds + v * f32_tile_floats<K>() + k;
        const float* yv = ys + v * f32_tile_floats<K>() + k;
        const float* pv = ps + v * kRowsF32 * kLdC + c;
        const float* lv = ls + v * kRowsF32 * kLdC + c;
        for (int rr = 0; rr < kRowsF32; ++rr) {
          a = fmaf(dv[rr * (K + 1)], pv[rr * kLdC], a);
          a = fmaf(yv[rr * (K + 1)], lv[rr * kLdC], a);
        }
      }
      acc[i] = a;
    }
  }
  float* dst = scratch + size_t(blockIdx.y) * K * S;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int idx = threadIdx.x + kThreads * i, k = idx / kColsF32, c = idx % kColsF32;
    if (s0 + c < S) dst[size_t(k) * S + s0 + c] = acc[i];
  }
}

// ================================================================ reductions
// the loss: the per-block terms in a fixed order, times 1 / (rows * S)
__global__ void __launch_bounds__(kThreads)
sum_partials(const float* __restrict__ partial, int n, float inv_n, float* __restrict__ loss) {
  __shared__ float red[kThreads / 32];
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) s += partial[i];
  s = block_sum(s, red);
  if (threadIdx.x == 0) *loss = s * inv_n;
}

// dM = sum over splits of the partial slices, in split order
__global__ void __launch_bounds__(kThreads)
reduce_splits(const float* __restrict__ scratch, int splits, int64_t n,
              float* __restrict__ out) {
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += scratch[sp * n + i];
  out[i] = s;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

template <int K>
cudaError_t fwd(const void* y1, const void* y2, const void* mem, void* out1, void* out2,
                float* lse, float* partial, float* loss, int64_t rows, int S, int dtype,
                float inv_n, cudaStream_t st) {
  const float scale = 1.f / sqrtf(float(K));
  cudaError_t err;
  int blocks;
  if (dtype == 1) {
    const size_t smem = FwdSmem<K>::bytes;
    if ((err = allow_smem(mat_fwd_bf16<K>, smem)) != cudaSuccess) return err;
    blocks = int((rows + kRows - 1) / kRows);
    mat_fwd_bf16<K><<<blocks, kThreads, smem, st>>>(
        static_cast<const bf16*>(y1), static_cast<const bf16*>(y2),
        static_cast<const bf16*>(mem), static_cast<bf16*>(out1), static_cast<bf16*>(out2),
        lse, partial, rows, S, scale);
  } else {
    const size_t smem = (2 * f32_tile_floats<K>() + (K + kRowsF32) * kLdC) * 4;
    if ((err = allow_smem(mat_fwd_f32<K>, smem)) != cudaSuccess) return err;
    blocks = int((rows + kRowsF32 - 1) / kRowsF32);
    mat_fwd_f32<K><<<blocks, kThreads, smem, st>>>(
        static_cast<const float*>(y1), static_cast<const float*>(y2),
        static_cast<const float*>(mem), static_cast<float*>(out1),
        static_cast<float*>(out2), lse, partial, rows, S, scale);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  sum_partials<<<1, kThreads, 0, st>>>(partial, blocks, inv_n, loss);
  return cudaGetLastError();
}

template <int K>
cudaError_t bwd(const void* y1, const void* y2, const void* mem, const void* do1,
                const void* do2, const float* lse, const float* g, void* dy1, void* dy2,
                float* dsum, float* scratch, float* dm, int64_t rows, int S, int dtype,
                int splits, float inv_n2, cudaStream_t st) {
  const float scale = 1.f / sqrtf(float(K));
  cudaError_t err;
  const int row_tile = dtype == 1 ? kRows : kRowsF32;
  const int col_tile = dtype == 1 ? kCols : kColsF32;
  const int n_tiles = int((rows + row_tile - 1) / row_tile);
  const int per_split = (n_tiles + splits - 1) / splits;
  const dim3 col_grid((S + col_tile - 1) / col_tile, splits);
  if (dtype == 1) {
    const bf16 *a1 = static_cast<const bf16*>(y1), *a2 = static_cast<const bf16*>(y2),
               *m = static_cast<const bf16*>(mem), *d1 = static_cast<const bf16*>(do1),
               *d2 = static_cast<const bf16*>(do2);
    if ((err = allow_smem(mat_bwd_rows_bf16<K>, RowsSmem<K>::bytes)) != cudaSuccess) return err;
    mat_bwd_rows_bf16<K><<<n_tiles, kThreads, RowsSmem<K>::bytes, st>>>(
        a1, a2, m, d1, d2, lse, g, static_cast<bf16*>(dy1), static_cast<bf16*>(dy2), dsum,
        rows, S, scale, inv_n2);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if ((err = allow_smem(mat_bwd_cols_bf16<K>, ColsSmem<K>::bytes)) != cudaSuccess) return err;
    mat_bwd_cols_bf16<K><<<col_grid, kThreads, ColsSmem<K>::bytes, st>>>(
        a1, a2, m, d1, d2, lse, dsum, g, scratch, rows, S, scale, inv_n2, per_split);
  } else {
    const float *a1 = static_cast<const float*>(y1), *a2 = static_cast<const float*>(y2),
                *m = static_cast<const float*>(mem), *d1 = static_cast<const float*>(do1),
                *d2 = static_cast<const float*>(do2);
    const size_t rows_smem = (4 * f32_tile_floats<K>() + (K + kRowsF32) * kLdC) * 4;
    if ((err = allow_smem(mat_bwd_rows_f32<K>, rows_smem)) != cudaSuccess) return err;
    mat_bwd_rows_f32<K><<<n_tiles, kThreads, rows_smem, st>>>(
        a1, a2, m, d1, d2, lse, g, static_cast<float*>(dy1), static_cast<float*>(dy2), dsum,
        rows, S, scale, inv_n2);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const size_t cols_smem = (4 * f32_tile_floats<K>() + (K + 5 * kRowsF32) * kLdC) * 4;
    if ((err = allow_smem(mat_bwd_cols_f32<K>, cols_smem)) != cudaSuccess) return err;
    mat_bwd_cols_f32<K><<<col_grid, kThreads, cols_smem, st>>>(
        a1, a2, m, d1, d2, lse, dsum, g, scratch, rows, S, scale, inv_n2, per_split);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int64_t n = int64_t(K) * S;
  reduce_splits<<<unsigned((n + kThreads - 1) / kThreads), kThreads, 0, st>>>(scratch, splits,
                                                                             n, dm);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns a cudaError_t (0 = launched);
// cudaErrorInvalidValue for a K that has no instantiation.
//
// Forward: out1, out2 (rows, K) in y's type; lse (2, rows) f32; partial
// (at least ceil(rows / row tile)) f32 scratch; loss one f32, the mean of
// (p1 - p2)^2 (inv_n = 1 / (rows * S)).
extern "C" int mem_attention_train_fwd(const void* y1, const void* y2, const void* mem,
                                       void* out1, void* out2, float* lse, float* partial,
                                       float* loss, long long rows, int K, int S, int dtype,
                                       float inv_n, void* stream) {
  if (rows <= 0 || S <= 0 || (dtype != 0 && dtype != 1)) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 16: return int(fwd<16>(y1, y2, mem, out1, out2, lse, partial, loss, rows, S, dtype, inv_n, st));
    case 256: return int(fwd<256>(y1, y2, mem, out1, out2, lse, partial, loss, rows, S, dtype, inv_n, st));
    default: return int(cudaErrorInvalidValue);
  }
}

// Backward: g is the loss's cotangent (one f32 on the device, read by the
// kernels, so the host never waits); inv_n2 = 2 / (rows * S); dy1, dy2 in
// y's type; dsum (2, rows) f32 and scratch (splits, K, S) f32 are work
// space; dm (K, S) f32.
extern "C" int mem_attention_train_bwd(const void* y1, const void* y2, const void* mem,
                                       const void* do1, const void* do2, const float* lse,
                                       const float* g, void* dy1, void* dy2, float* dsum,
                                       float* scratch, float* dm, long long rows, int K,
                                       int S, int dtype, int splits, float inv_n2,
                                       void* stream) {
  if (rows <= 0 || S <= 0 || splits <= 0 || (dtype != 0 && dtype != 1))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 16: return int(bwd<16>(y1, y2, mem, do1, do2, lse, g, dy1, dy2, dsum, scratch, dm, rows, S, dtype, splits, inv_n2, st));
    case 256: return int(bwd<256>(y1, y2, mem, do1, do2, lse, g, dy1, dy2, dsum, scratch, dm, rows, S, dtype, splits, inv_n2, st));
    default: return int(cudaErrorInvalidValue);
  }
}

// The tiles the launches use: which 0 = rows per block (of each view),
// 1 = prototypes per column block of the backward.
extern "C" int mem_attention_train_tile(int dtype, int which) {
  if (dtype == 1) return which ? kCols : kRows;
  return which ? kColsF32 : kRowsF32;
}

extern "C" const char* mem_attention_train_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
