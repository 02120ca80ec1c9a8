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
// Forward (mat_fwd_*). One sweep over S per tile of rows of both views,
// an online softmax per view (flash-attention style): out_i = o_i / l_i
// with o_i += round(e_i) . Mc^T, e_i = exp(logits - running max). So bf16
// out rounds the unnormalised e, where the JAX kernel and the plain
// version round p (as kernel #1 does). The loss term sum_S (p1 - p2)^2 and
// q = <p1, p1>_S, <p2, p2>_S, <p1, p2>_S of each row (3 x rows f32, saved
// for the backward with each row's logsumexp, 2 x rows f32) come from
// running sums carried from one normaliser to the next without
// cancellation (loss_sums says how). Each 32 rows of a view write one
// loss term to `partial`; sum_partials adds them in a fixed order (one
// block) and divides by rows * S.
//
// Backward (g = the loss's cotangent, gc = 2 g / (rows * S), D = <dp, p>_S):
//     dp_i = dout_i . M  +/-  gc (p1 - p2)
//     dl_i = p_i (dp_i - D_i)
//     dy_i = dl_i . M^T / sqrt(K)
//     dM   = sum_i dout_i^T . round(p_i) + y_i^T . dl_i / sqrt(K)
// D needs no sweep over S (the flash-attention identity): <dout_i . M,
// p_i>_S = <dout_i, p_i . M^T>_K, taken as <dout_i, out_i>_K (out's
// rounding, and round(p) for p), and the consistency term adds gc (q_ii -
// q_12) (row_dsum).
//   (a) mat_bwd_rows: per tile of 64 rows of both views, D, then one sweep
//       over S: p from the saved logsumexp, dp, dl and dy. Writes dy and D.
//   (b) mat_bwd_cols: a block owns a slice of prototypes (K x kColsC of dM)
//       and a range of row tiles (`splits` ranges, so slices x splits
//       blocks fill the card); it recomputes p and dl on its slice and
//       writes its partial dM to a (splits, K, S) f32 scratch.
//   (c) reduce_splits sums the scratch over splits in order.
// bf16: the forward, (a) and (b) on wgmma fed by TMA (the section below
// says how).
// dl is rounded to bf16 (after the 1/sqrt(K) scale, a power of two at
// K = 16, 64, 256) for the tensor-core products dl . M^T and y^T . dl.
//
// Bound on the H100 at the training shapes (B = 16, P = 6400, K = 256,
// S = 1024, bf16; scripts/kernel_bounds.py, the work the TPU kernels do):
// forward 214.7 GFLOP / 210.2 MB -> 0.2171 ms; backward 536.9 GFLOP /
// 316.1 MB -> 0.5428 ms, both bound by the tensor cores. This design does
// the forward's 4 products of rows x K x S per view pair; the backward
// does more: it recomputes the logits and dout . M in both (a) and (b)
// (14 products instead of 10: 751.6 GFLOP, 1.4x, 0.7600 ms at the peak).
// In exchange nothing of size rows x S ever reaches device memory:
// 16 x 6400 x 1024 f32 is 419 MB per tensor.
//
// f32 kernels: plain f32 FMA on the CUDA cores (no TF32), 32 rows a block,
// 4 threads a row, for holding the kernels against the plain version at
// 1e-4; the forward takes two sweeps (row max and sum, then exact p).
//
// Any number of rows (masked tail) and any S (masked tail); K in {16, 256}.
// The bf16 kernels read M through a tensor map: its rows `ld` values apart,
// a multiple of 8 (the wrapper pads M's columns).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_sm90.cuh"

namespace {

namespace wg = wgmma_sm90;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // f32 kernels and reductions: 8 warps
constexpr int kRowsF32 = 32;   // f32: rows of each view per block
constexpr int kColsF32 = 32;   // f32: prototypes per S-chunk / S-slice

// the sum over the 4 consecutive lanes that share a row
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// D = <dout, out>_K + gc (q_ii - q_12) of `row` of view `view` (D = <dp, p>_S
// with out = p . M^T: <dout . M, p>_S = <dout, p . M^T>_K; the consistency
// term's <+-(p1 - p2), p_i>_S from the forward's q sums), by the 4 lanes of
// the row's quad; every lane of the quad returns it
template <int K, typename T>
__device__ float row_dsum(const T* __restrict__ dout, const T* __restrict__ out,
                          const float* __restrict__ qsum, int64_t rows, int64_t row, int view,
                          int t, float gc) {
  float acc = 0.f;
  if (row < rows) {
    const T* d = dout + row * K;
    const T* o = out + row * K;
    if constexpr (sizeof(T) == 2) {
      for (int k = 8 * t; k < K; k += 32) {
        const uint4 a = *reinterpret_cast<const uint4*>(d + k);
        const uint4 b = *reinterpret_cast<const uint4*>(o + k);
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 x = __bfloat1622float2(a2[i]), y = __bfloat1622float2(b2[i]);
          acc = fmaf(x.x, y.x, fmaf(x.y, y.y, acc));
        }
      }
    } else {
      for (int k = t; k < K; k += 4) acc = fmaf(d[k], o[k], acc);
    }
  }
  acc = quad_sum(acc);
  return row < rows ? acc + gc * (qsum[view * rows + row] - qsum[2 * rows + row]) : 0.f;
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

// ================================================= bf16: wgmma fed by TMA
// The three kernels are warp-specialised like kernel #1
// (csrc/mem_attention.cu): one producer warpgroup, in which one thread
// issues every TMA load, and two consumer warpgroups; setmaxnreg moves
// registers from the producer to the consumers. Tiles arrive through TMA
// with the swizzle of their row width, and each is read by wgmma through
// descriptors of that swizzle, in whichever of its two majors a product
// needs. Their times on the card beside the bound: PERF.md, section 6.
constexpr int kWgThreads = 384;
constexpr int kProducerRegs = 24, kConsumerRegs = 240;  // 128 * (24 + 2 * 240) <= 65536
constexpr int kSmemMax = 232448;
constexpr int kChunkR = 64;   // forward and rows kernel: prototypes per M chunk (one
                              // 128-byte panel)
constexpr int kStagesF = 2;   // forward: M chunks in flight
constexpr int kYBufsF = 2;    // forward: row tiles in flight
constexpr int kLazyF = 8;     // forward: how far (log2 units) a row's max may rise before
                              // its running max moves (online_step)
constexpr int kStagesR = 2;   // rows kernel: M chunks in flight
constexpr int kHalf = 32;     // rows of each view in a warpgroup's 64 (view 1 above
                              // view 2); the cols kernel's row tile
constexpr int kRowsR = 2 * kHalf;  // forward, rows kernel: rows of each view per tile
constexpr int kColsC = 128;   // cols kernel: the block's S-slice, 64 per warpgroup
constexpr int kBufsC = 2;     // cols kernel: row tiles in flight
constexpr int kWgBar = 1;     // named barriers: 1 + wg a consumer warpgroup's own

template <int K>
struct Panels {
  static constexpr int kPw = K < 64 ? K : 64;   // values per tile row of a panel
  static constexpr int kRowBytes = 2 * kPw;     // = the tiles' swizzle
  static constexpr int kPanels = K / kPw;
  static constexpr uint32_t kPanel = 64 * kRowBytes;   // 64 tile rows of one panel
  static constexpr uint32_t kTile = kPanel * kPanels;  // 64 x K bf16
  static constexpr uint32_t kMPanel = K * 128;         // K rows x 64 prototypes
};

template <int K>
struct FwdLayout : Panels<K> {
  using B = Panels<K>;
  static constexpr int kXchFloats = 20;  // a thread's: 16 e of the other view's half, beta
                                         // and 1 / l of its two rows
  static constexpr uint32_t kXch = 128 * kXchFloats * 4;      // per warpgroup
  static constexpr uint32_t y = 0;  // per buffer: warpgroup 0's stacked tile, warpgroup 1's
  static constexpr uint32_t m = y + kYBufsF * 2 * B::kTile;   // the ring of M chunks
  static constexpr uint32_t xch = m + kStagesF * B::kMPanel;
  static constexpr uint32_t bars = xch + 2 * kXch;
  static constexpr uint32_t bytes = bars + 16 * (kYBufsF + kStagesF) + 1024;  // + alignment
  static_assert(bytes <= kSmemMax, "shared memory");
};

template <int K>
struct RowsLayout : Panels<K> {
  using B = Panels<K>;
  static constexpr uint32_t y = 0;                        // y, y, dout, dout (warpgroups 0, 1)
  static constexpr uint32_t m = y + 4 * B::kTile;         // the ring of M chunks
  static constexpr uint32_t xch = m + kStagesR * B::kMPanel;  // p of each warpgroup, f32
  static constexpr uint32_t bars = xch + 2 * kRowsR * kChunkR * 4;
  static constexpr uint32_t bytes = bars + 8 * (2 + 2 * kStagesR) + 1024;  // + alignment
  static_assert(bytes <= kSmemMax, "shared memory");
};

template <int K>
struct ColsLayout : Panels<K> {
  using B = Panels<K>;
  static constexpr uint32_t kBuf = 2 * B::kTile;          // stacked y, then stacked dout
  static constexpr uint32_t kPTile = 64 * 128;            // 64 rows x 64 prototypes bf16
  static constexpr uint32_t m = 0;                        // the S-slice, 2 panels
  static constexpr uint32_t buf = m + 2 * B::kMPanel;
  static constexpr uint32_t pl = buf + kBufsC * kBuf;     // per warpgroup: p-hat, dl
  static constexpr uint32_t bars = pl + 4 * kPTile;
  static constexpr uint32_t bytes = bars + 8 * (1 + 2 * kBufsC) + 1024;
  static_assert(bytes <= kSmemMax, "shared memory");
};

// s = A . M[:, 64 prototypes] (issued, not waited for): A = 64 tile rows
// at `a` (K-major, the tiles' swizzle), B = the prototypes' panel at `mb`
// (MN-major, 128 B)
template <int K>
__device__ __forceinline__ void issue_tile_x_m(float (&s)[32], uint32_t a, uint32_t mb) {
  using B = Panels<K>;
  constexpr int kSlices = B::kPw / 16;  // k16 slices per panel
  const uint64_t da = wg::make_desc(a, 16, 8 * B::kRowBytes, B::kRowBytes);
  const uint64_t db = wg::make_desc(mb, B::kMPanel, 1024, 128);
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wg::wgmma_ss<64, 0, 1>(s, da + (((kk / kSlices) * B::kPanel + (kk % kSlices) * 32) >> 4),
                           db + ((kk * 2048) >> 4), kk > 0);
}

// logits of a 64-prototype chunk from s0 (accumulator layout) -> p = exp(l /
// sqrt(K) - lse), 0 for prototypes past S and rows whose lse2 is +inf
__device__ __forceinline__ void probs(float (&s)[32], const float (&lse2)[2], int s0, int S,
                                      int q, float scale_log2) {
  const int lim = S - s0 - 2 * q;  // column 8 (i / 4) + (i & 1) of the thread is >= S
#pragma unroll
  for (int i = 0; i < 32; ++i)
    s[i] = 8 * (i / 4) + (i & 1) < lim ? wg::fast_exp2(s[i] * scale_log2 - lse2[(i >> 1) & 1])
                                       : 0.f;
}

// online softmax step on a 64-prototype chunk from s0 (logits in the
// accumulator layout) -> e = 2^(l scale_log2 - m), 0 for prototypes past S,
// with the rows' running max m (log2 units) and sum l (the whole row's: the
// quad's lanes hold the same); alpha = 2^(m_old - m) rescales what came
// before, and beta = alpha l_old / l and 1 / l carry the loss sums from
// the old normaliser to the new one. With kLazyF, m moves only when the
// chunk's max passes it by more than kLazyF (e stays below 2^kLazyF), so
// that alpha is 1 and o keeps its scale in most chunks.
__device__ __forceinline__ void online_step(float (&s)[32], float (&m_run)[2], float (&l_run)[2],
                                            float (&alpha)[2], float (&beta)[2],
                                            float (&inv)[2], int s0, int S, int q,
                                            float scale_log2) {
  if (s0 + kChunkR > S) {
    const int lim = S - s0 - 2 * q;  // column 8 (i / 4) + (i & 1) of the thread is >= S
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (8 * (i / 4) + (i & 1) >= lim) s[i] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    // finite: every chunk has a column < S
    const float m_new = mx[h] * scale_log2 > m_run[h] + kLazyF ? mx[h] * scale_log2 : m_run[h];
    alpha[h] = wg::fast_exp2(m_run[h] - m_new);
    m_run[h] = m_new;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = wg::fast_exp2(fmaf(s[i], scale_log2, -m_run[(i >> 1) & 1]));
    sum[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float l = alpha[h] * l_run[h] + quad_sum(sum[h]);
    inv[h] = 1.f / l;
    beta[h] = alpha[h] * l_run[h] * inv[h];
    l_run[h] = l;
  }
}

// The loss sums of one chunk, in the roles of the calling warp: u_m =
// e_m / l_m of its own view (values kOff .. kOff + 15 of its 32), u_o of
// the other view's (from its partner's exchange `xo`, with its beta and 1 /
// l), d = u_m - u_o. acc (per row) holds D = <d, d>, C = <d, u_o>, <u_m,
// u_m>, <u_o, u_o>, <u_m, u_o> over the chunks before, which are first
// carried to the new normalisers (online_forward_reference in
// ops/mem_attention_train.py; D and C without forming q11 + q22 - 2 q12,
// which cancels once the views agree). The chunk's terms are summed in e
// units, t = e_m - (l_m / l_o) e_o = d l_m, and scaled once.
template <int kOff>
__device__ __forceinline__ void loss_sums(const float (&s)[32], const float* xo,
                                          const float (&beta)[2], const float (&inv)[2],
                                          const float (&l_run)[2], float (&acc)[5][2]) {
  float part[5][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
  float r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) r[h] = l_run[h] * xo[(17 + 2 * h) * 128];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int h = (j >> 1) & 1;
    const float em = s[kOff + j], eo = xo[j * 128], t = fmaf(-r[h], eo, em);
    part[0][h] = fmaf(t, t, part[0][h]);
    part[1][h] = fmaf(t, eo, part[1][h]);
    part[2][h] = fmaf(em, em, part[2][h]);
    part[3][h] = fmaf(eo, eo, part[3][h]);
    part[4][h] = fmaf(em, eo, part[4][h]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float bm = beta[h], bo = xo[(16 + 2 * h) * 128], d = bm - bo;
    const float im = inv[h], io = xo[(17 + 2 * h) * 128];
    acc[0][h] = fmaf(im * im, part[0][h],
                     bm * bm * acc[0][h] + 2.f * bm * d * acc[1][h] + d * d * acc[3][h]);
    acc[1][h] = fmaf(im * io, part[1][h], bm * bo * acc[1][h] + bo * d * acc[3][h]);
    acc[2][h] = fmaf(im * im, part[2][h], bm * bm * acc[2][h]);
    acc[3][h] = fmaf(io * io, part[3][h], bo * bo * acc[3][h]);
    acc[4][h] = fmaf(im * io, part[4][h], bm * bo * acc[4][h]);
  }
}

// forward. Per tile of 64 rows of both views; consumer warpgroup w takes
// rows 32 w .. 32 w + 31 of both views stacked into its 64 (view 1 above
// view 2), as the rows kernel does. One sweep over S in 64-prototype
// chunks: logits = y . Mc (SS, Mc MN-major), an online softmax per view,
// o = alpha o + round(e) . Mc^T (RS: e in registers as bf16, Mc K-major),
// and beside that product the loss sums. The views trade half of e and
// each row's beta and 1 / l through shared memory, so that warps w and w +
// 2 each sum half of the chunk's columns (loss_sums). At the end D is the
// row's sum of (p1 - p2)^2 and the q sums are <p1, p1>, <p2, p2>, <p1,
// p2>. Epilogue: out = o / l in bf16 through a TMA store, lse, q, and the
// warpgroup's loss term in partial[2 tile + w]. Persistent.
template <int K>
__global__ void __launch_bounds__(kWgThreads, 1)
mat_fwd_bf16(const __grid_constant__ CUtensorMap y1_map,
             const __grid_constant__ CUtensorMap y2_map,
             const __grid_constant__ CUtensorMap m_map,
             const __grid_constant__ CUtensorMap out1_map,
             const __grid_constant__ CUtensorMap out2_map, float* __restrict__ lse,
             float* __restrict__ qsum, float* __restrict__ partial, int64_t rows, int n_tiles,
             int S, float scale_log2) {
  using L = FwdLayout<K>;
  constexpr uint32_t kV2 = kHalf * L::kRowBytes;  // view 2's rows in a stacked panel
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* y_full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* y_empty = y_full + kYBufsF;
  uint64_t* m_full = y_empty + kYBufsF;
  uint64_t* m_empty = m_full + kStagesF;
  const int n_chunks = (S + kChunkR - 1) / kChunkR;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kYBufsF; ++i) {
      wg::mbar_init(y_full + i, 1);
      wg::mbar_init(y_empty + i, 2);
    }
    for (int i = 0; i < kStagesF; ++i) {
      wg::mbar_init(m_full + i, 1);
      wg::mbar_init(m_empty + i, 2);
    }
    wg::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------------ producer
    wg::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      uint32_t it = 0, t = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++t) {
        const uint32_t yb = t % kYBufsF;
        wg::mbar_wait(y_empty + yb, ((t / kYBufsF) & 1) ^ 1);
        wg::mbar_arrive_expect_tx(y_full + yb, 2 * L::kTile);
        for (int w = 0; w < 2; ++w)
          for (int p = 0; p < L::kPanels; ++p) {
            unsigned char* dst = smem + L::y + (2 * yb + w) * L::kTile + p * L::kPanel;
            const int r = tile * kRowsR + w * kHalf;
            wg::tma_load_2d(dst, y1_map, p * L::kPw, r, y_full + yb);
            wg::tma_load_2d(dst + kV2, y2_map, p * L::kPw, r, y_full + yb);
          }
        for (int c = 0; c < n_chunks; ++c, ++it) {
          const uint32_t st = it % kStagesF;
          wg::mbar_wait(m_empty + st, ((it / kStagesF) & 1) ^ 1);
          wg::mbar_arrive_expect_tx(m_full + st, L::kMPanel);
          wg::tma_load_2d(smem + L::m + st * L::kMPanel, m_map, c * kChunkR, 0, m_full + st);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    wg::setmaxnreg_inc<kConsumerRegs>();
    const int w = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0) - 1;
    const int lt = threadIdx.x % 128, warp = lt / 32, lane = lt % 32, q = lane % 4;
    const int view = warp / 2;  // warps 0, 1: view 1's rows; 2, 3: view 2's
    const int partner = lt ^ 64;  // its lane of the other view's warp: the same (row, s)
    float* xw = reinterpret_cast<float*>(smem + L::xch + w * L::kXch);
    uint32_t it = 0, t = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++t) {
      const uint32_t yb = t % kYBufsF;
      unsigned char* stage = smem + L::y + (2 * yb + w) * L::kTile;
      const uint32_t ya = wg::smem_u32(stage);
      const int64_t row0 = int64_t(tile) * kRowsR + w * kHalf;  // of each view
      float o[K / 2];
#pragma unroll
      for (int i = 0; i < K / 2; ++i) o[i] = 0.f;
      float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
      // this thread's share of each row's loss sums (loss_sums)
      float acc[5][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
      wg::mbar_wait(y_full + yb, (t / kYBufsF) & 1);

      float s[32], alpha[2], beta[2], inv[2];
      for (int c = 0; c < n_chunks; ++c, ++it) {
        const uint32_t st = it % kStagesF;
        const uint32_t mb = wg::smem_u32(smem + L::m + st * L::kMPanel);
        wg::mbar_wait(m_full + st, (it / kStagesF) & 1);
        wg::wgmma_fence();
        issue_tile_x_m<K>(s, ya, mb);
        wg::wgmma_commit();
        wg::wgmma_wait<0>();
        wg::fence_regs(s);
        online_step(s, m_run, l_run, alpha, beta, inv, c * kChunkR, S, q, scale_log2);
        // o = alpha o + round(e) . Mc^T, issued; the loss sums run beside it
        if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
          for (int i = 0; i < K / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
        }
        uint32_t pa[kChunkR / 16][4];
#pragma unroll
        for (int j = 0; j < kChunkR / 16; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) pa[j][i] = wg::pack_bf16(s[8 * j + 2 * i], s[8 * j + 2 * i + 1]);
        wg::fence_regs(o);
#pragma unroll
        for (int j = 0; j < kChunkR / 16; ++j) wg::fence_regs(pa[j]);
        wg::wgmma_fence();
        const uint64_t db = wg::make_desc(mb, 16, 1024, 128);
#pragma unroll
        for (int j = 0; j < kChunkR / 16; ++j)
          wg::wgmma_rs<K, 0>(o, pa[j], db + ((j * 32) >> 4), 1);
        wg::wgmma_commit();

        // view 1's warps sum values 0-15 of the thread's 32, view 2's
        // 16-31; each hands the other the half it does not sum, and its
        // rows' beta and 1 / l. The reads of the last chunk's are done.
        wg::named_barrier_sync(kWgBar + w, 128);
        if (view) {
#pragma unroll
          for (int j = 0; j < 16; ++j) xw[j * 128 + lt] = s[j];
        } else {
#pragma unroll
          for (int j = 0; j < 16; ++j) xw[j * 128 + lt] = s[16 + j];
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          xw[(16 + 2 * h) * 128 + lt] = beta[h];
          xw[(17 + 2 * h) * 128 + lt] = inv[h];
        }
        wg::named_barrier_sync(kWgBar + w, 128);
        if (view)
          loss_sums<16>(s, xw + partner, beta, inv, l_run, acc);
        else
          loss_sums<0>(s, xw + partner, beta, inv, l_run, acc);
        wg::wgmma_wait<0>();
        wg::fence_regs(o);
#pragma unroll
        for (int j = 0; j < kChunkR / 16; ++j) wg::fence_regs(pa[j]);  // live until read
        if (lt == 0) wg::mbar_arrive(m_empty + st);
      }
      if (view) {  // this warp's q11 share is view 2's
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float x = acc[2][h];
          acc[2][h] = acc[3][h];
          acc[3][h] = x;
        }
      }

      // epilogue: out = o / l in bf16, staged in this warpgroup's y tile
      // (its reads are done), TMA store of each view's 32 rows (clipped at
      // `rows`)
      const uint32_t ln = wg::opaque(lane);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float il = 1.f / l_run[h];
        const uint32_t row = warp * 16 + ln / 4 + 8 * h;
#pragma unroll
        for (int j = 0; j < K / 8; ++j) {
          const uint32_t col = 8 * j + 2 * (ln % 4);
          wg::st_shared_u32(ya + (col / L::kPw) * L::kPanel +
                                wg::swizzle(row * L::kRowBytes + (col % L::kPw) * 2, L::kRowBytes),
                            wg::pack_bf16(o[4 * j + 2 * h] * il, o[4 * j + 2 * h + 1] * il));
        }
      }
      wg::fence_proxy_async();
      // also: every read of the last chunk's exchange is done
      wg::named_barrier_sync(kWgBar + w, 128);
      if (lt == 0) {
        for (int p = 0; p < L::kPanels; ++p) {
          wg::tma_store_2d(out1_map, stage + p * L::kPanel, p * L::kPw, int(row0));
          wg::tma_store_2d(out2_map, stage + p * L::kPanel + kV2, p * L::kPw, int(row0));
        }
        wg::tma_store_commit();
      }
      // lse; the row sums, view 2's warps' shares handed to view 1's
      bool valid[2];
      int64_t row[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        row[h] = row0 + (warp % 2) * 16 + lane / 4 + 8 * h;
        valid[h] = row[h] < rows;
        if (q == 0 && valid[h])
          lse[view * rows + row[h]] = (m_run[h] + log2f(l_run[h])) * 0.6931471805599453f;
#pragma unroll
        for (int v = 0; v < 5; ++v) {
          acc[v][h] = quad_sum(acc[v][h]);
          if (view) xw[(2 * v + h) * 128 + lt] = acc[v][h];
        }
      }
      wg::named_barrier_sync(kWgBar + w, 128);
      float loss = 0.f;
      if (view == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int v = 0; v < 5; ++v) acc[v][h] += xw[(2 * v + h) * 128 + partner];
          if (q == 0 && valid[h]) {
#pragma unroll
            for (int i = 0; i < 3; ++i) qsum[i * rows + row[h]] = acc[2 + i][h];
            loss += acc[0][h];
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) loss += __shfl_xor_sync(0xffffffffu, loss, off);
        if (warp == 1 && lane == 0) xw[10 * 128] = loss;
      }
      wg::named_barrier_sync(kWgBar + w, 128);
      if (lt == 0) {
        if (row0 < rows) partial[2 * tile + w] = loss + xw[10 * 128];
        wg::tma_store_wait_read<0>();
        wg::mbar_arrive(y_empty + yb);
      }
    }
    if (lt == 0) wg::tma_store_wait<0>();
  }
}

// rows kernel. Per tile of 64 rows of both views; consumer warpgroup w
// takes rows 32 w .. 32 w + 31 of both views stacked into its 64 (view 1
// above view 2), so its warps w and w + 2 hold the same (row, s) of the two
// views and the two warpgroups run apart (one's softmax beside the other's
// products). One sweep over S in 64-prototype chunks: logits = y . Mc and
// dp = dout . Mc (SS, Mc MN-major), p from the saved lse, the views trade p
// through shared memory, dl = p (dp +/- gc (p1 - p2) - D) / sqrt(K), then
// dy += dl . Mc^T (RS: dl in registers, Mc K-major). D comes from the
// forward (row_dsum) and is written for the cols kernel. Persistent.
template <int K>
__global__ void __launch_bounds__(kWgThreads, 1)
mat_bwd_rows_bf16(const __grid_constant__ CUtensorMap y1_map,
                  const __grid_constant__ CUtensorMap y2_map,
                  const __grid_constant__ CUtensorMap d1_map,
                  const __grid_constant__ CUtensorMap d2_map,
                  const __grid_constant__ CUtensorMap m_map,
                  const __grid_constant__ CUtensorMap dy1_map,
                  const __grid_constant__ CUtensorMap dy2_map, const bf16* __restrict__ do1,
                  const bf16* __restrict__ do2, const bf16* __restrict__ out1,
                  const bf16* __restrict__ out2, const float* __restrict__ lse,
                  const float* __restrict__ qsum, const float* __restrict__ g_ct,
                  float* __restrict__ dsum, int64_t rows, int n_tiles, int S, float scale,
                  float inv_n2) {
  using L = RowsLayout<K>;
  constexpr uint32_t kV2 = kHalf * L::kRowBytes;  // view 2's rows in a stacked panel
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* t_full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* t_empty = t_full + 1;
  uint64_t* m_full = t_empty + 1;
  uint64_t* m_empty = m_full + kStagesR;
  const int n_chunks = (S + kChunkR - 1) / kChunkR;

  if (threadIdx.x == 0) {
    wg::mbar_init(t_full, 1);
    wg::mbar_init(t_empty, 2);
    for (int i = 0; i < kStagesR; ++i) {
      wg::mbar_init(m_full + i, 1);
      wg::mbar_init(m_empty + i, 2);
    }
    wg::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------------ producer
    wg::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      uint32_t it = 0, t = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++t) {
        wg::mbar_wait(t_empty, (t & 1) ^ 1);
        wg::mbar_arrive_expect_tx(t_full, 4 * L::kTile);
        for (int w = 0; w < 2; ++w)
          for (int p = 0; p < L::kPanels; ++p) {
            unsigned char* dst = smem + L::y + w * L::kTile + p * L::kPanel;
            const int r = tile * kRowsR + w * kHalf;
            wg::tma_load_2d(dst, y1_map, p * L::kPw, r, t_full);
            wg::tma_load_2d(dst + kV2, y2_map, p * L::kPw, r, t_full);
            wg::tma_load_2d(dst + 2 * L::kTile, d1_map, p * L::kPw, r, t_full);
            wg::tma_load_2d(dst + 2 * L::kTile + kV2, d2_map, p * L::kPw, r, t_full);
          }
        for (int c = 0; c < n_chunks; ++c, ++it) {
          const uint32_t st = it % kStagesR;
          wg::mbar_wait(m_empty + st, ((it / kStagesR) & 1) ^ 1);
          wg::mbar_arrive_expect_tx(m_full + st, L::kMPanel);
          wg::tma_load_2d(smem + L::m + st * L::kMPanel, m_map, c * kChunkR, 0, m_full + st);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    wg::setmaxnreg_inc<kConsumerRegs>();
    const int w = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0) - 1;
    const int lt = threadIdx.x % 128, warp = lt / 32, lane = lt % 32, q = lane % 4;
    const int view = warp / 2;  // warps 0, 1: view 1's rows; 2, 3: view 2's
    const float gc = *g_ct * inv_n2;
    const float log2e = 1.4426950408889634f, scale_log2 = scale * log2e;
    float4* xch = reinterpret_cast<float4*>(smem + L::xch) + w * (64 * kChunkR / 4);
    const uint32_t ya = wg::smem_u32(smem + L::y + w * L::kTile);
    const uint32_t da = ya + 2 * L::kTile;
    uint32_t it = 0, t = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++t) {
      const int64_t row0 = int64_t(tile) * kRowsR + w * kHalf;  // of each view
      float lse2[2], dd[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t row = row0 + (warp % 2) * 16 + lane / 4 + 8 * h;
        dd[h] = row_dsum<K>(view ? do2 : do1, view ? out2 : out1, qsum, rows, row, view, q, gc);
        if (q == 0 && row < rows) dsum[view * rows + row] = dd[h];
        lse2[h] = row < rows ? lse[view * rows + row] * log2e : INFINITY;
      }
      float o[K / 2];
#pragma unroll
      for (int i = 0; i < K / 2; ++i) o[i] = 0.f;
      wg::mbar_wait(t_full, t & 1);

      for (int c = 0; c < n_chunks; ++c, ++it) {
        const uint32_t st = it % kStagesR;
        const uint32_t mb = wg::smem_u32(smem + L::m + st * L::kMPanel);
        wg::mbar_wait(m_full + st, (it / kStagesR) & 1);
        float s[32], dp[32];
        wg::wgmma_fence();
        issue_tile_x_m<K>(s, ya, mb);
        issue_tile_x_m<K>(dp, da, mb);
        wg::wgmma_commit();
        wg::wgmma_wait<0>();
        wg::fence_regs(s);
        wg::fence_regs(dp);
        probs(s, lse2, c * kChunkR, S, q, scale_log2);
        // trade p between warps w and w + 2 (the other view's same rows):
        // their reads of the last chunk's are done
        wg::named_barrier_sync(kWgBar + w, 128);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          xch[i * 128 + lt] = make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]);
        wg::named_barrier_sync(kWgBar + w, 128);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 x = xch[i * 128 + (lt ^ 64)];
          const float po[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 4 * i + e;  // dl / sqrt(K); view 2's dp takes -gc (p1 - p2)
            s[j] = s[j] * (dp[j] + gc * (s[j] - po[e]) - dd[e >> 1]) * scale;
          }
        }
        uint32_t pa[kChunkR / 16][4];  // dl in bf16 as wgmma A fragments
#pragma unroll
        for (int j = 0; j < kChunkR / 16; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) pa[j][i] = wg::pack_bf16(s[8 * j + 2 * i], s[8 * j + 2 * i + 1]);
        wg::fence_regs(o);
#pragma unroll
        for (int j = 0; j < kChunkR / 16; ++j) wg::fence_regs(pa[j]);
        wg::wgmma_fence();
        const uint64_t db = wg::make_desc(mb, 16, 1024, 128);
#pragma unroll
        for (int j = 0; j < kChunkR / 16; ++j)
          wg::wgmma_rs<K, 0>(o, pa[j], db + ((j * 32) >> 4), 1);
        wg::wgmma_commit();
        wg::wgmma_wait<0>();
        wg::fence_regs(o);
        if (lt == 0) wg::mbar_arrive(m_empty + st);
      }

      // epilogue: dy in bf16, staged in this warpgroup's y tile (its reads
      // are done), TMA store of each view's 32 rows (clipped at `rows`)
      const uint32_t ln = wg::opaque(lane);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t row = warp * 16 + ln / 4 + 8 * h;
#pragma unroll
        for (int j = 0; j < K / 8; ++j) {
          const uint32_t col = 8 * j + 2 * (ln % 4);
          wg::st_shared_u32(ya + (col / L::kPw) * L::kPanel +
                                wg::swizzle(row * L::kRowBytes + (col % L::kPw) * 2, L::kRowBytes),
                            wg::pack_bf16(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]));
        }
      }
      wg::fence_proxy_async();
      wg::named_barrier_sync(kWgBar + w, 128);
      if (lt == 0) {
        unsigned char* stage = smem + L::y + w * L::kTile;
        for (int p = 0; p < L::kPanels; ++p) {
          wg::tma_store_2d(dy1_map, stage + p * L::kPanel, p * L::kPw, int(row0));
          wg::tma_store_2d(dy2_map, stage + p * L::kPanel + kV2, p * L::kPw, int(row0));
        }
        wg::tma_store_commit();
        wg::tma_store_wait_read<0>();
        wg::mbar_arrive(t_empty);
      }
    }
    if (lt == 0) wg::tma_store_wait<0>();
  }
}

// byte offset of the accumulator pair (j, h) of lane `ln` of warp `warp` in
// a 64 x 64 bf16 tile of 128-byte rows, 128-byte swizzle (MN-major operand)
__device__ __forceinline__ uint32_t ptile_off(int warp, uint32_t ln, int j, int h) {
  return wg::swizzle((warp * 16 + ln / 4 + 8 * h) * 128 + (8 * j + 2 * (ln % 4)) * 2, 128);
}

__device__ __forceinline__ float2 bf16x2_at(const unsigned char* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// cols kernel. A block owns a 128-prototype slice of dM (64 per consumer
// warpgroup) and a range of row tiles; a row tile is 32 rows of each view
// stacked into 64 (view 1 above view 2), so each warpgroup trades p between
// its warps w and w + 2 and sums dM over both views in one product. Per
// tile and warpgroup: logits and dp on its 64 prototypes (SS), p from lse,
// D from the rows kernel, round(p) and dl / sqrt(K) into its p-hat and dl
// tiles (bf16, MN-major), then dM^T += round(p)^T . dout + dl^T . y / sqrt(K)
// (SS, both operands MN-major, the 64 rows the reduction axis), kept in
// registers across the row tiles and written to this split's partial.
template <int K>
__global__ void __launch_bounds__(kWgThreads, 1)
mat_bwd_cols_bf16(const __grid_constant__ CUtensorMap y1_map,
                  const __grid_constant__ CUtensorMap y2_map,
                  const __grid_constant__ CUtensorMap d1_map,
                  const __grid_constant__ CUtensorMap d2_map,
                  const __grid_constant__ CUtensorMap m_map, const float* __restrict__ lse,
                  const float* __restrict__ dsum, const float* __restrict__ g_ct,
                  float* __restrict__ scratch, int64_t rows, int S, float scale, float inv_n2,
                  int tiles_per_split) {
  using L = ColsLayout<K>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (wg::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* m_full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* t_full = m_full + 1;
  uint64_t* t_empty = t_full + kBufsC;
  const int s0 = blockIdx.x * kColsC;
  const int n_tiles = int((rows + kHalf - 1) / kHalf);
  const int tile0 = blockIdx.y * tiles_per_split;
  const int tile1 = min(n_tiles, tile0 + tiles_per_split);

  if (threadIdx.x == 0) {
    wg::mbar_init(m_full, 1);
    for (int i = 0; i < kBufsC; ++i) {
      wg::mbar_init(t_full + i, 1);
      wg::mbar_init(t_empty + i, 2);
    }
    wg::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------------ producer
    wg::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      wg::mbar_arrive_expect_tx(m_full, 2 * L::kMPanel);
      for (int h = 0; h < 2; ++h)
        wg::tma_load_2d(smem + L::m + h * L::kMPanel, m_map, s0 + 64 * h, 0, m_full);
      uint32_t t = 0;
      for (int tile = tile0; tile < tile1; ++tile, ++t) {
        const uint32_t b = t % kBufsC;
        wg::mbar_wait(t_empty + b, ((t / kBufsC) & 1) ^ 1);
        wg::mbar_arrive_expect_tx(t_full + b, L::kBuf);
        for (int p = 0; p < L::kPanels; ++p) {  // view 1 in rows 0-31, view 2 in 32-63
          unsigned char* dst = smem + L::buf + b * L::kBuf + p * L::kPanel;
          constexpr uint32_t v2 = kHalf * L::kRowBytes;
          wg::tma_load_2d(dst, y1_map, p * L::kPw, tile * kHalf, t_full + b);
          wg::tma_load_2d(dst + v2, y2_map, p * L::kPw, tile * kHalf, t_full + b);
          wg::tma_load_2d(dst + L::kTile, d1_map, p * L::kPw, tile * kHalf, t_full + b);
          wg::tma_load_2d(dst + L::kTile + v2, d2_map, p * L::kPw, tile * kHalf, t_full + b);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    wg::setmaxnreg_inc<kConsumerRegs>();
    const int w = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0) - 1;  // 64 prototypes each
    const int lt = threadIdx.x % 128, warp = lt / 32, lane = lt % 32, q = lane % 4;
    const int view = warp / 2;  // warps 0, 1: view 1's rows; 2, 3: view 2's
    const float gc = *g_ct * inv_n2;
    const float log2e = 1.4426950408889634f, scale_log2 = scale * log2e;
    const int c0 = s0 + 64 * w;
    const uint32_t mb = wg::smem_u32(smem + L::m + w * L::kMPanel);
    unsigned char* ptile = smem + L::pl + w * 2 * L::kPTile;  // p-hat, then dl
    const uint32_t pa = wg::smem_u32(ptile), la = pa + L::kPTile;
    float acc[K / 2];  // dM^T: prototypes c0 + 16 warp + g (+ 8), columns 8 j + 2 q (+ 1)
#pragma unroll
    for (int i = 0; i < K / 2; ++i) acc[i] = 0.f;
    wg::mbar_wait(m_full, 0);  // also with no row tile: the slice's load completes

    uint32_t t = 0;
    for (int tile = tile0; tile < tile1; ++tile, ++t) {
      const uint32_t b = t % kBufsC;
      const uint32_t ya = wg::smem_u32(smem + L::buf + b * L::kBuf), da = ya + L::kTile;
      float lse2[2], dd[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t row = int64_t(tile) * kHalf + (warp % 2) * 16 + lane / 4 + 8 * h;
        lse2[h] = row < rows ? lse[view * rows + row] * log2e : INFINITY;
        dd[h] = row < rows ? dsum[view * rows + row] : 0.f;
      }
      wg::mbar_wait(t_full + b, (t / kBufsC) & 1);
      float s[32], dp[32];
      wg::wgmma_fence();
      issue_tile_x_m<K>(s, ya, mb);
      issue_tile_x_m<K>(dp, da, mb);
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
      wg::fence_regs(s);
      wg::fence_regs(dp);
      probs(s, lse2, c0, S, q, scale_log2);
      // round(p) into the p-hat tile and p - round(p) into the dl tile; the
      // other view's row sits 32 rows away (4096 bytes: the swizzle keeps).
      // The addresses derive from an opaque lane, so that they are
      // recomputed in each tile, not held in registers across the loop.
      const uint32_t ln = wg::opaque(lane);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t off = ptile_off(warp, ln, j, h);
          const float a = s[4 * j + 2 * h], c = s[4 * j + 2 * h + 1];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(a, c);
          const float2 hf = __bfloat1622float2(hi);
          wg::st_shared_u32(pa + off, *reinterpret_cast<const uint32_t*>(&hi));
          wg::st_shared_u32(la + off, wg::pack_bf16(a - hf.x, c - hf.y));
        }
      wg::named_barrier_sync(kWgBar + w, 128);
      // dp += gc (p - p_other): view 1's dp takes +gc (p1 - p2), view 2's -gc (p1 - p2)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t off = ptile_off(warp, ln, j, h) ^ 4096u;
          const float2 hi = bf16x2_at(ptile + off), lo = bf16x2_at(ptile + L::kPTile + off);
          dp[4 * j + 2 * h] += gc * (s[4 * j + 2 * h] - (hi.x + lo.x));
          dp[4 * j + 2 * h + 1] += gc * (s[4 * j + 2 * h + 1] - (hi.y + lo.y));
          // one pair of loads in flight, not all 16: hoisted, they spill
          // at 240 registers
          asm volatile("" ::: "memory");
        }
      wg::named_barrier_sync(kWgBar + w, 128);  // every read of the dl tile is done
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h;
          wg::st_shared_u32(la + ptile_off(warp, ln, j, h),
                            wg::pack_bf16(s[i] * (dp[i] - dd[h]) * scale,
                                          s[i + 1] * (dp[i + 1] - dd[h]) * scale));
        }
      wg::fence_proxy_async();
      wg::named_barrier_sync(kWgBar + w, 128);
      // dM^T += round(p)^T . dout + (dl / sqrt(K))^T . y over the 64 rows
      const uint64_t dpa = wg::make_desc(pa, L::kPTile, 1024, 128);
      const uint64_t dla = wg::make_desc(la, L::kPTile, 1024, 128);
      const uint64_t ddo = wg::make_desc(da, L::kPanel, 8 * L::kRowBytes, L::kRowBytes);
      const uint64_t dya = wg::make_desc(ya, L::kPanel, 8 * L::kRowBytes, L::kRowBytes);
      wg::fence_regs(acc);
      wg::wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wg::wgmma_ss<K, 1, 1>(acc, dpa + ((j * 2048) >> 4), ddo + ((j * 16 * L::kRowBytes) >> 4), 1);
        wg::wgmma_ss<K, 1, 1>(acc, dla + ((j * 2048) >> 4), dya + ((j * 16 * L::kRowBytes) >> 4), 1);
      }
      wg::wgmma_commit();
      wg::wgmma_wait<0>();
      wg::fence_regs(acc);
      if (lt == 0) wg::mbar_arrive(t_empty + b);
    }
    // this split's partial dM (K x S, f32), transposed out of the registers
    float* dst = scratch + size_t(blockIdx.y) * K * S;
    const int g = lane / 4;
#pragma unroll
    for (int j = 0; j < K / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = c0 + warp * 16 + g + 8 * (e >> 1), k = 8 * j + 2 * q + (e & 1);
        if (s < S) dst[size_t(k) * S + s] = acc[4 * j + e];
      }
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
            float* __restrict__ out2, float* __restrict__ lse, float* __restrict__ qsum,
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
  float q11 = 0.f, q22 = 0.f, q12 = 0.f;  // view 0's threads
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
        if (view == 0)
#pragma unroll
          for (int j = 0; j < kColsF32 / 4; ++j) {
            const float p2 = xs[r * kLdC + q + 4 * j], d = lg[j] - p2;
            loss += valid ? d * d : 0.f;
            q11 += lg[j] * lg[j];
            q22 += p2 * p2;
            q12 += lg[j] * p2;
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
  if (view == 0) {
    const float qs[3] = {quad_sum(q11), quad_sum(q22), quad_sum(q12)};
    if (valid && q == 0)
      for (int i = 0; i < 3; ++i) qsum[i * rows + row] = qs[i];
  }
  const float s = block_sum(loss, xs);
  if (threadIdx.x == 0) partial[blockIdx.x] = s;
}

template <int K>
__global__ void __launch_bounds__(kThreads, 1)
mat_bwd_rows_f32(const float* __restrict__ y1, const float* __restrict__ y2,
                 const float* __restrict__ mem, const float* __restrict__ do1,
                 const float* __restrict__ do2, const float* __restrict__ out1,
                 const float* __restrict__ out2, const float* __restrict__ lse,
                 const float* __restrict__ qsum, const float* __restrict__ g_ct,
                 float* __restrict__ dy1, float* __restrict__ dy2, float* __restrict__ dsum,
                 int64_t rows, int S, float scale, float inv_n2) {
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
  const float dsum_r =
      row_dsum<K>(view ? do2 : do1, view ? out2 : out1, qsum, rows, row, view, q, gc);
  if (valid && q == 0) dsum[view * rows + row] = dsum_r;
  float acc[K / 4];
#pragma unroll
  for (int i = 0; i < K / 4; ++i) acc[i] = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    const int s0 = c * kColsF32;
    __syncthreads();
    f32_load_m<K>(mem, S, s0, ms);
    __syncthreads();
    float p[kColsF32 / 4], dp[kColsF32 / 4];
    f32_p_and_dp<K>(ys + off, ds + off, ms, q, view, s0, S, scale, lse_r, gc,
                    xs + r * kLdC, p, dp);
#pragma unroll
    for (int j = 0; j < kColsF32 / 4; ++j) p[j] = p[j] * (dp[j] - dsum_r) * scale;
    f32_x_mt<K>(p, ms, q, group, acc);
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

int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0) cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  return counts[dev];
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

template <int K>
cudaError_t fwd(const void* y1, const void* y2, const void* mem, void* out1, void* out2,
                float* lse, float* qsum, float* partial, float* loss, int64_t rows, int S,
                int ld, int dtype, float inv_n, cudaStream_t st) {
  static_assert(kRowsF32 == kHalf, "one loss partial per 32 rows in both kernels");
  const float scale = 1.f / sqrtf(float(K));
  cudaError_t err;
  const int n_partials = int((rows + kHalf - 1) / kHalf);
  if (dtype == 1) {
    using P = Panels<K>;
    if (rows > int64_t(0x7fffffff) - 64 || ld % 8 != 0 || ld < S) return cudaErrorInvalidValue;
    if (wg::encode_tiled() == nullptr) return cudaErrorNotSupported;
    // boxes of 32 rows of one view: the kernel stacks the views' rows
    void* maps_of[4] = {const_cast<void*>(y1), const_cast<void*>(y2), out1, out2};
    CUtensorMap maps[4], m_map;
    for (int i = 0; i < 4; ++i)
      if (!wg::make_map_2d(&maps[i], maps_of[i], rows, K, 2 * K, kHalf, P::kPw, P::kRowBytes))
        return cudaErrorInvalidValue;
    if (!wg::make_map_2d(&m_map, mem, K, S, 2 * uint64_t(ld), K, 64, 128))
      return cudaErrorInvalidValue;
    const int sms = sm_count();
    if (sms <= 0) return cudaErrorNoDevice;
    const int n_tiles = int((rows + kRowsR - 1) / kRowsR);
    if ((err = allow_smem(mat_fwd_bf16<K>, FwdLayout<K>::bytes)) != cudaSuccess) return err;
    mat_fwd_bf16<K><<<n_tiles < sms ? n_tiles : sms, kWgThreads, FwdLayout<K>::bytes, st>>>(
        maps[0], maps[1], m_map, maps[2], maps[3], lse, qsum, partial, rows, n_tiles, S,
        scale * 1.4426950408889634f);
  } else {
    if (ld != S) return cudaErrorInvalidValue;
    const size_t smem = (2 * f32_tile_floats<K>() + (K + kRowsF32) * kLdC) * 4;
    if ((err = allow_smem(mat_fwd_f32<K>, smem)) != cudaSuccess) return err;
    mat_fwd_f32<K><<<n_partials, kThreads, smem, st>>>(
        static_cast<const float*>(y1), static_cast<const float*>(y2),
        static_cast<const float*>(mem), static_cast<float*>(out1),
        static_cast<float*>(out2), lse, qsum, partial, rows, S, scale);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  sum_partials<<<1, kThreads, 0, st>>>(partial, n_partials, inv_n, loss);
  return cudaGetLastError();
}

template <int K>
cudaError_t bwd(const void* y1, const void* y2, const void* mem, const void* do1,
                const void* do2, const void* out1, const void* out2, const float* lse,
                const float* qsum, const float* g, void* dy1, void* dy2, float* dsum,
                float* scratch, float* dm, int64_t rows, int S, int ld, int dtype, int splits,
                float inv_n2, cudaStream_t st) {
  const float scale = 1.f / sqrtf(float(K));
  cudaError_t err;
  const int row_tile = dtype == 1 ? kHalf : kRowsF32;
  const int col_tile = dtype == 1 ? kColsC : kColsF32;
  const int n_tiles = int((rows + row_tile - 1) / row_tile);
  const int per_split = (n_tiles + splits - 1) / splits;
  const dim3 col_grid((S + col_tile - 1) / col_tile, splits);
  if (dtype == 1) {
    const bf16 *d1 = static_cast<const bf16*>(do1), *d2 = static_cast<const bf16*>(do2);
    using P = Panels<K>;
    if (rows > int64_t(0x7fffffff) - 64 || ld % 8 != 0 || ld < S) return cudaErrorInvalidValue;
    if (wg::encode_tiled() == nullptr) return cudaErrorNotSupported;
    // boxes of 32 rows of one view: both kernels stack the views' rows
    void* maps_of[6] = {const_cast<void*>(y1), const_cast<void*>(y2), const_cast<void*>(do1),
                        const_cast<void*>(do2), dy1, dy2};
    CUtensorMap maps[6], m_map;
    for (int i = 0; i < 6; ++i)
      if (!wg::make_map_2d(&maps[i], maps_of[i], rows, K, 2 * K, kHalf, P::kPw, P::kRowBytes))
        return cudaErrorInvalidValue;
    if (!wg::make_map_2d(&m_map, mem, K, S, 2 * uint64_t(ld), K, 64, 128))
      return cudaErrorInvalidValue;
    const int sms = sm_count();
    if (sms <= 0) return cudaErrorNoDevice;
    const int r_tiles = int((rows + kRowsR - 1) / kRowsR);
    if ((err = allow_smem(mat_bwd_rows_bf16<K>, RowsLayout<K>::bytes)) != cudaSuccess) return err;
    mat_bwd_rows_bf16<K><<<r_tiles < sms ? r_tiles : sms, kWgThreads, RowsLayout<K>::bytes,
                           st>>>(
        maps[0], maps[1], maps[2], maps[3], m_map, maps[4], maps[5], d1, d2,
        static_cast<const bf16*>(out1), static_cast<const bf16*>(out2), lse, qsum, g, dsum,
        rows, r_tiles, S, scale, inv_n2);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if ((err = allow_smem(mat_bwd_cols_bf16<K>, ColsLayout<K>::bytes)) != cudaSuccess) return err;
    mat_bwd_cols_bf16<K><<<col_grid, kWgThreads, ColsLayout<K>::bytes, st>>>(
        maps[0], maps[1], maps[2], maps[3], m_map, lse, dsum, g, scratch, rows, S, scale,
        inv_n2, per_split);
  } else {
    if (ld != S) return cudaErrorInvalidValue;
    const float *a1 = static_cast<const float*>(y1), *a2 = static_cast<const float*>(y2),
                *m = static_cast<const float*>(mem), *d1 = static_cast<const float*>(do1),
                *d2 = static_cast<const float*>(do2);
    const size_t rows_smem = (4 * f32_tile_floats<K>() + (K + kRowsF32) * kLdC) * 4;
    if ((err = allow_smem(mat_bwd_rows_f32<K>, rows_smem)) != cudaSuccess) return err;
    mat_bwd_rows_f32<K><<<n_tiles, kThreads, rows_smem, st>>>(
        a1, a2, m, d1, d2, static_cast<const float*>(out1), static_cast<const float*>(out2),
        lse, qsum, g, static_cast<float*>(dy1), static_cast<float*>(dy2), dsum, rows, S,
        scale, inv_n2);
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
// Forward: out1, out2 (rows, K) in y's type; lse (2, rows) f32; qsum (3,
// rows) f32, each row's <p1, p1>_S, <p2, p2>_S and <p1, p2>_S; partial (at
// least ceil(rows / mem_attention_train_tile(dtype, 0))) f32 scratch; loss
// one f32, the mean of (p1 - p2)^2 (inv_n = 1 / (rows * S)). M's rows are
// `ld` values apart, as for the backward.
extern "C" int mem_attention_train_fwd(const void* y1, const void* y2, const void* mem,
                                       void* out1, void* out2, float* lse, float* qsum,
                                       float* partial, float* loss, long long rows, int K,
                                       int S, int ld, int dtype, float inv_n, void* stream) {
  if (rows <= 0 || S <= 0 || (dtype != 0 && dtype != 1)) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 16: return int(fwd<16>(y1, y2, mem, out1, out2, lse, qsum, partial, loss, rows, S, ld, dtype, inv_n, st));
    case 256: return int(fwd<256>(y1, y2, mem, out1, out2, lse, qsum, partial, loss, rows, S, ld, dtype, inv_n, st));
    default: return int(cudaErrorInvalidValue);
  }
}

// Backward: out1, out2, lse and qsum are the forward's; g is the loss's
// cotangent (one f32 on the device, read by the kernels, so the host never
// waits); inv_n2 = 2 / (rows * S); dy1, dy2 in y's type; dsum (2, rows)
// f32 and scratch (splits, K, S) f32 are work space; dm (K, S) f32. M's
// rows are `ld` values apart: S for f32; for bf16 a multiple of 8, at least
// S (its tensor map).
extern "C" int mem_attention_train_bwd(const void* y1, const void* y2, const void* mem,
                                       const void* do1, const void* do2, const void* out1,
                                       const void* out2, const float* lse, const float* qsum,
                                       const float* g, void* dy1, void* dy2, float* dsum,
                                       float* scratch, float* dm, long long rows, int K,
                                       int S, int ld, int dtype, int splits, float inv_n2,
                                       void* stream) {
  if (rows <= 0 || S <= 0 || splits <= 0 || (dtype != 0 && dtype != 1))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 16: return int(bwd<16>(y1, y2, mem, do1, do2, out1, out2, lse, qsum, g, dy1, dy2, dsum, scratch, dm, rows, S, ld, dtype, splits, inv_n2, st));
    case 256: return int(bwd<256>(y1, y2, mem, do1, do2, out1, out2, lse, qsum, g, dy1, dy2, dsum, scratch, dm, rows, S, ld, dtype, splits, inv_n2, st));
    default: return int(cudaErrorInvalidValue);
  }
}

// The tiles the launches use: which 0 = rows (of each view) per loss
// partial of the forward, 1 = prototypes per column block of the backward,
// 2 = rows per row tile of the backward's column kernel (of each view).
extern "C" int mem_attention_train_tile(int dtype, int which) {
  if (dtype == 1) return which == 1 ? kColsC : kHalf;
  return which == 1 ? kColsF32 : kRowsF32;
}

extern "C" const char* mem_attention_train_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
