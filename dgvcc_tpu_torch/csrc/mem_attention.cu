// Prototype-memory attention for Hopper (sm_90a), two kernels behind one
// C entry point:
//
//     out[r, :] = softmax_S(y[r, :] . M / sqrt(K)) . M^T      r < rows
//
// y: (rows, K) row-major, M: (K, S) row-major with rows `ld` values apart,
// out: (rows, K) in y's type.
//
// Replaces the Pallas TPU kernel dgvcc_tpu/ops/mem_attention.py
// (_kernel / memory_attention_fused), which holds the whole bank in VMEM
// and takes the softmax over a full S row at once. A Hopper block has at
// most 227 KB of shared memory and the bank is 512 KiB in bf16, so here M
// streams through shared memory in chunks of S.
//
// Bound on the H100: per row 4*K*S flops (two products) against 4*K bytes
// moved (bf16 y in, out) -- 1024 flops per byte at K=256, S=1024, far
// above the card's ~295 bf16 flops per byte, so the tensor cores bound it.
//
// bf16 kernel: one pass with an online softmax (flash-attention style) on
// wgmma, fed by TMA, warp-specialised, persistent.
//   * A block is one producer warpgroup, in which one thread issues every
//     TMA load, and kConsumers warpgroups of 64 rows each; setmaxnreg
//     moves registers from the producer to the consumers.
//   * One block per SM walks over 128-row tiles. The producer loads a y
//     tile (128 x K) once per tile into one of kYBufs buffers, and M in
//     S-chunks (K x kChunk) into a ring of kStages stages, each guarded by
//     a full and an empty mbarrier. TMA zero-fills rows past `rows` and
//     columns past S; the kernel masks s >= S to -inf.
//   * Both products read the same shared copy of an M chunk: the logits
//     y . M with wgmma (A = the y tile, B = the chunk through an MN-major
//     descriptor), then o += p . M^T with the register form of wgmma (A =
//     p packed to bf16 from the logits' accumulators, B = the same chunk
//     through a K-major descriptor). The online softmax (running max and
//     sum in f32, exp2 with log2(e) folded into the scale) runs on the
//     accumulator layout in registers. A warpgroup issues the next chunk's
//     logits and this chunk's p . M^T together and takes the softmax while
//     the second runs, and the two consumer warpgroups take turns to issue
//     (ping-pong), so one's softmax overlaps the other's products.
//   * p is rounded to bf16 for the second product, as SDPA and the JAX
//     package's bf16 einsum path round the attention; o, the sum and the
//     max stay f32. The epilogue normalises o, stages it in bf16 in the
//     warpgroup's rows of the y tile and writes it with a TMA store
//     (clipped at `rows`).
//   * No float atomics: every output row is written once, by one block.
//   * The constants below are the design's; scripts/sweep_mem_attention.py
//     builds and times their variants (H100 times in PERF.md: 64-prototype
//     chunks, 3 stages and 2 y buffers measured fastest).
//
// f32 kernel: two passes (row statistics, then the normalised p) in plain
// f32 FMA on the CUDA cores, no TF32 anywhere.
//
// Any number of rows (masked tail) and any S (masked tail); K must be one
// of the instantiated widths (16, 32, 64, 128, 256). The bf16 kernel needs
// 16-byte aligned y, M and out and a row pitch `ld` of M that is a
// multiple of 8 (the wrapper pads M's columns).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_sm90.cuh"

namespace {

using namespace wgmma_sm90;

// -------------------------------------------------------- bf16 / wgmma, TMA
constexpr int kChunk = 64;        // prototypes per S-chunk, a multiple of 64
constexpr int kStages = 3;        // M chunks in flight
constexpr int kYBufs = 2;         // y tiles in flight (the next tile's loads early)
constexpr int kConsumers = 2;     // consumer warpgroups, 64 rows each, taking turns
constexpr int kTileRows = 64 * kConsumers;
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // 128 * (40 + 2 * 232) = 384 * 168
constexpr int kSmemMax = 232448;
constexpr int kEpilogueBar = 1;   // named barriers: 1 + wg (a warpgroup's epilogue),
constexpr int kTurnBar = 3;       // 3 + wg (its turn to issue products)
static_assert(kConsumers == 2, "ping-pong: two consumer warpgroups");

template <int K>
struct Layout {
  static constexpr int kPw = K < 64 ? K : 64;            // values per y row of a panel
  static constexpr int kRowBytes = 2 * kPw;              // = the y tile's swizzle
  static constexpr int kPanels = K / kPw;
  static constexpr uint32_t kYPanel = kTileRows * kRowBytes;
  static constexpr uint32_t kYTile = kYPanel * kPanels;  // 128 x K bf16
  static constexpr uint32_t kMPanel = K * 128;           // K rows x 64 prototypes
  static constexpr uint32_t kMStage = kMPanel * (kChunk / 64);
  static constexpr uint32_t y = 0;                       // offsets from a 1024-aligned base
  static constexpr uint32_t m = y + kYBufs * kYTile;
  static constexpr uint32_t bars = m + kStages * kMStage;
  static constexpr uint32_t bytes = bars + 16 * (kYBufs + kStages) + 1024;  // + alignment
  static_assert(kChunk % 64 == 0, "kChunk");
  static_assert(bytes <= kSmemMax, "shared memory");
};

constexpr int kPanelsS = kChunk / 64;  // 64-prototype panels of a chunk

// s = y . M[:, chunk] (issued, not waited for): A = this warpgroup's 64 y
// rows at `ya` (K-major, y's swizzle), B = the chunk at `mb` (MN-major,
// 128 B). A slice's descriptor is the base one plus its offset >> 4.
template <int K>
__device__ __forceinline__ void issue_logits(float (&s)[kPanelsS][32], uint32_t ya, uint32_t mb) {
  using L = Layout<K>;
  constexpr int kSlicesY = L::kPw / 16;  // k16 slices per y panel
  const uint64_t da = make_desc(ya, 16, 8 * L::kRowBytes, L::kRowBytes);
  const uint64_t db = make_desc(mb, L::kMPanel, 1024, 128);
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
    for (int pp = 0; pp < kPanelsS; ++pp)
      wgmma_ss<64, 0, 1>(s[pp], da + (((kk / kSlicesY) * L::kYPanel + (kk % kSlicesY) * 32) >> 4),
                         db + ((pp * L::kMPanel + kk * 2048) >> 4), kk > 0);
}

// o += p . M[:, chunk]^T (issued, not waited for): A = p in registers,
// B = the same chunk at `mb` (K-major, 128 B)
template <int K>
__device__ __forceinline__ void issue_accumulate(float (&o)[K / 2],
                                                 const uint32_t (&pa)[kChunk / 16][4],
                                                 uint32_t mb) {
  using L = Layout<K>;
  const uint64_t db = make_desc(mb, 16, 1024, 128);
#pragma unroll
  for (int j = 0; j < kChunk / 16; ++j)
    wgmma_rs<K, 0>(o, pa[j], db + (((j / 4) * L::kMPanel + (j % 4) * 32) >> 4), 1);
}

// s (logits of the chunk from s0, accumulator layout) -> exp2 values; the
// running max (log2 units) and this thread's share of the sum of rows g,
// g + 8; alpha rescales what o holds of the chunks before
__device__ __forceinline__ void online_softmax(float (&s)[kPanelsS][32], float (&m_run)[2],
                                               float (&l_run)[2], float (&alpha)[2], int s0,
                                               int S, int q, float scale_log2) {
  const bool tail = s0 + kChunk > S;
  const int lim = S - s0 - 2 * q;  // column 64 pp + 8 (i / 4) + (i & 1) of the chunk is >= S
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int pp = 0; pp < kPanelsS; ++pp)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float v = s[pp][i] * scale_log2;
      if (tail && 64 * pp + 8 * (i / 4) + (i & 1) >= lim) v = -INFINITY;
      s[pp][i] = v;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], v);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m_run[h], mx[h]);  // finite: every chunk has a column < S
    alpha[h] = fast_exp2(m_run[h] - m_new);
    m_run[h] = m_new;
    l_run[h] *= alpha[h];
  }
#pragma unroll
  for (int pp = 0; pp < kPanelsS; ++pp)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float e = fast_exp2(s[pp][i] - m_run[(i >> 1) & 1]);
      l_run[(i >> 1) & 1] += e;
      s[pp][i] = e;
    }
}

// p (f32 accumulator layout) -> bf16 A fragments of the k16 slices
__device__ __forceinline__ void pack_p(uint32_t (&pa)[kChunk / 16][4],
                                       const float (&s)[kPanelsS][32]) {
#pragma unroll
  for (int j = 0; j < kChunk / 16; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pa[j][i] = pack_bf16(s[j / 4][8 * (j % 4) + 2 * i], s[j / 4][8 * (j % 4) + 2 * i + 1]);
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] *= alpha[(i >> 1) & 1];
}

__device__ __forceinline__ void fence_chunk(float (&s)[kPanelsS][32]) {
#pragma unroll
  for (int pp = 0; pp < kPanelsS; ++pp) fence_regs(s[pp]);
}
__device__ __forceinline__ void fence_chunk(uint32_t (&pa)[kChunk / 16][4]) {
#pragma unroll
  for (int j = 0; j < kChunk / 16; ++j) fence_regs(pa[j]);
}

template <int K>
__global__ void __launch_bounds__(kThreads, 1)
mem_attention_bf16_kernel(const __grid_constant__ CUtensorMap y_map,
                          const __grid_constant__ CUtensorMap m_map,
                          const __grid_constant__ CUtensorMap out_map, int n_tiles, int S,
                          float scale_log2) {
  using L = Layout<K>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* y_full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* y_empty = y_full + kYBufs;
  uint64_t* m_full = y_empty + kYBufs;
  uint64_t* m_empty = m_full + kStages;
  const int n_chunks = (S + kChunk - 1) / kChunk;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kYBufs; ++i) {
      mbar_init(y_full + i, 1);
      mbar_init(y_empty + i, kConsumers);
    }
    for (int i = 0; i < kStages; ++i) {
      mbar_init(m_full + i, 1);
      mbar_init(m_empty + i, kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(y_map);
      tma_prefetch_map(m_map);
      tma_prefetch_map(out_map);
      uint32_t it = 0, t = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++t) {
        const uint32_t yb = t % kYBufs;
        mbar_wait(y_empty + yb, ((t / kYBufs) & 1) ^ 1);
        mbar_arrive_expect_tx(y_full + yb, L::kYTile);
        unsigned char* ys = smem + L::y + yb * L::kYTile;
        for (int p = 0; p < L::kPanels; ++p)
          tma_load_2d(ys + p * L::kYPanel, y_map, p * L::kPw, tile * kTileRows, y_full + yb);
        for (int c = 0; c < n_chunks; ++c, ++it) {
          const uint32_t st = it % kStages;
          mbar_wait(m_empty + st, ((it / kStages) & 1) ^ 1);
          mbar_arrive_expect_tx(m_full + st, L::kMStage);
          unsigned char* ms = smem + L::m + st * L::kMStage;
          for (int p = 0; p < kChunk / 64; ++p)
            tma_load_2d(ms + p * L::kMPanel, m_map, c * kChunk + p * 64, 0, m_full + st);
        }
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    setmaxnreg_inc<kConsumerRegs>();
    // warp-uniform to the compiler (a broadcast), so that the descriptors
    // derived from it live in uniform registers
    const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0) - 1;
    const int lt = threadIdx.x % 128;
    const int warp = lt / 32, lane = lt % 32;
    const int q = lane % 4;  // the accumulator's column pair
    uint32_t it = 0, t = 0;
    // a warpgroup issues its products between turn_begin and turn_end; the
    // two take turns, starting with warpgroup 0, so that one's softmax runs
    // while the other's products keep the tensor cores busy
    if (wg == 0) named_barrier_arrive(kTurnBar, 256);
    auto turn_begin = [&] { named_barrier_sync(kTurnBar + wg, 256); };
    auto turn_end = [&] { named_barrier_arrive(kTurnBar + 1 - wg, 256); };

    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++t) {
      const uint32_t yb = t % kYBufs;
      unsigned char* ys = smem + L::y + yb * L::kYTile;
      const uint32_t ya = smem_u32(ys) + wg * 64 * L::kRowBytes;  // this warpgroup's rows
      float o[K / 2];
#pragma unroll
      for (int i = 0; i < K / 2; ++i) o[i] = 0.f;
      float m_run[2] = {-INFINITY, -INFINITY};  // rows g, g + 8 of the warp, log2 units
      float l_run[2] = {0.f, 0.f};               // this thread's share of the sum
      float s[kPanelsS][32];                     // logits, then p, of one chunk
      uint32_t pa[kChunk / 16][4];               // p in bf16 as wgmma A fragments
      auto stage = [&](uint32_t st) { return smem_u32(smem + L::m + st * L::kMStage); };

      mbar_wait(y_full + yb, (t / kYBufs) & 1);
      float alpha[2];
      // chunk 0: logits, softmax; then chunk c's logits beside chunk c-1's
      // p . M^T, the softmax of c while the second runs
      uint32_t prev = it % kStages;
      mbar_wait(m_full + prev, (it / kStages) & 1);
      ++it;
      turn_begin();
      wgmma_fence();
      issue_logits<K>(s, ya, stage(prev));
      wgmma_commit();
      turn_end();
      wgmma_wait<0>();
      fence_chunk(s);
      online_softmax(s, m_run, l_run, alpha, 0, S, q, scale_log2);
      pack_p(pa, s);
      for (int c = 1; c < n_chunks; ++c, ++it) {
        const uint32_t st = it % kStages;
        mbar_wait(m_full + st, (it / kStages) & 1);
        fence_regs(o);
        fence_chunk(pa);
        turn_begin();
        wgmma_fence();
        issue_logits<K>(s, ya, stage(st));
        wgmma_commit();
        issue_accumulate<K>(o, pa, stage(prev));
        wgmma_commit();
        turn_end();
        wgmma_wait<1>();
        fence_chunk(s);
        online_softmax(s, m_run, l_run, alpha, c * kChunk, S, q, scale_log2);
        wgmma_wait<0>();
        fence_regs(o);
        fence_chunk(pa);
        if (lt == 0) mbar_arrive(m_empty + prev);
        rescale(o, alpha);
        pack_p(pa, s);
        prev = st;
      }
      fence_regs(o);
      fence_chunk(pa);
      turn_begin();
      wgmma_fence();
      issue_accumulate<K>(o, pa, stage(prev));
      wgmma_commit();
      turn_end();
      wgmma_wait<0>();
      fence_regs(o);
      if (lt == 0) mbar_arrive(m_empty + prev);

      // epilogue: normalise, stage bf16 rows in this warpgroup's rows of the
      // y tile (its own reads of them are complete), TMA store. The
      // addresses derive from an opaque lane so that they are recomputed
      // here, not held in registers across the tile loop.
      float inv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float l = l_run[h];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        inv[h] = 1.f / l;
      }
      const uint32_t ln = opaque(lane), yaddr = smem_u32(ys);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t row = wg * 64 + warp * 16 + ln / 4 + 8 * h;
#pragma unroll
        for (int j = 0; j < K / 8; ++j) {
          const uint32_t col = 8 * j + 2 * (ln % 4);
          st_shared_u32(yaddr + (col / L::kPw) * L::kYPanel +
                            swizzle(row * L::kRowBytes + (col % L::kPw) * 2, L::kRowBytes),
                        pack_bf16(o[4 * j + 2 * h] * inv[h], o[4 * j + 2 * h + 1] * inv[h]));
        }
      }
      fence_proxy_async();
      named_barrier_sync(kEpilogueBar + wg, 128);
      if (lt == 0) {
        for (int p = 0; p < L::kPanels; ++p)
          tma_store_2d(out_map, ys + p * L::kYPanel + wg * 64 * L::kRowBytes, p * L::kPw,
                       tile * kTileRows + wg * 64);
        tma_store_commit();
        tma_store_wait_read<0>();
        mbar_arrive(y_empty + yb);
      }
    }
    if (lt == 0) tma_store_wait<0>();
  }
}

// ------------------------------------------------------------------ f32 / FMA
constexpr int kRowsF = 32;          // rows per block, 4 threads per row
constexpr int kChunkF = 32;         // prototypes per S-chunk
constexpr int kLdMF = kChunkF + 1;  // f32 stride of the M chunk in smem

template <int K>
__global__ void __launch_bounds__(128)
mem_attention_f32_kernel(const float* __restrict__ y, const float* __restrict__ mem,
                         float* __restrict__ out, int64_t rows, int S, float scale) {
  constexpr int kLdYF = K + 1;
  extern __shared__ __align__(128) unsigned char smem[];
  float* ys = reinterpret_cast<float*>(smem);          // kRowsF x kLdYF
  float* ms = ys + kRowsF * kLdYF;                      // K x kLdMF
  const int64_t row0 = int64_t(blockIdx.x) * kRowsF;
  const int lane = threadIdx.x % 32;
  const int r = threadIdx.x / 4, q = threadIdx.x % 4;  // row in tile, quarter
  const unsigned group = lane & ~3;                     // first lane of the row's 4

  for (int i = threadIdx.x; i < kRowsF * K; i += 128) {
    const int rr = i / K, k = i % K;
    ys[rr * kLdYF + k] = (row0 + rr < rows) ? y[(row0 + rr) * K + k] : 0.f;
  }
  const int n_chunks = (S + kChunkF - 1) / kChunkF;
  float m_run = -INFINITY, l_run = 0.f;
  float acc_o[K / 4];
#pragma unroll
  for (int i = 0; i < K / 4; ++i) acc_o[i] = 0.f;

  for (int pass = 0; pass < 2; ++pass) {
    const float inv_l = pass ? 1.f / l_run : 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      const int s0 = c * kChunkF;
      __syncthreads();
      for (int i = threadIdx.x; i < K * kChunkF; i += 128) {
        const int k = i / kChunkF, s = i % kChunkF;
        ms[k * kLdMF + s] = (s0 + s < S) ? mem[int64_t(k) * S + s0 + s] : 0.f;
      }
      __syncthreads();
      // this thread's 8 logits: columns q + 4j of the chunk
      float lg[kChunkF / 4];
#pragma unroll
      for (int j = 0; j < kChunkF / 4; ++j) lg[j] = 0.f;
      for (int k = 0; k < K; ++k) {
        const float a = ys[r * kLdYF + k];
#pragma unroll
        for (int j = 0; j < kChunkF / 4; ++j) lg[j] = fmaf(a, ms[k * kLdMF + q + 4 * j], lg[j]);
      }
#pragma unroll
      for (int j = 0; j < kChunkF / 4; ++j)
        lg[j] = (s0 + q + 4 * j < S) ? lg[j] * scale : -INFINITY;
      if (pass == 0) {
        float cmax = -INFINITY;
#pragma unroll
        for (int j = 0; j < kChunkF / 4; ++j) cmax = fmaxf(cmax, lg[j]);
        cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, 1));
        cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, 2));
        const float m_new = fmaxf(m_run, cmax);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kChunkF / 4; ++j) sum += expf(lg[j] - m_new);
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l_run = l_run * expf(m_run - m_new) + sum;
        m_run = m_new;
      } else {
#pragma unroll
        for (int j = 0; j < kChunkF / 4; ++j) lg[j] = expf(lg[j] - m_run) * inv_l;
        // out[r, q + 4i] += sum_s p[r, s] * M[q + 4i, s]; p[s] lives in lane q = s % 4
#pragma unroll
        for (int s = 0; s < kChunkF; ++s) {
          const float p = __shfl_sync(0xffffffffu, lg[s / 4], group | (s % 4));
#pragma unroll
          for (int i = 0; i < K / 4; ++i) acc_o[i] = fmaf(p, ms[(q + 4 * i) * kLdMF + s], acc_o[i]);
        }
      }
    }
  }
  if (row0 + r < rows) {
#pragma unroll
    for (int i = 0; i < K / 4; ++i) out[(row0 + r) * K + q + 4 * i] = acc_o[i];
  }
}

int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0) cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  return counts[dev];
}

template <int K>
cudaError_t launch_bf16(const void* y, const void* mem, void* out, int64_t rows, int S, int ld,
                        cudaStream_t stream) {
  using L = Layout<K>;
  if (rows > int64_t(0x7fffffff) - kTileRows || ld % 8 != 0 || ld < S)
    return cudaErrorInvalidValue;
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  CUtensorMap y_map, m_map, out_map;
  if (!make_map_2d(&y_map, y, rows, K, 2 * K, kTileRows, L::kPw, L::kRowBytes) ||
      !make_map_2d(&m_map, mem, K, S, 2 * uint64_t(ld), K, 64, 128) ||
      !make_map_2d(&out_map, out, rows, K, 2 * K, 64, L::kPw, L::kRowBytes))
    return cudaErrorInvalidValue;
  const int n_tiles = int((rows + kTileRows - 1) / kTileRows);
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorNoDevice;
  cudaError_t err = cudaFuncSetAttribute(mem_attention_bf16_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(L::bytes));
  if (err != cudaSuccess) return err;
  const float scale_log2 = 1.4426950408889634f / sqrtf(float(K));
  const dim3 grid(unsigned(n_tiles < sms ? n_tiles : sms));  // persistent: a block per SM
  mem_attention_bf16_kernel<K><<<grid, kThreads, L::bytes, stream>>>(y_map, m_map, out_map,
                                                                     n_tiles, S, scale_log2);
  return cudaGetLastError();
}

template <int K>
cudaError_t dispatch(const void* y, const void* mem, void* out, int64_t rows, int S, int ld,
                     int dtype, cudaStream_t stream) {
  if (dtype == 1) return launch_bf16<K>(y, mem, out, rows, S, ld, stream);
  if (ld != S) return cudaErrorInvalidValue;
  const float scale = 1.f / sqrtf(float(K));
  const size_t smem = (size_t(kRowsF) * (K + 1) + size_t(K) * kLdMF) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(mem_attention_f32_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(unsigned((rows + kRowsF - 1) / kRowsF));
  mem_attention_f32_kernel<K><<<grid, 128, smem, stream>>>(
      static_cast<const float*>(y), static_cast<const float*>(mem), static_cast<float*>(out),
      rows, S, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; ld: the row pitch of M in values (S
// for float32; a multiple of 8, at least S, for bfloat16). Returns a
// cudaError_t (0 = launched): cudaErrorInvalidValue for a K that has no
// instantiation or arguments the kernel does not take.
extern "C" int mem_attention_fwd(const void* y, const void* mem, void* out,
                                 long long rows, int K, int S, int ld, int dtype,
                                 void* stream) {
  if (rows <= 0) return 0;
  if (S <= 0 || (dtype != 0 && dtype != 1)) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 16: return int(dispatch<16>(y, mem, out, rows, S, ld, dtype, st));
    case 32: return int(dispatch<32>(y, mem, out, rows, S, ld, dtype, st));
    case 64: return int(dispatch<64>(y, mem, out, rows, S, ld, dtype, st));
    case 128: return int(dispatch<128>(y, mem, out, rows, S, ld, dtype, st));
    case 256: return int(dispatch<256>(y, mem, out, rows, S, ld, dtype, st));
    default: return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* mem_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
