// Int8 convolution with a fused epilogue for Hopper (sm_90a):
//
//     acc[n, i, j, c] = sum_{r, q, k} xq[n, i u + r d - pad_h, j u + q d - pad_w, k]
//                                     * w8[c, r, q, k]        (int32, SAME zeros)
//     y = float(acc) * (ws[c] * s) + bias[c]  [, ReLU]  -> f32 or bf16, NHWC
//
// xq: (N, H, W, Cin) int8, contiguous (channels last); w8: (Cout, kh, kw, Cin)
// int8, contiguous; ws, bias: (Cout,) f32; s: the site's activation scale;
// y: (N, ceil(H / u), ceil(W / u), Cout). Stride u in 1..8, dilation d >= 1,
// odd kh and kw, or an even window at its own stride (kh = kw = u: CCTrans's
// patch embeddings and GSA's sr convolutions); the padding is flax's / XLA's
// 'SAME': total = max((ceil(n / u) - 1) u + (k - 1) d + 1 - n, 0) on a side
// of n, total / 2 of it low, the rest high (d (k / 2) each side at stride 1).
// Cin a multiple of 16 (TMA's 16-byte strides; ops/qconv.py pads any other
// Cin with zero channels, which leaves the accumulator exact), Cout >= 1,
// any N, H, W.
//
// Replaces no pl.pallas_call: on the TPU, XLA ran this convolution itself
// (dgvcc_tpu/nn/quant.py:290-295, QuantizedDG._qconv, and :508-514,
// QuantizedConvNet._qconv: conv_general_dilated of int8 operands with
// preferred_element_type=int32, then the f32 epilogue). PyTorch has no CUDA
// int8 convolution, so the port's int8 serving path needs this one.
//
// The rounding is the JAX graph's: ws[c] * s rounded to f32 first, then the
// product with float(acc) and the bias added, each rounded on its own
// (__fmul_rn / __fadd_rn: no FMA contraction), the bf16 output rounded to
// nearest even. So the f32 and bf16 outputs equal the plain version's
// (ops/qconv.py::qconv_int8_reference) bit for bit, given the same acc.
//
// Bound on the H100: 2 N H W Cout kh kw Cin operations at 1,979 TOP/s
// (dense int8), or the bytes (xq, w8 read once, y written once) at
// 3.35 TB/s. final's sites at 768x1024 fall on both sides: the 256- and
// 512-channel 3x3 sites are bound by operations (the heaviest, (4, 96,
// 128, 1024) -> 512, at 0.2344 ms), the 64-channel sites at full size by
// bytes (their bf16 output: 0.1803 ms at B=4).
//
// Design: an implicit GEMM on wgmma with s8 operands, fed by TMA,
// warp-specialised and persistent.
//   * M is output pixels, N output channels, K the taps times Cin in chunks
//     of kBK bytes. A block's M tile is a TH x TW = 128-pixel rectangle of
//     one image (TW the power of two from W up to 64).
//   * A by TMA in tiled mode from a 4-D map of xq (Cin, W, H, N) with a
//     box (kBK, TW u, TH u, 1) and element strides (1, u, u, 1): tap (r, q)
//     loads the TW x TH pixels (c0, w0 u + q d - pad_w + u j,
//     h0 u + r d - pad_h + u i, n), packed as at stride 1, and TMA fills
//     every coordinate outside the image, negative ones included, with
//     zeros. That is SAME padding, dilation and stride with no code per
//     element, and no address a thread computes. TMA's box spans at most
//     256 elements a dimension, so TW u <= 256 and TH u <= 256 (at u = 8:
//     4 <= TW <= 32).
//   * B by TMA from a 3-D map of w8 (Cin, kh kw, Cout) with a box (kBK, 1,
//     BN): channels past Cin and rows past Cout arrive as zeros.
//   * kBK is 128 bytes with the 128-byte swizzle when Cin % 128 == 0, 64
//     when Cin % 64 == 0, else 32; both operands are K-major, the only
//     layout 8-bit wgmma takes, which is already NHWC xq's and w8's.
//   * One producer warp (one thread) keeps a ring of kStages stages full,
//     each guarded by a full and an empty mbarrier; two consumer
//     warpgroups own 64 rows each and issue m64nBNk32 wgmma from the ring;
//     setmaxnreg moves registers from the producer to them.
//   * One block per SM walks the tiles one N column at a time, so that the
//     weights of that column stay in L2 (the 1024 -> 512 site's are
//     4.7 MB). The producer runs up to kStages steps ahead, into the next
//     tile while the consumers run the epilogue.
//   * BN follows Cout: 64 up to 64 channels (the byte-bound full-size
//     sites), 128 up to 128, else 128 or 256, whichever leaves the last
//     wave of tiles least idle.
//   * Two schedules, picked by the shapes alone (qconv_int8_plan says which
//     a call takes): the per-tap one above (BN 64, 128, 256 x kBK 32, 64,
//     128), and for 3x3 sites with one K chunk of 32 or 64 bytes a tap and
//     Cout <= 128 (final's 768x1024 and 384x512 sites, where a tap's products are
//     short and the per-tap loads re-read each pixel nine times from L2)
//     the halo schedule below: weights resident, one halo tile a stage,
//     the warpgroups taking whole tiles in turn, and a bf16 output with
//     Cout % 8 == 0 staged in shared memory and written by TMA stores
//     that run on under the next tile's products (direct stores from the
//     registers took as long as the products at these sites).
//   * The epilogue runs from the accumulator registers (the s32 layout is
//     wgmma's f32 one) and stores the pixels that fall inside the image.
//     The tile's ws * s and biases are staged in shared memory before its
//     main loop: read from global memory between the stores, each waited a
//     full load latency (the compiler cannot move a load across a store it
//     may alias), which took more time than the tile's products.
//   * mbar_wait holds no trap and every wgmma is committed outside any
//     branch: either makes ptxas serialise every wgmma of the kernel
//     (C7512, C7514), and chip_smoke.py phase 1 fails on both.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_sm90.cuh"

namespace {

using namespace wgmma_sm90;

constexpr int kTileM = 128;                       // output pixels a tile
constexpr int kConsumers = 2;                     // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * (1 + kConsumers);  // + the producer warpgroup
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // 128 * (40 + 2 * 232) = 384 * 168
constexpr int kSmemMax = 232448;
constexpr int kRingBytes = 200 * 1024;            // the stage ring's budget
constexpr int kMaxStages = 8;
constexpr int kOutBF16 = 1, kOutAcc = 2;  // 0: f32
constexpr int kScalesBar = 1, kScalesReadyBar = 2;  // named barriers of the 256 consumer threads
constexpr int kStoreBar = 3;                        // 3 + wg: a warpgroup's 128 threads

template <int BN, int BK>
struct Cfg {
  static constexpr uint32_t kA = kTileM * BK;  // a stage's A tile: 128 pixels x BK bytes
  static constexpr uint32_t kB = BN * BK;      // and its B tile: BN channels x BK bytes
  static constexpr uint32_t kStage = kA + kB;
  static constexpr int kStages =
      int(kRingBytes / kStage) < kMaxStages ? int(kRingBytes / kStage) : kMaxStages;
  static constexpr uint32_t a = 0;             // offsets from a 1024-aligned base
  static constexpr uint32_t b = a + kStages * kA;
  static constexpr uint32_t epi = b + kStages * kB;  // a tile's scales and biases (f32)
  static constexpr uint32_t bars = epi + 8 * BN;
  static constexpr uint32_t bytes = bars + 16 * kStages + 1024;  // + alignment
  static_assert(kStages >= 2, "stages");
  static_assert(kA % 1024 == 0 && kB % 1024 == 0, "tiles 1024-byte aligned for the swizzle");
  static_assert(bytes <= kSmemMax, "shared memory");
};

struct Params {
  const float* __restrict__ ws;
  const float* __restrict__ bias;
  void* __restrict__ out;
  float s;
  int h, w;                        // the output's height and width
  int cout, kw, taps, dil, stride, pad_h, pad_w, relu, out_kind;
  int chunks;                      // Cin / kBK, rounded up
  int tw, th, tiles_w, tiles_h, tiles_m, n_tiles;
  int stages, halo_bytes, halo_stride;  // the halo schedule's ring
  int tma_store;                        // the halo schedule stores bf16 tiles by TMA
};

struct Tile {
  int img, h0, w0, n0;
};

// tiles walk one N column at a time: all blocks share its weights in L2
template <int BN>
__device__ __forceinline__ Tile tile_at(const Params& p, int t) {
  const int nt = t / p.tiles_m, mt = t - nt * p.tiles_m;
  const int per_img = p.tiles_h * p.tiles_w;
  const int img = mt / per_img, rem = mt - img * per_img;
  const int ty = rem / p.tiles_w, tx = rem - ty * p.tiles_w;
  return {img, ty * p.th, tx * p.tw, nt * BN};
}

__device__ __forceinline__ float epilogue(int a, float scale, float bias, int relu) {
  const float y = __fadd_rn(__fmul_rn(__int2float_rn(a), scale), bias);
  return relu ? (y > 0.f ? y : 0.f) : y;
}

// accumulator values 4j + 2h + {0, 1} (row g + 8h of the warp, columns
// 8j + 2q + {0, 1}) of this thread -> the output of the pixels in the image;
// sc, bi: the tile's ws * s and biases in shared memory
template <int BN>
__device__ __forceinline__ void store_tile(const Params& p, const Tile& t, const int (&acc)[BN / 2],
                                           const float* sc, const float* bi, int wg, int warp,
                                           int lane) {
  const int g = lane >> 2, q = lane & 3;
  long long pix[2];  // output pixel (n H + y) W + x of rows g, g + 8; -1 outside the image
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wg * 64 + warp * 16 + g + 8 * h;
    const int th = r / p.tw, tw = r - th * p.tw;
    const int y = t.h0 + th, x = t.w0 + tw;
    pix[h] = (y < p.h && x < p.w) ? (static_cast<long long>(t.img) * p.h + y) * p.w + x : -1;
  }
  const bool pairs = (p.cout & 1) == 0;  // two columns a store
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int cl = 8 * j + 2 * q, c = t.n0 + cl;
    if (c >= p.cout) continue;
    const bool two = c + 1 < p.cout;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (pix[h] < 0) continue;
      const long long o = pix[h] * p.cout + c;
      const int a0 = acc[4 * j + 2 * h], a1 = acc[4 * j + 2 * h + 1];
      if (p.out_kind == kOutAcc) {
        int* out = static_cast<int*>(p.out) + o;
        if (pairs) {
          *reinterpret_cast<int2*>(out) = make_int2(a0, a1);
        } else {
          out[0] = a0;
          if (two) out[1] = a1;
        }
      } else {
        const float y0 = epilogue(a0, sc[cl], bi[cl], p.relu);
        const float y1 = epilogue(a1, sc[cl + 1], bi[cl + 1], p.relu);
        if (p.out_kind == kOutBF16) {
          __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) + o;
          if (pairs) {
            *reinterpret_cast<__nv_bfloat162*>(out) =
                __halves2bfloat162(__float2bfloat16_rn(y0), __float2bfloat16_rn(y1));
          } else {
            out[0] = __float2bfloat16_rn(y0);
            if (two) out[1] = __float2bfloat16_rn(y1);
          }
        } else {
          float* out = static_cast<float*>(p.out) + o;
          if (pairs) {
            *reinterpret_cast<float2*>(out) = make_float2(y0, y1);
          } else {
            out[0] = y0;
            if (two) out[1] = y1;
          }
        }
      }
    }
  }
}

template <int BN, int BK>
__global__ void __launch_bounds__(kThreads, 1)
qconv_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                   const __grid_constant__ CUtensorMap w_map, const Params p) {
  using C = Cfg<BN, BK>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::bars);
  uint64_t* empty = full + C::kStages;
  const int k_iters = p.taps * p.chunks;

  if (threadIdx.x == 0) {
    for (int i = 0; i < C::kStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(x_map);
      tma_prefetch_map(w_map);
      uint32_t it = 0;
      for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
        const Tile t = tile_at<BN>(p, tile);
        for (int tap = 0; tap < p.taps; ++tap) {
          const int r = tap / p.kw, q = tap - r * p.kw;
          const int hi = t.h0 * p.stride + r * p.dil - p.pad_h;
          const int wi = t.w0 * p.stride + q * p.dil - p.pad_w;
          for (int c = 0; c < p.chunks; ++c, ++it) {
            const uint32_t st = it % C::kStages;
            mbar_wait(empty + st, ((it / C::kStages) & 1) ^ 1);
            mbar_arrive_expect_tx(full + st, C::kStage);
            tma_load_4d(smem + C::a + st * C::kA, x_map, c * BK, wi, hi, t.img, full + st);
            tma_load_3d(smem + C::b + st * C::kB, w_map, c * BK, tap, t.n0, full + st);
          }
        }
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    setmaxnreg_inc<kConsumerRegs>();
    // warp-uniform to the compiler (a broadcast), so that the descriptors
    // derived from it live in uniform registers
    const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0) - 1;
    const int lt = threadIdx.x % 128, warp = lt / 32, lane = lt % 32;
    float* sc = reinterpret_cast<float*>(smem + C::epi);
    float* bi = sc + BN;
    uint32_t it = 0;
    for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
      const Tile t = tile_at<BN>(p, tile);
      // the tile's ws * s and biases, staged once: both warpgroups are done
      // with the previous tile's first
      named_barrier_sync(kScalesBar, 256);
      if (p.out_kind != kOutAcc)
        for (int cl = threadIdx.x - 128; cl < BN; cl += 256) {
          const int c = t.n0 + cl;
          sc[cl] = c < p.cout ? __fmul_rn(p.ws[c], p.s) : 0.f;
          bi[cl] = c < p.cout ? p.bias[c] : 0.f;
        }
      int acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      for (int k = 0; k < k_iters; ++k, ++it) {
        const uint32_t st = it % C::kStages;
        mbar_wait(full + st, (it / C::kStages) & 1);
        const uint64_t da =
            make_desc(smem_u32(smem + C::a + st * C::kA) + wg * 64 * BK, 16, 8 * BK, BK);
        const uint64_t db = make_desc(smem_u32(smem + C::b + st * C::kB), 16, 8 * BK, BK);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)
          wgmma_ss_s8<BN>(acc, da + ((kk * 32) >> 4), db + ((kk * 32) >> 4), 1);
        wgmma_commit();
        wgmma_wait<1>();  // step k - 1's products are done: its stage is free
        fence_regs(acc);
        if (k > 0 && lt == 0) mbar_arrive(empty + (it - 1) % C::kStages);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (k_iters > 0 && lt == 0) mbar_arrive(empty + (it - 1) % C::kStages);
      named_barrier_sync(kScalesReadyBar, 256);
      store_tile<BN>(p, t, acc, sc, bi, wg, warp, lane);
    }
  }
}

// The halo schedule, for 3x3 sites whose K is one chunk of kBK bytes a tap
// and whose Cout fits one BN tile (final's 768x1024 and 384x512 sites):
// there a tap's products are short, and the per-tap schedule above re-reads
// the same pixels and weights from L2 for each of the nine taps. Here the
// block loads the weights of every tap, and the tile's scales and biases,
// once and keeps them; a stage is one halo tile, the (TH + 2 pad_h) x
// (TW + 2 pad_w) pixels that all taps of a 2 x 64 tile read, loaded by one
// TMA box from (w0 - pad_w, h0 - pad_h). Tap (r, q) of output row h0 + i
// reads the 64 rows from (i + r d) (TW + 2 pad_w) + q d of the halo tile: a
// descriptor that starts at any row. wgmma swizzles by the address (a k32
// slice already starts 32 bytes into a row), and TMA wrote the tile from a
// 1024-byte boundary, so the pattern of a row is that of its address
// wherever the window starts. The two consumer warpgroups take whole tiles
// in turn (ping-pong): each runs both 64-row halves of its tile, so one's
// epilogue overlaps the other's products. A bf16 tile goes out through
// this warpgroup's staging panels (128-byte swizzle, conflict-free
// writes) and TMA stores, which clip at the image's and Cout's end.
template <int BN, int BK>
__global__ void __launch_bounds__(kThreads, 1)
qconv_halo_kernel(const __grid_constant__ CUtensorMap x_map,
                  const __grid_constant__ CUtensorMap w_map,
                  const __grid_constant__ CUtensorMap out_map, const Params p) {
  constexpr uint32_t kB = BN * BK;
  constexpr int kTaps = 9;  // 3 x 3
  constexpr uint32_t kPanel = kTileM * 128;  // 128 rows x 64 bf16 columns, 128-byte swizzle
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* b_res = smem;                              // taps x (BN x BK)
  unsigned char* ring = b_res + kTaps * kB;                 // stages x halo tile
  unsigned char* staging = ring + p.stages * p.halo_stride;  // a bf16 tile a warpgroup
  float* sc = reinterpret_cast<float*>(staging + kConsumers * (BN / 64) * kPanel);
  float* bi = sc + BN;
  uint64_t* full = reinterpret_cast<uint64_t*>(bi + BN);
  uint64_t* empty = full + p.stages;
  uint64_t* b_full = empty + p.stages;
  const uint32_t row_pitch = p.tw + 2 * p.pad_w;            // halo rows of one image row

  if (threadIdx.x == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 1);  // the one warpgroup that took the tile
    }
    mbar_init(b_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(x_map);
      tma_prefetch_map(w_map);
      mbar_arrive_expect_tx(b_full, kTaps * kB);
      for (int tap = 0; tap < kTaps; ++tap)
        tma_load_3d(b_res + tap * kB, w_map, 0, tap, 0, b_full);
      uint32_t it = 0;
      for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x, ++it) {
        const Tile t = tile_at<BN>(p, tile);
        const uint32_t st = it % p.stages;
        mbar_wait(empty + st, ((it / p.stages) & 1) ^ 1);
        mbar_arrive_expect_tx(full + st, p.halo_bytes);
        tma_load_4d(ring + st * p.halo_stride, x_map, 0, t.w0 - p.pad_w, t.h0 - p.pad_h, t.img,
                    full + st);
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0) - 1;
    const int lt = threadIdx.x % 128, warp = lt / 32, lane = lt % 32;
    // one N tile (Cout <= BN): the scales and biases of every tile
    if (p.out_kind != kOutAcc)
      for (int c = threadIdx.x - 128; c < BN; c += 256) {
        sc[c] = c < p.cout ? __fmul_rn(p.ws[c], p.s) : 0.f;
        bi[c] = c < p.cout ? p.bias[c] : 0.f;
      }
    named_barrier_sync(kScalesBar, 256);
    mbar_wait(b_full, 0);
    const uint32_t b0 = smem_u32(b_res);
    // this warpgroup's tiles: the block's tiles wg, wg + 2, ...
    uint32_t it = wg;
    for (int tile = blockIdx.x + wg * gridDim.x; tile < p.n_tiles;
         tile += 2 * gridDim.x, it += 2) {
      int acc[2][BN / 2];  // output rows h0, h0 + 1
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[0][i] = acc[1][i] = 0;
      const uint32_t st = it % p.stages;
      mbar_wait(full + st, (it / p.stages) & 1);
      const uint32_t a0 = smem_u32(ring + st * p.halo_stride);
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < kTaps; ++tap) {
        const uint64_t db = make_desc(b0 + tap * kB, 16, 8 * BK, BK);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint32_t row = ((i + (tap / 3) * p.dil) * row_pitch + (tap % 3) * p.dil);
          const uint64_t da = make_desc(a0 + row * BK, 16, 8 * BK, BK);
#pragma unroll
          for (int kk = 0; kk < BK / 32; ++kk)
            wgmma_ss_s8<BN>(acc[i], da + ((kk * 32) >> 4), db + ((kk * 32) >> 4), 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      if (lt == 0) mbar_arrive(empty + st);
      const Tile t = tile_at<BN>(p, tile);
      if (p.tma_store) {
        // the bf16 tile into this warpgroup's staging panels (128-byte
        // swizzle), then TMA stores clipped at the image and Cout; the
        // previous tile's stores have read the panels first
        unsigned char* stg = staging + wg * (BN / 64) * kPanel;
        if (lt == 0) tma_store_wait_read<0>();
        named_barrier_sync(kStoreBar + wg, 128);
        const uint32_t base = smem_u32(stg), ln = opaque(lane);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t row = i * 64 + warp * 16 + ln / 4 + 8 * h;
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
              const int cl = 8 * j + 2 * (ln % 4);
              const float y0 = epilogue(acc[i][4 * j + 2 * h], sc[cl], bi[cl], p.relu);
              const float y1 = epilogue(acc[i][4 * j + 2 * h + 1], sc[cl + 1], bi[cl + 1], p.relu);
              st_shared_u32(base + (cl / 64) * kPanel + swizzle(row * 128 + (cl % 64) * 2, 128),
                            pack_bf16(y0, y1));
            }
          }
        fence_proxy_async();
        named_barrier_sync(kStoreBar + wg, 128);
        if (lt == 0) {
          for (int pn = 0; pn < BN / 64; ++pn)
            tma_store_4d(out_map, stg + pn * kPanel, pn * 64, t.w0, t.h0, t.img);
          tma_store_commit();
        }
      } else {
        store_tile<BN>(p, t, acc[0], sc, bi, 0, warp, lane);
        store_tile<BN>(p, t, acc[1], sc, bi, 1, warp, lane);
      }
    }
    if (lt == 0) tma_store_wait<0>();
  }
}

int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0) cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  return counts[dev];
}

template <int BN, int BK>
cudaError_t launch(const CUtensorMap& x_map, const CUtensorMap& w_map, const Params& p,
                   int sms, cudaStream_t stream) {
  using C = Cfg<BN, BK>;
  cudaError_t err = cudaFuncSetAttribute(qconv_wgmma_kernel<BN, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(C::bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(unsigned(p.n_tiles < sms ? p.n_tiles : sms));  // persistent: a block per SM
  qconv_wgmma_kernel<BN, BK><<<grid, kThreads, C::bytes, stream>>>(x_map, w_map, p);
  return cudaGetLastError();
}

template <int BN, int BK>
cudaError_t launch_halo(const CUtensorMap& x_map, const CUtensorMap& w_map,
                        const CUtensorMap& out_map, const Params& p, uint32_t smem, int sms,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(qconv_halo_kernel<BN, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(unsigned(p.n_tiles < sms ? p.n_tiles : sms));
  qconv_halo_kernel<BN, BK><<<grid, kThreads, smem, stream>>>(x_map, w_map, out_map, p);
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_bk(bool halo, int bk, const CUtensorMap& x_map, const CUtensorMap& w_map,
                      const CUtensorMap& out_map, const Params& p, uint32_t smem, int sms,
                      cudaStream_t stream) {
  if (halo) {  // BN 64, 128 x kBK 32, 64 (halo_smem)
    if constexpr (BN <= 128) {
      if (bk == 64) return launch_halo<BN, 64>(x_map, w_map, out_map, p, smem, sms, stream);
      if (bk == 32) return launch_halo<BN, 32>(x_map, w_map, out_map, p, smem, sms, stream);
    }
    return cudaErrorInvalidValue;
  }
  if (bk == 128) return launch<BN, 128>(x_map, w_map, p, sms, stream);
  if (bk == 64) return launch<BN, 64>(x_map, w_map, p, sms, stream);
  return launch<BN, 32>(x_map, w_map, p, sms, stream);
}

// The halo schedule's shared memory for these weights and tiles, or 0 where
// it does not apply (3x3 windows at stride 1, TW = 64, one K chunk of at most
// 64 bytes, Cout <= BN <= 128): the weights of every tap, kHaloMinStages halo tiles,
// the scales and the barriers must fit. A 128-byte chunk never fits: its
// weights and four halo tiles take more than the 227 KB a block may have.
// Four tiles in flight, two a consumer warpgroup: with two, a tile's load
// waited for the products of the one before it in its warpgroup, and the
// schedule ran no faster than per tap
constexpr int kHaloMinStages = 4;

uint32_t halo_smem(const Params& p, int bn, int bk, int cout, int* stages) {
  if (p.taps != 9 || p.kw != 3 || p.stride != 1 || p.tw != 64 || p.th != 2 || p.chunks != 1 ||
      bk > 64 || cout > bn || bn > 128 || p.tw + 2 * p.pad_w > 256 || p.th + 2 * p.pad_h > 256)
    return 0;
  const uint32_t fixed = uint32_t(p.taps) * bn * bk + kConsumers * (bn / 64) * kTileM * 128 +
                         8 * bn + 1024 + 16 * (2 * kMaxStages + 1);
  if (fixed + kHaloMinStages * uint32_t(p.halo_stride) > uint32_t(kSmemMax)) return 0;
  *stages = int((uint32_t(kSmemMax) - fixed) / uint32_t(p.halo_stride));
  if (*stages > kMaxStages) *stages = kMaxStages;
  return fixed + uint32_t(*stages) * p.halo_stride;
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// BN for Cout: the narrowest of 64 and 128 that covers Cout, else 256
// unless its last wave of tiles idles more SMs than 128's does (a 128 x 256
// tile taken as worth 1.8 128 x 128 tiles of time)
int choose_bn(int cout, long long tiles_m, int sms) {
  if (cout <= 64) return 64;
  if (cout <= 128) return 128;
  const long long waves256 = ceil_div(tiles_m * ceil_div(cout, 256), sms);
  const long long waves128 = ceil_div(tiles_m * ceil_div(cout, 128), sms);
  return 18 * waves256 <= 10 * waves128 ? 256 : 128;
}

// SAME's low padding on a side of n: the total split total / 2 low
int same_pad_low(int n, int k, int dil, int stride) {
  const long long total = (ceil_div(n, stride) - 1) * stride + (k - 1LL) * dil + 1 - n;
  return total > 0 ? int(total / 2) : 0;
}

// The schedule and tiling of a call, from its shapes: Cin picks kBK, the
// output's width the tile width TW (the power of two from it up to 64,
// kept to TMA's 256-element box at the stride), Cout and the tile count
// BN, and a 3x3 window at stride 1 with one K chunk and Cout <= 128 the halo
// schedule where its ring fits -> p, bk, bn, whether the halo schedule runs
// and its dynamic shared memory. Returns a cudaError_t.
int make_plan(int n, int h, int width, int cin, int cout, int kh, int kw, int dil, int stride,
              int sms, Params* p_out, int* bk_out, int* bn_out, bool* halo_out,
              uint32_t* smem_out) {
  const bool odd = kh % 2 == 1 && kw % 2 == 1;
  const bool patch = kh == stride && kw == stride;  // an even window at its own stride
  if (n <= 0 || h <= 0 || width <= 0 || cin <= 0 || cin % 16 != 0 || cout <= 0 || kh <= 0 ||
      kw <= 0 || !(odd || patch) || dil <= 0 || stride < 1 || stride > 8)
    return int(cudaErrorInvalidValue);
  const int bk = cin % 128 == 0 ? 128 : cin % 64 == 0 ? 64 : 32;
  const int ho = int(ceil_div(h, stride)), wo = int(ceil_div(width, stride));
  int tw = 1;
  while (tw < wo && tw < 64 && 2 * tw * stride <= 256) tw *= 2;
  while ((kTileM / tw) * stride > 256) tw *= 2;  // TH u <= 256
  Params p{};
  p.h = ho;
  p.w = wo;
  p.cout = cout;
  p.kw = kw;
  p.taps = kh * kw;
  p.dil = dil;
  p.stride = stride;
  p.pad_h = same_pad_low(h, kh, dil, stride);
  p.pad_w = same_pad_low(width, kw, dil, stride);
  p.chunks = (cin + bk - 1) / bk;
  p.tw = tw;
  p.th = kTileM / tw;
  p.tiles_w = (wo + p.tw - 1) / p.tw;
  p.tiles_h = (ho + p.th - 1) / p.th;
  const long long tiles_m = static_cast<long long>(n) * p.tiles_h * p.tiles_w;
  const int bn = choose_bn(cout, tiles_m, sms);
  const long long n_tiles = tiles_m * ceil_div(cout, bn);
  if (n_tiles > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  p.tiles_m = static_cast<int>(tiles_m);
  p.n_tiles = static_cast<int>(n_tiles);
  p.halo_bytes = bk * (p.tw + 2 * p.pad_w) * (p.th + 2 * p.pad_h);
  p.halo_stride = (p.halo_bytes + 1023) / 1024 * 1024;
  const uint32_t smem = halo_smem(p, bn, bk, cout, &p.stages);
  *p_out = p;
  *bk_out = bk;
  *bn_out = bn;
  *halo_out = smem != 0;
  *smem_out = smem;
  return 0;
}

}  // namespace

// out_kind: 0 f32, 1 bf16 (both through the epilogue), 2 the int32 accumulator
// alone (ws, bias and s unused). The schedule and tiling follow from the
// shapes (make_plan). Returns a cudaError_t (0: launched;
// cudaErrorInvalidValue for arguments it does not take).
extern "C" int qconv_int8_fwd(const void* x, const void* w, const void* ws, const void* bias,
                              float s, void* out, int n, int h, int width, int cin, int cout,
                              int kh, int kw, int dil, int stride, int relu, int out_kind,
                              void* stream) {
  if (out_kind < 0 || out_kind > 2 || (reinterpret_cast<uintptr_t>(x) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(w) & 15) != 0)
    return int(cudaErrorInvalidValue);
  if (encode_tiled() == nullptr) return int(cudaErrorNotSupported);
  const int sms = sm_count();
  if (sms <= 0) return int(cudaErrorNoDevice);
  Params p;
  int bk = 0, bn = 0;
  bool halo = false;
  uint32_t smem = 0;
  const int err = make_plan(n, h, width, cin, cout, kh, kw, dil, stride, sms, &p, &bk, &bn,
                            &halo, &smem);
  if (err) return err;
  p.ws = static_cast<const float*>(ws);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.s = s;
  p.relu = relu;
  p.out_kind = out_kind;

  // xq as (Cin, W, H, N) bytes, w8 as (Cin, kh kw, Cout); the halo
  // schedule's A box is the halo tile, the per-tap one's a tile's pixels
  // at the stride
  CUtensorMap x_map, w_map;
  const uint64_t x_dims[4] = {uint64_t(cin), uint64_t(width), uint64_t(h), uint64_t(n)};
  const uint64_t x_strides[3] = {uint64_t(cin), uint64_t(cin) * width,
                                 uint64_t(cin) * width * h};
  const uint32_t x_box[4] = {uint32_t(bk),
                             uint32_t(halo ? p.tw + 2 * p.pad_w : p.tw * stride),
                             uint32_t(halo ? p.th + 2 * p.pad_h : p.th * stride), 1};
  const uint32_t x_elem[4] = {1, uint32_t(stride), uint32_t(stride), 1};
  const uint64_t w_dims[3] = {uint64_t(cin), uint64_t(p.taps), uint64_t(cout)};
  const uint64_t w_strides[2] = {uint64_t(cin), uint64_t(cin) * p.taps};
  const uint32_t w_box[3] = {uint32_t(bk), 1, uint32_t(bn)};
  if (!make_map_nd(&x_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, x, 4, x_dims, x_strides, x_box, bk,
                   x_elem) ||
      !make_map_nd(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, 3, w_dims, w_strides, w_box, bk))
    return int(cudaErrorInvalidValue);
  // the halo schedule's bf16 output as (Cout, W, H, N), 64-column boxes of
  // a tile (TMA's 16-byte strides: Cout % 8 == 0; else direct stores)
  CUtensorMap out_map = x_map;
  p.tma_store = halo && out_kind == kOutBF16 && cout % 8 == 0 &&
                (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  if (p.tma_store) {
    const uint64_t o_dims[4] = {uint64_t(cout), uint64_t(p.w), uint64_t(p.h), uint64_t(n)};
    const uint64_t o_strides[3] = {2 * uint64_t(cout), 2 * uint64_t(cout) * p.w,
                                   2 * uint64_t(cout) * p.w * p.h};
    const uint32_t o_box[4] = {64, uint32_t(p.tw), uint32_t(p.th), 1};
    if (!make_map_nd(&out_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, out, 4, o_dims, o_strides,
                     o_box, 128))
      return int(cudaErrorInvalidValue);
  }

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bn == 64) return int(launch_bk<64>(halo, bk, x_map, w_map, out_map, p, smem, sms, st));
  if (bn == 128) return int(launch_bk<128>(halo, bk, x_map, w_map, out_map, p, smem, sms, st));
  return int(launch_bk<256>(halo, bk, x_map, w_map, out_map, p, smem, sms, st));
}

// The schedule a call with these arguments takes, without launching:
// out[0..5] = halo (1) or per tap (0), BN, kBK, TW, TH, stages (the halo
// ring's; 0 for the per-tap schedule, whose ring is fixed by BN and kBK).
extern "C" int qconv_int8_plan(int n, int h, int width, int cin, int cout, int kh, int kw,
                               int dil, int stride, int* out) {
  const int sms = sm_count();
  if (sms <= 0) return int(cudaErrorNoDevice);
  Params p;
  int bk = 0, bn = 0;
  bool halo = false;
  uint32_t smem = 0;
  const int err = make_plan(n, h, width, cin, cout, kh, kw, dil, stride, sms, &p, &bk, &bn,
                            &halo, &smem);
  if (err) return err;
  out[0] = halo;
  out[1] = bn;
  out[2] = bk;
  out[3] = p.tw;
  out[4] = p.th;
  out[5] = halo ? p.stages : 0;
  return 0;
}

extern "C" const char* qconv_int8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
