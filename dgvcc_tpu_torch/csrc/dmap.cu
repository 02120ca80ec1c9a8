// Fixed-sigma Gaussian density map for Hopper (sm_90a):
//
//     out[h, w] = sum_i valid_i * k(h - y_i) * k(w - x_i)
//
// points: (n, 2) float32 (x, y) = (column, row); mask: (n,) bool (one byte);
// out: (height, width) float32. k is the scipy-normalised 1-D Gaussian,
// truncated at |d| <= r, given as its 2r+1 float32 taps in device memory
// (the host computes them in float64, as the numpy golden does, casts them
// and keeps them per sigma and device). Coordinates truncate toward zero,
// like int() (so -0.4 lands on row or column 0); a point whose truncated
// coordinates fall outside the image, or whose mask is false, contributes
// nothing.
//
// Replaces the Pallas TPU kernel dgvcc_tpu/ops/dmap.py (_dmap_kernel /
// gaussian_density_pallas), which forms density = A . B^T per 256x256
// tile on the matrix unit, with A[h, i] = k(h - y_i) and B[w, i] =
// k(w - x_i) rebuilt in VMEM from exps. On a TPU the dense product is the
// fast way; its operands are more than 99% zeros (a point touches a
// (2r+1)^2 = 225-pixel window), and on the H100 the sparse form has no
// product left for the tensor cores (0.46 MFLOP at 768x1024 with 1,024
// points), so no wgmma and no TMA: the inputs are a few hundred KB.
//
// Bound on the H100: writing the map once (4 bytes a pixel: 3.1 MB at
// 768x1024, 0.9 us of HBM; 25.2 MB at 2048x3072, 7.5 us). The work has to
// grow with N + H*W, not with tiles x N (the first port gave every 32x32
// tile a walk over all N points). So the points are binned by tile first:
//
//   1. bin_count: one thread a point truncates and validates it, takes the
//      32x32 output tile of its centre and counts it there with an integer
//      atomic; the last block to finish (a block counter) takes the
//      exclusive scan of the counts, the segments' starts. With more than
//      kBinThreads points a cudaMemsetAsync zeroes the counts and the
//      counter first; one block zeroes them itself and needs no counter;
//   2. bin_scatter: one thread a point writes (index, packed x y) into its
//      tile's segment at a slot from an integer atomic on the start, which
//      leaves each start at its segment's end; the order inside a segment
//      changes from run to run;
//   3. splat: one block of 128 threads an output tile. Its candidates are
//      the segments of the tiles within ceil(r/32) tiles (9 at r = 7, 25 at
//      r <= 63), read by a group of threads each. It keeps those whose
//      window meets the tile in shared memory, orders them by point index
//      (a rank sort: indices are distinct), and each thread sums its eight
//      pixels (one row, two runs of four columns) over the list in that
//      order in float32 FMAs, taps from a zero-padded table so a pixel
//      outside the window adds exactly 0 and the loop needs no branch.
//      Every pixel is written once, in float4s that fill whole 32-byte
//      sectors where the width allows. A tile without candidates writes
//      zeros. A tile with more candidates than kCapacity goes through them
//      in rounds of kCapacity point indices, in index order.
//
// No float atomics: each pixel's sum runs in point order whatever the
// scheduling, the order of the first port, so the map is bit for bit the
// same from call to call (and equal to the first port's). Measured
// (scripts/sweep_dmap.py): the splat writes the map at about the bound
// where few windows meet a tile; where many do, their sum loop costs more
// than the writes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;                    // output tile is kTile x kTile
constexpr int kThreads = 128;                // splat block: 4 warps
constexpr int kCols = kTile * kTile / kThreads;  // pixels a splat thread owns, in one row:
constexpr int kQuads = kCols / 4;                // float4s, kQuadStride apart
constexpr int kQuadStride = kTile / kQuads;
constexpr int kMaxRadius = 63;               // ops/dmap.py: MAX_RADIUS
constexpr int kMaxReach = (kMaxRadius + kTile - 1) / kTile;       // 2 tiles
constexpr int kMaxSegments = (2 * kMaxReach + 1) * (2 * kMaxReach + 1);
constexpr int kMaxTable = 2 * (kTile - 1 + kMaxRadius) + 1;       // padded taps
constexpr int kSplatBlocksPerSM = 16;        // <= 32 registers: faster than 12 at 2048x3072
constexpr int kCapacity = 768;               // candidates a splat block holds
constexpr int kGather = 2;                   // candidates a splat thread loads at once
constexpr int kBinThreads = 1024;            // bin_count block (and its scan)
constexpr int kScanItems = 8;                // counts a scan thread takes a round
constexpr int kScatterThreads = 256;
constexpr int kMaxSide = 65535;              // x and y packed in 16 bits each

static_assert(kTile * kTile == kThreads * kCols && kCols % 4 == 0 &&
                  kQuadStride == 4 * (kTile / kCols),
              "a splat thread owns kCols pixels of one row, in float4s");
static_assert(kMaxSegments <= 32 && kScanItems % 4 == 0, "warp 0 reads the segments");

// Point i's output tile, or -1 when it is masked off or outside the image;
// its truncated coordinates in px, py.
__device__ __forceinline__ int point_tile(const float2* __restrict__ points,
                                          const unsigned char* __restrict__ mask, int i,
                                          int height, int width, int tiles_x, int& px,
                                          int& py) {
  const float2 p = points[i];
  const float tx = truncf(p.x), ty = truncf(p.y);
  // compared as floats: no overflow of an int cast for far points
  if (mask[i] == 0 || !(tx >= 0.f && tx < float(width) && ty >= 0.f && ty < float(height)))
    return -1;
  px = int(tx);
  py = int(ty);
  return (py / kTile) * tiles_x + px / kTile;
}

__global__ void __launch_bounds__(kBinThreads)
bin_count_kernel(const float2* __restrict__ points, const unsigned char* __restrict__ mask,
                 int n, int height, int width, int tiles_x, int n_tiles, int n_tiles_pad,
                 int* __restrict__ counts, int* __restrict__ starts,
                 unsigned* __restrict__ blocks_done) {
  __shared__ int s_warp[kBinThreads / 32];
  __shared__ int s_carry;
  __shared__ bool s_last;
  const int tid = threadIdx.x;
  const int i = blockIdx.x * kBinThreads + tid;
  // one block (n <= kBinThreads) zeroes the counts itself and needs no
  // block counter; more are launched after a memset of the counts
  const bool alone = gridDim.x == 1;
  if (tid == 0) s_carry = 0;
  if (alone) {
    for (int q = 4 * tid; q < n_tiles_pad; q += 4 * kBinThreads)
      *reinterpret_cast<int4*>(counts + q) = make_int4(0, 0, 0, 0);
    __syncthreads();
  }
  if (i < n) {
    int px, py;
    const int t = point_tile(points, mask, i, height, width, tiles_x, px, py);
    if (t >= 0) atomicAdd(counts + t, 1);
  }
  if (alone) {
    __syncthreads();
  } else {
    __threadfence();
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(blocks_done, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
  }

  // the last block: exclusive scan of the counts (read from L2, where the
  // other blocks' atomics landed), kBinThreads * kScanItems a round, each
  // thread kScanItems neighbours in int4s (the arrays are padded to
  // n_tiles_pad, a multiple of 4; what lies past n_tiles is read as 0)
  const int lane = tid & 31, warp = tid >> 5;
  for (int base = 0; base < n_tiles; base += kBinThreads * kScanItems) {
    const int first = base + tid * kScanItems;
    int v[kScanItems];
#pragma unroll
    for (int q = 0; q < kScanItems; q += 4) {
      const int4 c = first + q < n_tiles_pad
                         ? __ldcg(reinterpret_cast<const int4*>(counts + first + q))
                         : make_int4(0, 0, 0, 0);
      v[q] = c.x;
      v[q + 1] = c.y;
      v[q + 2] = c.z;
      v[q + 3] = c.w;
    }
    int sum = 0;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      if (first + k >= n_tiles) v[k] = 0;
      sum += v[k];
    }
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int w = s_warp[lane];
      int wincl = w;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, wincl, o);
        if (lane >= o) wincl += u;
      }
      s_warp[lane] = wincl - w;
    }
    __syncthreads();
    int run = s_carry + s_warp[warp] + incl - sum;
#pragma unroll
    for (int q = 0; q < kScanItems; q += 4) {
      const int4 s = make_int4(run, run + v[q], run + v[q] + v[q + 1],
                               run + v[q] + v[q + 1] + v[q + 2]);
      if (first + q < n_tiles_pad) *reinterpret_cast<int4*>(starts + first + q) = s;
      run = s.w + v[q + 3];
    }
    __syncthreads();  // every thread has read s_carry and s_warp
    if (tid == kBinThreads - 1) s_carry = run;
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kScatterThreads)
bin_scatter_kernel(const float2* __restrict__ points, const unsigned char* __restrict__ mask,
                   int n, int height, int width, int tiles_x, int* __restrict__ cursors,
                   int2* __restrict__ list) {
  const int i = blockIdx.x * kScatterThreads + threadIdx.x;
  if (i >= n) return;
  int px, py;
  const int t = point_tile(points, mask, i, height, width, tiles_x, px, py);
  if (t < 0) return;
  const int slot = atomicAdd(cursors + t, 1);
  list[slot] = make_int2(i, int(unsigned(px) | (unsigned(py) << 16)));
}

__global__ void __launch_bounds__(kThreads, kSplatBlocksPerSM)
splat_kernel(const int* __restrict__ counts, const int* __restrict__ ends,
             const int2* __restrict__ list, const float* __restrict__ taps,
             float* __restrict__ out, int n, int height, int width, int tiles_x,
             int tiles_y, int radius) {
  __shared__ float s_table[kMaxTable];
  __shared__ int s_begin[kMaxSegments], s_len[kMaxSegments];
  __shared__ int s_index[kCapacity];
  __shared__ unsigned s_kept[kCapacity], s_sorted[kCapacity];
  __shared__ int s_count, s_total;

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kTile, y0 = blockIdx.y * kTile;
  const int r = radius;
  const int reach = (r + kTile - 1) / kTile;
  const int span = 2 * reach + 1;
  const int n_segments = span * span;
  // s_table[d + pad] = k(d) for |d| <= r, 0 for r < |d| <= pad: every
  // (pixel, kept point) offset of the tile falls inside
  const int pad = kTile - 1 + r;

  for (int j = tid; j <= 2 * pad; j += kThreads) {
    const int d = j - pad;
    s_table[j] = d >= -r && d <= r ? taps[d + r] : 0.f;
  }
  if (tid < 32) {  // warp 0: the segments around the tile and their total
    int begin = 0, len = 0;
    if (tid < n_segments) {
      const int sx = blockIdx.x + tid % span - reach, sy = blockIdx.y + tid / span - reach;
      if (sx >= 0 && sx < tiles_x && sy >= 0 && sy < tiles_y) {
        const int t = sy * tiles_x + sx;
        len = counts[t];
        begin = ends[t] - len;
      }
    }
    const int sum = __reduce_add_sync(0xffffffffu, len);
    if (tid < n_segments) {
      s_begin[tid] = begin;
      s_len[tid] = len;
    }
    if (tid == 0) {
      s_total = sum;
      s_count = 0;
    }
  }
  __syncthreads();
  const int total = s_total;

  // the thread's pixels: row `row`, columns col + q * kQuadStride + 0..3,
  // so each float4 store of a warp writes whole 32-byte sectors
  const int row = tid / (kTile / kCols);
  const int col = (tid % (kTile / kCols)) * 4;
  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;

  // one round over every index when the candidates fit, else rounds of
  // kCapacity indices (at most kCapacity distinct points each)
  const int per_round = total <= kCapacity ? n : kCapacity;
  for (int lo = 0; total > 0 && lo < n; lo += per_round) {
    const int hi = n - lo <= per_round ? n : lo + per_round;
    if (lo > 0) {  // every thread has read s_count and the last round's lists
      __syncthreads();
      if (tid == 0) s_count = 0;
      __syncthreads();
    }
    // a group of `group` neighbouring threads reads each segment, kGather
    // candidates a thread in flight at once
    const int group = kThreads / n_segments;
    const int seg = tid / group;
    const int begin = seg < n_segments ? s_begin[seg] : 0;
    const int len = seg < n_segments ? s_len[seg] : 0;
    for (int base = tid % group; base < len; base += group * kGather) {
      int2 e[kGather];
#pragma unroll
      for (int k = 0; k < kGather; ++k) {
        const int j = base + k * group;
        e[k] = j < len ? list[begin + j] : make_int2(-1, 0);
      }
#pragma unroll
      for (int k = 0; k < kGather; ++k) {
        if (e[k].x < lo || e[k].x >= hi) continue;
        const int px = int(unsigned(e[k].y) & 0xffffu), py = int(unsigned(e[k].y) >> 16);
        if (px + r < x0 || px - r >= x0 + kTile || py + r < y0 || py - r >= y0 + kTile)
          continue;
        const int slot = atomicAdd(&s_count, 1);
        s_index[slot] = e[k].x;
        s_kept[slot] = unsigned(x0 - px + pad) | (unsigned(y0 - py + pad) << 16);
      }
    }
    __syncthreads();
    const int kept = s_count;
    if (kept == 0) continue;
    if (kept > 1) {
      for (int a = tid; a < kept; a += kThreads) {  // order by point index
        const int key = s_index[a];
        int rank = 0;
#pragma unroll 8
        for (int b = 0; b < kept; ++b) rank += s_index[b] < key;
        s_sorted[rank] = s_kept[a];
      }
      __syncthreads();
    }
    // in point order; a tap of 0 (outside the window) adds exactly nothing,
    // so no branch: the loop unrolls and its loads overlap
    const unsigned* ordered = kept > 1 ? s_sorted : s_kept;
#pragma unroll 4
    for (int j = 0; j < kept; ++j) {
      const unsigned e = ordered[j];
      const float ky = s_table[row + int(e >> 16)];
      const float* kx = s_table + col + int(e & 0xffffu);
#pragma unroll
      for (int q = 0; q < kQuads; ++q)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[4 * q + c] = fmaf(ky, kx[q * kQuadStride + c], acc[4 * q + c]);
    }
  }

  const int y = y0 + row;
  if (y >= height) return;
  float* dst = out + size_t(y) * width;
  const bool vec = (width & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
#pragma unroll
  for (int q = 0; q < kQuads; ++q) {
    const int x = x0 + col + q * kQuadStride;
    if (vec && x < width) {
      *reinterpret_cast<float4*>(dst + x) =
          make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
    } else if (!vec) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (x + c < width) dst[x + c] = acc[4 * q + c];
    }
  }
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// The tiles' counts and the block counter, padded to a multiple of 4.
long long tiles_pad(int height, int width) {
  const long long tiles = (long long)cdiv(height, kTile) * cdiv(width, kTile);
  return (tiles + 1 + 3) / 4 * 4;
}

// Ints of workspace a map of n points and height x width needs (ops/dmap.py:
// workspace_ints): the counts and counter (tiles_pad), the segments' ends
// (as many), the binned list (2n).
long long workspace_ints(int n, int height, int width) {
  return 2 * tiles_pad(height, width) + 2LL * n;
}

}  // namespace

// points: device (n, 2) float32, 8-byte aligned; mask: device (n,) bytes;
// taps: device 2*radius+1 float32; out: device (height, width) float32;
// workspace: device int32, 16-byte aligned, at least
// workspace_ints(n, height, width) of them. Launches three
// kernels on `stream` (two with n = 0), after a memset when n > 1024;
// returns a cudaError_t (0 on success), checked after each launch.
extern "C" int gaussian_density_fwd(const void* points, const void* mask, const void* taps,
                                    int radius, void* out, void* workspace,
                                    long long n_workspace, int n, int height, int width,
                                    void* stream) {
  if (n < 0 || height <= 0 || width <= 0 || height > kMaxSide || width > kMaxSide ||
      radius < 0 || radius > kMaxRadius ||
      n_workspace < workspace_ints(n, height, width) ||
      (reinterpret_cast<uintptr_t>(workspace) & 15) != 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles_x = cdiv(width, kTile), tiles_y = cdiv(height, kTile);
  const int n_tiles = tiles_x * tiles_y;
  const int n_tiles_pad = int(tiles_pad(height, width));
  int* counts = static_cast<int*>(workspace);
  unsigned* blocks_done = reinterpret_cast<unsigned*>(counts + n_tiles);
  int* ends = counts + n_tiles_pad;
  int2* list = reinterpret_cast<int2*>(ends + n_tiles_pad);
  const float2* pts = static_cast<const float2*>(points);
  const unsigned char* msk = static_cast<const unsigned char*>(mask);

  cudaError_t err;
  const int count_blocks = n > 0 ? cdiv(n, kBinThreads) : 1;
  if (count_blocks > 1 &&
      (err = cudaMemsetAsync(counts, 0, sizeof(int) * n_tiles_pad, s)) != cudaSuccess)
    return int(err);
  bin_count_kernel<<<count_blocks, kBinThreads, 0, s>>>(
      pts, msk, n, height, width, tiles_x, n_tiles, n_tiles_pad, counts, ends, blocks_done);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  if (n > 0) {
    bin_scatter_kernel<<<cdiv(n, kScatterThreads), kScatterThreads, 0, s>>>(
        pts, msk, n, height, width, tiles_x, ends, list);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  }
  splat_kernel<<<dim3(tiles_x, tiles_y), kThreads, 0, s>>>(
      counts, ends, list, static_cast<const float*>(taps), static_cast<float*>(out), n,
      height, width, tiles_x, tiles_y, radius);
  return int(cudaGetLastError());
}

extern "C" const char* gaussian_density_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
