// Fixed-sigma Gaussian density map for Hopper (sm_90a):
//
//     out[h, w] = sum_i valid_i * k(h - y_i) * k(w - x_i)
//
// points: (n, 2) float32 (x, y) = (column, row); mask: (n,) bool (one byte);
// out: (height, width) float32. k is the scipy-normalised 1-D Gaussian,
// truncated at |d| <= r, passed in as its 2r+1 taps (the host computes
// them in float64, as the numpy golden does, and casts them to float32).
// Coordinates truncate toward zero, like int() (so -0.4 lands on row or
// column 0); a point whose truncated coordinates fall outside the image,
// or whose mask is false, contributes nothing.
//
// Replaces the Pallas TPU kernel dgvcc_tpu/ops/dmap.py (_dmap_kernel /
// gaussian_density_pallas), which forms density = A . B^T per 256x256
// tile on the matrix unit, with A[h, i] = k(h - y_i) and B[w, i] =
// k(w - x_i) rebuilt in VMEM from exps. On a TPU the dense product is the
// fast way; its operands are more than 99% zeros (a point touches a
// (2r+1)^2 = 225-pixel window of a 768x1024 map).
//
// Bound on the H100: the map must be written once (4 bytes a pixel, 3.1 MB
// at 768x1024 = 0.9 us of HBM) and the points read; the TPU's dense form
// is 2*H*W*N f32 flops (1.6 GFLOP at N=1024, 24 us on the CUDA cores).
// This design does the sparse work instead, about 225*N multiply-adds, so
// neither the product nor the flops bound it: the cost is that every
// block reads the whole point list (from L2) and a launch.
//
// Design: one block of 256 threads per 32x32 output tile; a thread owns
// one column and four rows (warp w: rows w, w+8, w+16, w+24). The block
// walks the points in chunks of 256, one point a thread: it truncates the
// coordinates, drops invalid points, and keeps those whose (2r+1)^2 window
// meets the tile, compacted by warp ballot and prefix count into a shared
// list that stays in point order. Each thread then sums taps[dy] *
// taps[dx] over the list in that order, in float32. No atomics: every
// output pixel is written once, by one thread, and the result does not
// depend on scheduling.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;              // output tile is kTile x kTile
constexpr int kThreads = 256;          // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = kTile / kWarps;   // 4
constexpr int kChunk = kThreads;       // points staged per pass
constexpr int kMaxTaps = 127;          // radius <= 63

struct Taps {
  float v[kMaxTaps];
};

__global__ void __launch_bounds__(kThreads)
gaussian_density_kernel(const float2* __restrict__ points,
                        const unsigned char* __restrict__ mask,
                        float* __restrict__ out, int n, int height, int width,
                        Taps taps, int radius) {
  __shared__ float s_taps[kMaxTaps];
  __shared__ int2 s_list[kChunk];
  __shared__ int s_count[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int x0 = blockIdx.x * kTile;
  const int y0 = blockIdx.y * kTile;
  const int col = x0 + lane;
  const int r = radius;

  if (tid < 2 * r + 1) s_taps[tid] = taps.v[tid];

  float acc[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) acc[k] = 0.f;

  for (int base = 0; base < n; base += kChunk) {
    const int i = base + tid;
    bool hit = false;
    int px = 0, py = 0;
    if (i < n) {
      const float2 p = points[i];
      const float tx = truncf(p.x), ty = truncf(p.y);
      // compared as floats: no overflow of an int cast for far points
      const bool valid = mask[i] != 0 && tx >= 0.f && tx < float(width) &&
                         ty >= 0.f && ty < float(height);
      if (valid) {
        px = int(tx);
        py = int(ty);
        hit = py + r >= y0 && py - r < y0 + kTile && px + r >= x0 &&
              px - r < x0 + kTile;
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) s_count[warp] = __popc(ballot);
    __syncthreads();  // also publishes s_taps on the first pass
    int offset = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_count[w];
      offset += w < warp ? c : 0;
      total += c;
    }
    if (hit) s_list[offset + __popc(ballot & ((1u << lane) - 1u))] = make_int2(px, py);
    __syncthreads();

    for (int j = 0; j < total; ++j) {
      const int2 q = s_list[j];
      const int dx = col - q.x;
      if (dx < -r || dx > r) continue;
      const float kx = s_taps[dx + r];
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k) {
        const int dy = y0 + warp + k * kWarps - q.y;
        if (dy >= -r && dy <= r) acc[k] += s_taps[dy + r] * kx;
      }
    }
    __syncthreads();  // s_list and s_count are rewritten by the next chunk
  }

  if (col < width) {
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int row = y0 + warp + k * kWarps;
      if (row < height) out[size_t(row) * width + col] = acc[k];
    }
  }
}

}  // namespace

// points: device (n, 2) float32, 8-byte aligned; mask: device (n,) bytes;
// out: device (height, width) float32; taps: HOST array of 2*radius+1
// floats. Launches on `stream`; returns a cudaError_t (0 on success).
extern "C" int gaussian_density_fwd(const void* points, const void* mask,
                                    void* out, int n, int height, int width,
                                    const float* taps, int radius,
                                    void* stream) {
  if (n < 0 || height <= 0 || width <= 0 || radius < 0 ||
      2 * radius + 1 > kMaxTaps || (height + kTile - 1) / kTile > 65535)
    return int(cudaErrorInvalidValue);
  Taps t = {};
  for (int i = 0; i < 2 * radius + 1; ++i) t.v[i] = taps[i];
  const dim3 grid((width + kTile - 1) / kTile, (height + kTile - 1) / kTile);
  gaussian_density_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(points), static_cast<const unsigned char*>(mask),
      static_cast<float*>(out), n, height, width, t, radius);
  return int(cudaGetLastError());
}

extern "C" const char* gaussian_density_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
