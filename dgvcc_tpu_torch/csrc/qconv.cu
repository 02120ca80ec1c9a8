// Int8 convolution with a fused epilogue for Hopper (sm_90a):
//
//     acc[n, h, w, c] = sum_{r, q, k} xq[n, h + (r - kh/2) d, w + (q - kw/2) d, k]
//                                     * w8[c, r, q, k]        (int32, SAME zeros)
//     y = float(acc) * (ws[c] * s) + bias[c]  [, ReLU]  -> f32 or bf16, NHWC
//
// xq: (N, H, W, Cin) int8, contiguous (channels last); w8: (Cout, kh, kw, Cin)
// int8, contiguous; ws, bias: (Cout,) f32; s: the site's activation scale.
// Stride 1, odd kh and kw, dilation d >= 1, any Cin >= 1, Cout >= 1, H, W.
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
// Design (a first kernel: right, not yet fast). An implicit GEMM: M = N H W
// output pixels, N = Cout, K = kh kw ceil(Cin / 64) 64, taps outermost, each
// tap's channels zero-filled up to a multiple of kBK. A block of 4 warps
// owns a 128 x 64 output tile; each warp a 64 x 32 piece of it as 4 x 4
// mma.sync.m16n8k32 s8.s8.s32 tiles. The A (pixels x channels) and B
// (output channels x channels) slabs of one K step go through a ring of
// kStages shared-memory buffers, filled by cp.async with zero fill where the
// tap falls outside the image or the channel past Cin (16-byte copies when
// Cin % 16 == 0; a byte at a time otherwise, which only enc1/conv0's Cin = 3
// takes on the main path). Rows are padded to 80 bytes, so the 32-bit
// fragment loads of a warp meet no bank conflict. The epilogue runs from
// the accumulator registers.
//
// Bound on the H100: 2 M Cout kh kw Cin int8 operations at 1,979 TOPS
// (dense), or the bytes (xq, w8 read once, y written once) at 3.35 TB/s:
// 0.05-0.5 ms for final's 3x3 sites at 768x1024. What this design leaves
// (later work): wgmma with s8 operands, TMA, a persistent schedule, larger
// tiles for the 512-channel sites, the activation quantize fused in.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;          // output pixels a block
constexpr int kBN = 64;           // output channels a block
constexpr int kBK = 64;           // input channels (bytes) a K step
constexpr int kStages = 3;        // cp.async ring depth
constexpr int kThreads = 128;     // 4 warps: 2 (pixels) x 2 (channels)
constexpr int kRow = kBK + 16;    // shared row pitch in bytes: conflict-free fragments
constexpr int kOutF32 = 0, kOutBF16 = 1, kOutAcc = 2;

struct Params {
  const int8_t* x;
  const int8_t* w;
  const float* ws;
  const float* bias;
  void* out;
  float s;
  long long m;  // N H W
  int h, w_, cin, cout, kh, kw, dil, relu;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes of row src (channels c .. c + 15 of one pixel or one filter tap)
// into dst; bytes past Cin and rows that are not valid read as 0
template <bool kVec>
__device__ __forceinline__ void load16(int8_t* dst, const int8_t* src, bool valid, int c,
                                       int cin, const int8_t* any) {
  if (kVec) {
    const bool ok = valid && c < cin;  // Cin % 16 == 0: all 16 bytes or none
    cp_async16(dst, ok ? src : any, ok);
  } else {
    alignas(16) int8_t v[16];
#pragma unroll
    for (int b = 0; b < 16; ++b) v[b] = (valid && c + b < cin) ? src[b] : int8_t(0);
    *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(v);
  }
}

template <bool kVec, int kOut>
__global__ void __launch_bounds__(kThreads) qconv_kernel(Params p) {
  __shared__ __align__(16) int8_t sa[kStages][kBM * kRow];
  __shared__ __align__(16) int8_t sb[kStages][kBN * kRow];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp & 1, warp_n = warp >> 1;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  const int hw = p.h * p.w_;
  const int taps = p.kh * p.kw;
  const int chunks = (p.cin + kBK - 1) / kBK;
  const int k_iters = taps * chunks;
  const int pad_h = p.dil * (p.kh / 2), pad_w = p.dil * (p.kw / 2);

  // the rows this thread copies: A rows tid / 4 + 32 i, B rows tid / 4 + 32 j,
  // 16 bytes at column (tid % 4) 16 of each
  const int col = (tid & 3) * 16;
  int an[kBM / 32], ah[kBM / 32], aw[kBM / 32];
#pragma unroll
  for (int i = 0; i < kBM / 32; ++i) {
    const long long m = m0 + (tid >> 2) + 32 * i;
    an[i] = -1;
    ah[i] = aw[i] = 0;
    if (m < p.m) {
      an[i] = static_cast<int>(m / hw);
      const int r = static_cast<int>(m - static_cast<long long>(an[i]) * hw);
      ah[i] = r / p.w_;
      aw[i] = r - ah[i] * p.w_;
    }
  }

  auto load = [&](int stage, int it) {
    const int tap = it / chunks;
    const int c = (it - tap * chunks) * kBK + col;
    const int dh = (tap / p.kw) * p.dil - pad_h, dw = (tap % p.kw) * p.dil - pad_w;
#pragma unroll
    for (int i = 0; i < kBM / 32; ++i) {
      const int ih = ah[i] + dh, iw = aw[i] + dw;
      const bool valid = an[i] >= 0 && ih >= 0 && ih < p.h && iw >= 0 && iw < p.w_;
      const int8_t* src =
          p.x + ((static_cast<long long>(an[i]) * p.h + ih) * p.w_ + iw) * p.cin + c;
      load16<kVec>(&sa[stage][((tid >> 2) + 32 * i) * kRow + col], src, valid, c, p.cin, p.x);
    }
#pragma unroll
    for (int j = 0; j < kBN / 32; ++j) {
      const int co = n0 + (tid >> 2) + 32 * j;
      const int8_t* src = p.w + (static_cast<long long>(co) * taps + tap) * p.cin + c;
      load16<kVec>(&sb[stage][((tid >> 2) + 32 * j) * kRow + col], src, co < p.cout, c, p.cin,
                   p.w);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][b][e] = 0;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < k_iters) load(st, st);
    cp_async_commit();
  }

  const int g = lane >> 2, t4 = (lane & 3) * 4;
  for (int it = 0; it < k_iters; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step it has landed; every warp is done with step it - 1's buffer
    const int next = it + kStages - 1;
    if (next < k_iters) load(next % kStages, next);
    cp_async_commit();

    const int8_t* a_s = sa[it % kStages];
    const int8_t* b_s = sb[it % kStages];
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int8_t* r0 = a_s + (warp_m * 64 + mi * 16 + g) * kRow + ks + t4;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(r0);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(r0 + 8 * kRow);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(r0 + 8 * kRow + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* r0 = b_s + (warp_n * 32 + ni * 8 + g) * kRow + ks + t4;
        bf[ni][0] = *reinterpret_cast<const uint32_t*>(r0);
        bf[ni][1] = *reinterpret_cast<const uint32_t*>(r0 + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
  }
  cp_async_wait<0>();

  // epilogue: c0, c1 at (row g, columns 2 (lane % 4) + {0, 1}), c2, c3 at row g + 8
  const bool pairs = (p.cout & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int c = n0 + warp_n * 32 + ni * 8 + (lane & 3) * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long m = m0 + warp_m * 64 + mi * 16 + g + 8 * half;
        if (m >= p.m) continue;
        const int* a = &acc[mi][ni][2 * half];
        const long long base = m * p.cout + c;
        if constexpr (kOut == kOutAcc) {
          int* out = static_cast<int*>(p.out);
          if (c < p.cout) out[base] = a[0];
          if (c + 1 < p.cout) out[base + 1] = a[1];
        } else {
          float y[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ce = min(c + e, p.cout - 1);  // past Cout: computed, not stored
            const float scale = __fmul_rn(p.ws[ce], p.s);
            y[e] = __fadd_rn(__fmul_rn(__int2float_rn(a[e]), scale), p.bias[ce]);
            if (p.relu) y[e] = y[e] > 0.f ? y[e] : 0.f;
          }
          if constexpr (kOut == kOutBF16) {
            __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
            if (pairs && c + 1 < p.cout) {
              *reinterpret_cast<__nv_bfloat162*>(out + base) =
                  __halves2bfloat162(__float2bfloat16_rn(y[0]), __float2bfloat16_rn(y[1]));
            } else {
              if (c < p.cout) out[base] = __float2bfloat16_rn(y[0]);
              if (c + 1 < p.cout) out[base + 1] = __float2bfloat16_rn(y[1]);
            }
          } else {
            float* out = static_cast<float*>(p.out);
            if (pairs && c + 1 < p.cout) {
              *reinterpret_cast<float2*>(out + base) = make_float2(y[0], y[1]);
            } else {
              if (c < p.cout) out[base] = y[0];
              if (c + 1 < p.cout) out[base + 1] = y[1];
            }
          }
        }
      }
    }
  }
}

template <bool kVec>
void launch(const Params& p, int out_kind, dim3 grid, cudaStream_t stream) {
  if (out_kind == kOutF32)
    qconv_kernel<kVec, kOutF32><<<grid, kThreads, 0, stream>>>(p);
  else if (out_kind == kOutBF16)
    qconv_kernel<kVec, kOutBF16><<<grid, kThreads, 0, stream>>>(p);
  else
    qconv_kernel<kVec, kOutAcc><<<grid, kThreads, 0, stream>>>(p);
}

}  // namespace

// out_kind: 0 f32, 1 bf16 (both through the epilogue), 2 the int32 accumulator
// alone (ws, bias and s unused). Returns a cudaError_t (0: launched).
extern "C" int qconv_int8_fwd(const void* x, const void* w, const void* ws, const void* bias,
                              float s, void* out, int n, int h, int width, int cin, int cout,
                              int kh, int kw, int dil, int relu, int out_kind, void* stream) {
  if (n <= 0 || h <= 0 || width <= 0 || cin <= 0 || cout <= 0 || kh <= 0 || kw <= 0 ||
      kh % 2 == 0 || kw % 2 == 0 || dil <= 0 || out_kind < 0 || out_kind > 2)
    return int(cudaErrorInvalidValue);
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.ws = static_cast<const float*>(ws);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.s = s;
  p.m = static_cast<long long>(n) * h * width;
  p.h = h;
  p.w_ = width;
  p.cin = cin;
  p.cout = cout;
  p.kh = kh;
  p.kw = kw;
  p.dil = dil;
  p.relu = relu;
  const long long blocks_m = (p.m + kBM - 1) / kBM;
  if (blocks_m > 0x7fffffffLL || (cout + kBN - 1) / kBN > 65535)
    return int(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks_m), (cout + kBN - 1) / kBN);
  const bool vec = cin % 16 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec)
    launch<true>(p, out_kind, grid, st);
  else
    launch<false>(p, out_kind, grid, st);
  return int(cudaGetLastError());
}

extern "C" const char* qconv_int8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
