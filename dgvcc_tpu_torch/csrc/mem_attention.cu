// Prototype-memory attention for Hopper (sm_90a), two kernels behind one
// C entry point:
//
//     out[r, :] = softmax_S(y[r, :] . M / sqrt(K)) . M^T      r < rows
//
// y: (rows, K) row-major, M: (K, S) row-major, out: (rows, K) in y's type.
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
// bf16 kernel: one pass with an online softmax (flash-attention style).
// A block of 4 warps takes 64 rows, 16 per warp, and two blocks share an
// SM (107.5 KB of shared memory each at K=256); the y tile stays in
// shared memory, and M streams through a double buffer of S-chunks
// (cp.async). For each chunk a warp computes its logits with bf16
// mma.sync m16n8k16 (f32 accumulation: bf16 x bf16 is exact in f32),
// updates each row's running max and sum in f32, and accumulates
// p . M^T into registers, rescaling them when the max grows. p stays in
// f32 as the Pallas kernel keeps it: it is split p = hi + lo into two bf16
// values (16 significant bits, more than TF32) and p . M^T = hi . M^T +
// lo . M^T, so p is never rounded to bf16 as the einsum path does. The
// (rows, S) attention never reaches device memory.
//
// f32 kernel: two passes (row statistics, then the normalised p) in plain
// f32 FMA on the CUDA cores, no TF32 anywhere.
//
// Any number of rows (masked tail) and any S (masked tail); K must be one
// of the instantiated widths (16, 32, 64, 128, 256).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------ bf16 / mma.sync
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;   // rows per block, 16 per warp
constexpr int kChunk = 64;           // prototypes per S-chunk
constexpr int kLdM = kChunk + 8;     // bf16 row pitch of an M chunk (144 B)

template <int K>
struct MmaSmem {
  static constexpr int kLdY = K + 8;                               // bf16 pitch
  static constexpr size_t y = 0;                                   // kRows x kLdY
  static constexpr size_t m = size_t(kRows) * kLdY * 2;            // 2 x K x kLdM
  static constexpr size_t m_stage = size_t(K) * kLdM * 2;
  static constexpr size_t bytes = m + 2 * m_stage;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; bytes past `valid` (0..16) are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// d += a . b, m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

// p = hi + lo: two bf16 pairs carrying (x0, x1) to 16 significant bits
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// M[:, s0:s0+kChunk] -> a shared stage (K x kLdM), columns past S zeroed
template <int K>
__device__ void load_m_chunk(const __nv_bfloat16* __restrict__ mem, int S, int s0,
                             __nv_bfloat16* stage) {
  constexpr int kVec = kChunk / 8;
  if (S % 8 == 0) {
    for (int i = threadIdx.x; i < K * kVec; i += kThreads) {
      const int k = i / kVec, v = i % kVec, s = s0 + v * 8;
      const int valid = s < S ? 16 : 0;
      cp_async16(stage + k * kLdM + v * 8, valid ? mem + int64_t(k) * S + s : mem,
                 valid);
    }
  } else {  // rows of M are not 16-byte aligned: plain loads
    for (int i = threadIdx.x; i < K * kChunk; i += kThreads) {
      const int k = i / kChunk, c = i % kChunk;
      stage[k * kLdM + c] =
          s0 + c < S ? mem[int64_t(k) * S + s0 + c] : __float2bfloat16(0.f);
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads, 2)
mem_attention_bf16_kernel(const __nv_bfloat16* __restrict__ y,
                          const __nv_bfloat16* __restrict__ mem,
                          __nv_bfloat16* __restrict__ out,
                          int64_t rows, int S, float scale) {
  using L = MmaSmem<K>;
  constexpr int kLdY = L::kLdY;
  constexpr int kNt = K / 8;  // n8 tiles of the output row
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(smem + L::y);
  __nv_bfloat16* ms0 = reinterpret_cast<__nv_bfloat16*>(smem + L::m);
  __nv_bfloat16* ms1 = reinterpret_cast<__nv_bfloat16*>(smem + L::m + L::m_stage);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group, column pair
  const int64_t row0 = int64_t(blockIdx.x) * kRows;
  const int n_chunks = (S + kChunk - 1) / kChunk;

  // prologue: the y tile and M chunk 0 in one cp.async group
  for (int i = threadIdx.x; i < kRows * (K / 8); i += kThreads) {
    const int r = i / (K / 8), v = i % (K / 8);
    const bool in = row0 + r < rows;
    cp_async16(ys + r * kLdY + v * 8, in ? y + (row0 + r) * K + v * 8 : y, in ? 16 : 0);
  }
  load_m_chunk<K>(mem, S, 0, ms0);
  cp_async_commit();

  // ldmatrix lane addressing: lane l supplies row (l & 7) of 8x8 matrix l >> 3
  const int mi = lane >> 3, mr = lane & 7;
  const __nv_bfloat16* ya = ys + (warp * 16 + (mi & 1) * 8 + mr) * kLdY + (mi >> 1) * 8;

  float o[kNt][4];
#pragma unroll
  for (int n = 0; n < kNt; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g, g + 8
  float l_run[2] = {0.f, 0.f};               // this thread's share of the sum

  for (int c = 0; c < n_chunks; ++c) {
    const int s0 = c * kChunk;
    const __nv_bfloat16* ms = (c & 1) ? ms1 : ms0;
    if (c + 1 < n_chunks) {
      load_m_chunk<K>(mem, S, s0 + kChunk, (c & 1) ? ms0 : ms1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // logits of the warp's 16 rows x kChunk columns
    float sc[kChunk / 8][4];
#pragma unroll
    for (int n = 0; n < kChunk / 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, ya + kk * 16);
#pragma unroll
      for (int np = 0; np < kChunk / 16; ++np) {
        // B = M chunk rows k, columns s: transposed 8x8 loads give (k pair, s)
        uint32_t b[4];
        ldmatrix_x4_trans(b, ms + (kk * 16 + (mi & 1) * 8 + mr) * kLdM + np * 16 + (mi >> 1) * 8);
        mma_bf16(sc[2 * np], a, b[0], b[1]);
        mma_bf16(sc[2 * np + 1], a, b[2], b[3]);
      }
    }

    // online softmax: thread holds rows g (regs 0, 1) and g + 8 (regs 2, 3)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kChunk / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = s0 + n * 8 + 2 * t + (e & 1) < S;
        sc[n][e] = ok ? sc[n][e] * scale : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_run[h], mx[h]);
      alpha[h] = __expf(m_run[h] - m_new);
      m_run[h] = m_new;
      l_run[h] *= alpha[h];
    }
#pragma unroll
    for (int n = 0; n < kNt; ++n) {
      o[n][0] *= alpha[0]; o[n][1] *= alpha[0];
      o[n][2] *= alpha[1]; o[n][3] *= alpha[1];
    }
#pragma unroll
    for (int n = 0; n < kChunk / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[n][e] = __expf(sc[n][e] - m_run[e >> 1]);
        l_run[e >> 1] += sc[n][e];
      }
    }

    // o += p . M^T, p = hi + lo; B = M^T chunk (s, k): plain 8x8 loads of
    // M rows k give (s pair, k)
#pragma unroll
    for (int j = 0; j < kChunk / 16; ++j) {
      uint32_t ph[4], pl[4];
      split_bf16(sc[2 * j][0], sc[2 * j][1], ph[0], pl[0]);
      split_bf16(sc[2 * j][2], sc[2 * j][3], ph[1], pl[1]);
      split_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1], ph[2], pl[2]);
      split_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int np = 0; np < kNt / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, ms + (np * 16 + (mi >> 1) * 8 + mr) * kLdM + j * 16 + (mi & 1) * 8);
        mma_bf16(o[2 * np], ph, b[0], b[1]);
        mma_bf16(o[2 * np], pl, b[0], b[1]);
        mma_bf16(o[2 * np + 1], ph, b[2], b[3]);
        mma_bf16(o[2 * np + 1], pl, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // normalise, stage the warp's 16 rows in its own rows of the y tile,
  // then write them out in 16-byte pieces
  float inv_l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv_l[h] = 1.f / l;
  }
  __nv_bfloat16* yw = ys + warp * 16 * kLdY;
#pragma unroll
  for (int n = 0; n < kNt; ++n) {
    *reinterpret_cast<uint32_t*>(yw + g * kLdY + n * 8 + 2 * t) =
        pack_bf16(o[n][0] * inv_l[0], o[n][1] * inv_l[0]);
    *reinterpret_cast<uint32_t*>(yw + (g + 8) * kLdY + n * 8 + 2 * t) =
        pack_bf16(o[n][2] * inv_l[1], o[n][3] * inv_l[1]);
  }
  __syncwarp();
  for (int i = lane; i < 16 * (K / 8); i += 32) {
    const int r = i / (K / 8), v = i % (K / 8);
    const int64_t row = row0 + warp * 16 + r;
    if (row < rows)
      *reinterpret_cast<uint4*>(out + row * K + v * 8) =
          *reinterpret_cast<const uint4*>(yw + r * kLdY + v * 8);
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

template <int K>
cudaError_t dispatch(const void* y, const void* mem, void* out, int64_t rows, int S,
                     int dtype, cudaStream_t stream) {
  const float scale = 1.f / sqrtf(float(K));
  cudaError_t err;
  if (dtype == 1) {
    const size_t smem = MmaSmem<K>::bytes;
    err = cudaFuncSetAttribute(mem_attention_bf16_kernel<K>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid(unsigned((rows + kRows - 1) / kRows));
    mem_attention_bf16_kernel<K><<<grid, kThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(y), static_cast<const __nv_bfloat16*>(mem),
        static_cast<__nv_bfloat16*>(out), rows, S, scale);
  } else {
    const size_t smem = (size_t(kRowsF) * (K + 1) + size_t(K) * kLdMF) * sizeof(float);
    err = cudaFuncSetAttribute(mem_attention_f32_kernel<K>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid(unsigned((rows + kRowsF - 1) / kRowsF));
    mem_attention_f32_kernel<K><<<grid, 128, smem, stream>>>(
        static_cast<const float*>(y), static_cast<const float*>(mem),
        static_cast<float*>(out), rows, S, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
// cudaErrorInvalidValue for a K that has no instantiation.
extern "C" int mem_attention_fwd(const void* y, const void* mem, void* out,
                                 long long rows, int K, int S, int dtype,
                                 void* stream) {
  if (rows <= 0) return 0;
  if (S <= 0 || (dtype != 0 && dtype != 1)) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 16: return int(dispatch<16>(y, mem, out, rows, S, dtype, st));
    case 32: return int(dispatch<32>(y, mem, out, rows, S, dtype, st));
    case 64: return int(dispatch<64>(y, mem, out, rows, S, dtype, st));
    case 128: return int(dispatch<128>(y, mem, out, rows, S, dtype, st));
    case 256: return int(dispatch<256>(y, mem, out, rows, S, dtype, st));
    default: return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* mem_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
