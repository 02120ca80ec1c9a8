// Warp-level building blocks of the training kernels' bf16 paths
// (mem_attention_train.cu): cp.async copies, ldmatrix loads and the
// m16n8k16 bf16 mma.sync with f32 accumulation, and the streaming of an
// S-chunk of the bank M into shared memory. The Hopper blocks (wgmma, TMA,
// mbarriers) are in wgmma_sm90.cuh.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_sm90 {

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

// two floats rounded to nearest-even bf16, packed (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// M[:, s0:s0+kChunk] -> a shared stage (K x (kChunk + 8)), columns past S
// zeroed; all kThreads threads of the block take part
template <int K, int kChunk, int kThreads>
__device__ void load_m_chunk(const __nv_bfloat16* __restrict__ mem, int S, int s0,
                             __nv_bfloat16* stage) {
  constexpr int kLd = kChunk + 8;
  constexpr int kVec = kChunk / 8;
  if (S % 8 == 0) {
    for (int i = threadIdx.x; i < K * kVec; i += kThreads) {
      const int k = i / kVec, v = i % kVec, s = s0 + v * 8;
      const int valid = s < S ? 16 : 0;
      cp_async16(stage + k * kLd + v * 8, valid ? mem + int64_t(k) * S + s : mem,
                 valid);
    }
  } else {  // rows of M are not 16-byte aligned: plain loads
    for (int i = threadIdx.x; i < K * kChunk; i += kThreads) {
      const int k = i / kChunk, c = i % kChunk;
      stage[k * kLd + c] =
          s0 + c < S ? mem[int64_t(k) * S + s0 + c] : __float2bfloat16(0.f);
    }
  }
}

}  // namespace mma_sm90
