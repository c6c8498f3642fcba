// Device helpers of the flash-attention kernels for Hopper (sm_90a): the
// tensor-core product, bf16 packing, ldmatrix fragment loads, cp.async
// copies from device to shared memory, and the hardware exp2.
//
// Fragment layouts are those of mma.sync m16n8k16 (PTX ISA, "Matrix
// fragments for mma.m16n8k16"): a lane holds rows g = lane / 4 and g + 8,
// columns 2 * (lane % 4) and + 1, of each 8x8 block.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace flash {

// c += a . b on the tensor cores: a is a 16x16 bf16 A fragment (row-major),
// b0/b1 the 16x8 bf16 B fragment (k rows 0-7, 8-15), c a 16x8 f32 tile
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one 32-bit word of bf16, `lo` in the low half (lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 blocks of a row-major shared tile; lanes 8i..8i+7 give the
// row addresses (16 bytes each) of block i, which lands in r[i]
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The same, each block transposed on the way into registers
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Asynchronous copy of BYTES (16 or 4) from device memory to shared memory;
// with `fill` false nothing is read and the destination is zeroed (src-size
// 0), so `src` only has to be some valid address.  16-byte copies bypass
// L1 (.cg); 4-byte ones cannot (.ca).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool fill) {
  static_assert(BYTES == 16 || BYTES == 4, "cp.async of 16 or 4 bytes");
  const int n = fill ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(n) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(n) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// 2^x on the special-function unit (ex2.approx, subnormal results flushed
// to zero; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace flash
