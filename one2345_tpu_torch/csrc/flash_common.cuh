// Helpers of the flash-attention kernels for Hopper (sm_90a): the
// tensor-core product, bf16 packing, ldmatrix fragment loads, cp.async
// copies from device to shared memory and the ring of tiles they fill, the
// hardware exp2; on the host, the dynamic shared-memory limit set once per
// kernel instance and device.
//
// Fragment layouts are those of mma.sync m16n8k16 (PTX ISA, "Matrix
// fragments for mma.m16n8k16"): a lane holds rows g = lane / 4 and g + 8,
// columns 2 * (lane % 4) and + 1, of each 8x8 block.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

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

// Issue the copies of rows [row0, row0 + ROWS) x columns [0, DP) of a
// [rows, D] bf16 matrix with row stride `ld` into a shared tile of pitch
// DP + 8, VEC bytes per copy, zero-filling rows >= n_rows and columns >= D.
// Each thread keeps one column chunk (threads past the row's last chunk
// idle: the chunks per row are rounded up to a power of two) and walks the
// rows with one pointer, so a copy costs no division and few registers.
template <int DP, int ROWS, int THREADS, int VEC>
__device__ __forceinline__ void copy_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long ld, int row0, int n_rows, int D) {
  constexpr int kElems = VEC / 2;  // bf16 per copy
  constexpr int kPerRow = DP / kElems;
  constexpr int kLanes = kPerRow <= 8 ? 8 : kPerRow <= 16 ? 16 : kPerRow <= 32 ? 32
                         : kPerRow <= 64 ? 64 : 128;
  static_assert(kPerRow <= kLanes && THREADS % kLanes == 0, "a row's chunks fit the block");
  constexpr int kStep = THREADS / kLanes;  // rows between a thread's copies
  static_assert(ROWS % kStep == 0, "the rows split evenly over the threads");
  const int chunk = threadIdx.x % kLanes;
  if (chunk >= kPerRow) return;
  const int c = chunk * kElems;
  int r = threadIdx.x / kLanes;
  const __nv_bfloat16* p = src + (long long)(row0 + r) * ld + c;
  __nv_bfloat16* d = dst + r * (DP + 8) + c;
  auto copy_next = [&]() {
    const bool in = row0 + r < n_rows && c < D;
    cp_async<VEC>(d, in ? p : src, in);
    r += kStep;
    p += kStep * ld;
    d += kStep * (DP + 8);
  };
  // 16-byte copies are a few per thread: unrolled.  4-byte ones are up to
  // 64 per thread, and unrolled they would hold a register per copy
  if constexpr (VEC == 16) {
#pragma unroll
    for (int i = 0; i < ROWS / kStep; ++i) copy_next();
  } else {
#pragma unroll 2
    for (int i = 0; i < ROWS / kStep; ++i) copy_next();
  }
}

// The ring that streams a kernel's loop operand from device to shared
// memory: STAGES slots, one cp.async group per tile.  `issue(t, slot)`
// issues the copies of tile t into ring slot `slot`.  Past the last tile
// the group is left empty, so the count of pending groups stays uniform.
template <int STAGES, class Issue>
__device__ __forceinline__ void ring_issue(int t, int n_tiles, Issue& issue) {
  if (t < n_tiles) issue(t, t % STAGES);
  cp_async_commit();
}

// Before the loop: tiles 0 .. STAGES-2 in flight.  Groups committed before
// this call (a block's fixed operand) complete after cp_async_wait<STAGES-1>.
template <int STAGES, class Issue>
__device__ __forceinline__ void ring_fill(int n_tiles, Issue& issue) {
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) ring_issue<STAGES>(t, n_tiles, issue);
}

// The loop over tiles: wait for tile t's copies (this thread's, then, by
// one __syncthreads, everyone's; the same barrier retires tile t-1's
// reads), issue tile t + STAGES - 1 into the slot tile t-1 used, so that
// its copies run under tile t's work, and run body(t, slot of tile t).
template <int STAGES, class Issue, class Body>
__device__ __forceinline__ void ring_run(int n_tiles, Issue& issue, Body& body) {
  static_assert(STAGES >= 2, "the ring needs two stages");
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    ring_issue<STAGES>(t + STAGES - 1, n_tiles, issue);
    body(t, t % STAGES);
  }
}

// 2^x on the special-function unit (ex2.approx, subnormal results flushed
// to zero; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr int kMaxDevices = 64;

// The dynamic shared-memory limit is an attribute of each kernel instance
// on each device: set it on the instance's first launch on the current
// device only (`done`: one flag per device, static in the caller's
// instance).  Returns the cudaError_t.
template <class Kernel>
inline int set_smem_once(Kernel kernel, int bytes, std::atomic<bool> (&done)[kMaxDevices]) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!done[device].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    done[device].store(true, std::memory_order_release);
  }
  return 0;
}

}  // namespace flash
