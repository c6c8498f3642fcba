// Hopper (sm_90a) helpers shared by the flash-attention kernels: mbarriers,
// TMA tensor loads and the host's encoding of their tensor maps,
// shared-memory matrix descriptors, the warpgroup products (wgmma) and
// their fences, the consumer warpgroups' turns, bf16 packing, the
// hardware exp2, and on the host the dynamic shared-memory limit set once
// per kernel instance and device.
//
// Accumulator layout of wgmma m64nNk16 (PTX ISA, "Matrix fragments for
// wgmma .m64nNk16"): warp i of the warpgroup holds rows 16 i .. 16 i + 15;
// n-tile j (columns 8 j .. 8 j + 7) of lane l is d[4 j] and d[4 j + 1]
// (row g = l / 4, columns 8 j + 2 (l % 4) and + 1) and d[4 j + 2], d[4 j + 3]
// (row g + 8).  The same registers re-packed as bf16 pairs are the A
// fragments of a product from registers: k-step kk (columns 16 kk .. 16 kk
// + 15) is n-tiles 2 kk and 2 kk + 1 (`pack_a`).
//
// Tiles in shared memory are TMA boxes in the 128-byte swizzle: rows of 64
// bf16 columns (128 bytes; a wider row is split into chunks of 64 columns,
// chunk c of a tile of R rows at c * R * 128 bytes), the 16-byte groups of
// row r permuted by r % 8, every tile 1024-byte aligned.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace flash {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kChunkCols = 64;  // bf16 columns of one 128-byte swizzled row
constexpr int kRowBytes = 128;

// two f32 -> one 32-bit word of bf16, `lo` in the low half (lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 2^x on the special-function unit (ex2.approx, subnormal results flushed
// to zero; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_addr(bar)) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// ------------------------------------------------------------------- TMA

// one box of a 4-D tensor map (columns, rows, head, batch) into shared
// memory, completing `bytes` on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int col, int row, int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)),
         "r"(col), "r"(row), "r"(head), "r"(batch)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// Rows of a TMA box: the tile's rows, or fewer when the whole sequence is
// shorter (rounded up to 8); columns: 64, or D rounded up to 8 when one
// chunk holds the row.  The host encodes the maps with the same counts.
__host__ __device__ constexpr int box_rows(int tile_rows, int length) {
  return tile_rows < (length + 7) / 8 * 8 ? tile_rows : (length + 7) / 8 * 8;
}

__host__ __device__ constexpr int box_cols(int chunks, int D) {
  return chunks == 1 ? (D + 7) / 8 * 8 : kChunkCols;
}

// Issue the boxes of one [rows, D] tile of a [B, L, H, D] tensor (all its
// 64-column chunks) into `dst`, completing on `bar`
template <int ROWS, int CHUNKS>
__device__ __forceinline__ void tma_tile(unsigned char* dst, const CUtensorMap* map,
                                         uint64_t* bar, int row, int head, int batch) {
#pragma unroll
  for (int ch = 0; ch < CHUNKS; ++ch) {
    tma_load(dst + ch * ROWS * kRowBytes, map, bar, ch * kChunkCols, row, head, batch);
  }
}

// ----------------------------------------------------------------- wgmma

// Shared-memory matrix descriptor of a 128-byte-swizzled operand (layout
// type 1): start address, leading and stride byte offsets, all >> 4.  For a
// K-major operand (rows of 128 bytes along K) the stride offset is the 8-row
// group's 1024 bytes and the leading offset is unused; for an MN-major one
// (rows of 128 bytes along N, one row per k index) the stride offset is the
// 8-row group's 1024 bytes and the leading offset the distance between
// 64-column chunks.  An offset below 256 KB added to a descriptor adds to
// its start-address field.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lead_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lead_bytes >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the fence, commit and wait instructions
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
  }
}

#define D8(i)                                                                              \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= A B^T, m64nNk16, A and B from shared memory (both K-major);
// scale_d 0 overwrites d
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d);

// d += A B, m64nNk16, A a 64x16 bf16 fragment in registers (four words per
// thread, the mma.sync m16n8k16 A layout per warp), B from shared memory
// MN-major (transposed)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_ss<16>(float (&d)[8], uint64_t desc_a, uint64_t desc_b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : D8(0)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : D8(0), D8(8)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<40>(float (&d)[20], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19"
      "}, {%20, %21, %22, %23}, %24, p, 1, 1, 1;\n}\n"
      : D8(0), D8(8), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<48>(float (&d)[24], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<80>(float (&d)[40], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<160>(float (&d)[80], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56), D8(64), D8(72)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

#undef D8

// The accumulator of an m64nN product as the bf16 A fragments of a product
// over its N columns: k-step kk (columns 16 kk .. 16 kk + 15) is n-tiles
// 2 kk and 2 kk + 1
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 16][4], const float (&s)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) a[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
  }
}

// The consumer warpgroups take turns issuing products, in a ring: warpgroup
// w waits on barrier 1 + w and hands the turn to the next by arriving at
// its barrier (256 threads: the waiting warpgroup and the arriving one)
template <int CONSUMERS>
__device__ __forceinline__ void turn_wait(int w) {
  if (CONSUMERS > 1) asm volatile("bar.sync %0, 256;\n" :: "r"(1 + w) : "memory");
}

template <int CONSUMERS>
__device__ __forceinline__ void turn_pass(int w) {
  if (CONSUMERS > 1) {
    asm volatile("bar.arrive %0, 256;\n" :: "r"(1 + (w + 1) % CONSUMERS) : "memory");
  }
}

// ------------------------------------------------------------------ host

constexpr int kMaxDevices = 64;

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, looked up once (no -lcuda)
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiled>(ptr);
  }();
  return fn;
}

// The 4-D map of a bf16 [B, L, H, D] tensor with (batch, token, head)
// element strides st[0..2]: boxes of `cols` columns x `rows` tokens of one
// head, 128-byte swizzle, zeros outside the tensor
inline int encode_map(CUtensorMap* map, const void* base, int B, int L, int H, int D,
                      const long long* st, int rows, int cols) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[1] * 2, (cuuint64_t)st[2] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                              dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// SMs of `device`, looked up once per device
inline int sm_count(int device) {
  static std::atomic<int> count[kMaxDevices];
  int n = count[device].load(std::memory_order_relaxed);
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) return 0;
    count[device].store(n, std::memory_order_relaxed);
  }
  return n;
}

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

// Blocks of `kernel` (THREADS threads, SMEM bytes) resident per SM and the
// device's SMs: the grid of a persistent launch is their product, or fewer
// when there are fewer tiles.  `smem_set` and `per_sm` are static in the
// caller's instance.  Returns the cudaError_t; `grid` is set on success.
template <class Kernel>
inline int persistent_grid(Kernel kernel, int threads, int smem, long long tiles,
                           std::atomic<bool> (&smem_set)[kMaxDevices],
                           std::atomic<int> (&per_sm)[kMaxDevices], unsigned* grid) {
  int err = set_smem_once(kernel, smem, smem_set);
  if (err != 0) return err;
  int device = 0;
  cudaGetDevice(&device);  // checked by set_smem_once
  int blocks = per_sm[device].load(std::memory_order_relaxed);
  if (blocks == 0) {
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                                         threads, smem));
    if (err != 0) return err;
    if (blocks == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    per_sm[device].store(blocks, std::memory_order_relaxed);
  }
  const long long slots = (long long)blocks * sm_count(device);
  *grid = static_cast<unsigned>(tiles < slots ? tiles : slots);
  return 0;
}

}  // namespace flash
