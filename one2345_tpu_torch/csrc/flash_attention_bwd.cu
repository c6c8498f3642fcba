// Flash-attention backward for Hopper (sm_90a): dQ, dK and dV, bf16 in and
// out, f32 accumulation; Dsum computed inside the dq kernel.
//
// Replaces the Pallas TPU kernels `_flash_bwd_dq_kernel` and
// `_flash_bwd_dkv_kernel` (one2345_tpu/ops/flash_attention.py:71-132,
// launched by `_flash_folded_bwd`, which computes Dsum in XLA at :183-185),
// the FlashAttention-2 backward:
//   P  = exp(Q K^T / sqrt(D) - lse)      (recomputed from the forward's lse)
//   dP = dO V^T,   dS = P o (dP - Dsum),   Dsum_i = rowsum(dO_i o O_i)
//   dQ = dS K / sqrt(D),   dK = dS^T Q / sqrt(D),   dV = P^T dO
// No [T, S] matrix reaches device memory.
//
// Where it runs: the backward of every multi-token self-attention of the
// Zero123 UNet under training (16 launches of each kernel per train step):
// level 0 T=S=1024 D=40, level 1 T=S=256 D=80, level 2 T=S=64 D=160,
// middle T=S=16 D=160; 8 heads; B = 8.
//
// Bound on an H100 SXM, the largest of three terms.  At level 0, B=8:
// - tensor cores: dq does 3 products, 6*B*H*T*S*D = 16.1 GFLOP, and dkv 4,
//   8*B*H*T*S*D = 21.5 GFLOP; at 989 TFLOP/s -> 16 and 22 us;
// - bytes: dq reads q, k, v, O, dO, lse and writes dQ and Dsum (32 MB), dkv
//   reads q, k, v, dO, lse, Dsum and writes dK, dV (32 MB); at 3.35 TB/s
//   -> 10 and 10 us;
// - exp unit: one exp2 per score in each kernel, B*H*T*S = 67 M, at 16 per
//   clock per SM (CUDA C++ Programming Guide, compute capability 9.0) x 132
//   SMs x 1.98 GHz = 4.2e12/s -> 16 us.
// So both are bound by the tensor cores (dq only just, beside the exp
// unit): 38 us together, of which the recomputed S and dP of the second
// kernel are 11 (the whole backward needs 5 products: 27 us); the smaller
// levels sit at their byte bound.  With D padded to 48 the Q K^T and dO V^T
// products do 1.2x the counted work.
//
// Design (the forward's, csrc/flash_attention_fwd.cu, on the helpers of
// flash_common.cuh):
// - two kernels and no atomics, so the gradients are deterministic: two
//   launches on the same inputs give bit-identical dQ, dK and dV.  dq runs
//   first and writes Dsum (f32 [B, H, T]) for dkv, which runs after it on
//   the same stream;
// - warp specialisation: warpgroup 0 is the producer (setmaxnreg down to 24
//   registers, 32 in dkv), the others are consumers of 64 rows each of the
//   block's fixed operand pair (setmaxnreg up: the rest of the block's
//   registers, 224-240);
// - the producer moves every tile with TMA (4-D tensor maps over the [B, L,
//   H, D] strides, 128-byte swizzle, the maps encoded on the host per
//   call): the fixed pair once per work tile into FIXED slots, the streamed
//   pair through a ring of STAGES slots; each slot has a full and an empty
//   mbarrier.  Boxes are D rounded up to 8 columns wide (64 when D > 64)
//   and as long as the tile, or as a shorter sequence; rows past T or S and
//   columns past D come zero-filled (the out-of-bounds fill, or the shared
//   memory zeroed once);
//   dq: a block owns BM = 64 * CONSUMERS queries of one (batch, head): Q,
//   dO and O are fixed; K and V stream in tiles of BN keys;
//   dkv: a block owns BM keys: K and V are fixed; Q and dO stream in tiles
//   of BN queries, and the producer warp's 32 lanes copy the tile's lse
//   (times log2 e) and Dsum into the slot beside them (the full barrier
//   waits for the TMA bytes and the 32 lanes);
// - products (wgmma, bf16 in, f32 accumulate): dq computes S = Q K^T and
//   dP = dO V^T (both operands from shared memory, K-major), then dQ += dS K
//   with dS in registers and K read transposed (MN-major); dkv computes
//   S^T = K Q^T and dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q with
//   P^T and dS^T in registers.  The score accumulators re-pack in registers
//   as the A operands (flash::pack_a);
// - per score: one FFMA and one ex2.approx for P, and for dS = P o (dP -
//   Dsum) one FMUL in dkv, where the dP accumulator starts at -Dsum, and
//   one FADD and one FMUL in dq, which may not write an accumulator while
//   a product is in flight (below);
// - Dsum inside dq: at the start of each work tile a consumer thread sums
//   dO o O over its two rows from the swizzled shared tiles (16-byte reads,
//   four threads per row, two shuffles), keeps the sums and writes them
//   for dkv;
// - overlap, two schedules (chosen by measurement, PERF.md):
//   dq: each warpgroup keeps two buffers of S and dP and issues key tile
//   j + 1's score products before tile j's exps and multiplies, which run
//   under them and under tile j - 1's dQ product; then, nothing in flight,
//   it packs dS and issues tile j's dQ product.  No turns between the
//   warpgroups: they bought nothing here;
//   dkv: one buffer (two buffers and the dV and dK accumulators do not fit
//   the registers without ptxas serialising the products, C7512); a
//   warpgroup issues tile j's score products and tile j - 1's gradient
//   products in one turn and waits only for the first, so tile j's
//   pointwise work runs under tile j - 1's products, and the consumer
//   warpgroups take turns issuing (named barriers 1 .. CONSUMERS, in a
//   ring), so one's pointwise work runs under the other's products;
//   ptxas serialises every wgmma (C7513, C7515) where a non-wgmma
//   instruction writes a product's operands or accumulators while a
//   product is in flight, or where a product is issued on one branch
//   only: dq's accumulators start with scale-d 0, not a written value,
//   its last step is an instance of its own, and operands are packed with
//   nothing in flight.  A ring slot is released when the last
//   product that reads it is done, so STAGES >= 3;
// - persistent blocks: the blocks that fit on the SMs walk the work tiles
//   (consecutive tiles share one (batch, head), so the streamed tiles hit
//   in L2), and the producer loads the next tile's operands under the
//   current tile's last products;
// - masks: dkv needs none.  Queries >= T are zero rows of Q and dO with lse
//   = Dsum = 0, so their P^T is exactly 1, their dS^T exactly 0, and they
//   add exactly 0 to dK and dV; keys >= S are rows whose outputs are not
//   stored.  dq sets P = 0 for keys >= S (their P from lse could overflow)
//   only in a ragged last key tile, a separate instance of the pointwise
//   code; queries >= T are rows that are not stored.
// Inputs a tensor map cannot describe (a base not 16-byte aligned, a stride
// not a multiple of 8 elements, D % 8 != 0) are staged into an aligned copy
// by the wrapper (ops/flash_attention.py) before the launch.
//
// What the previous design (cp.async ring, ldmatrix, synchronous mma.sync
// m16n8k16) did instead, read from its SASS (PERF.md): one streamed
// 32-row tile of a dq warp was one instruction stream of 72 HMMA and 32
// MUFU.EX2 (dkv: 96 and 32), the S and dP products first with almost no
// exp beside them, so each warp ran its products and its exps in turn:
// 0.0645 + 0.0829 device ms at level 0, B=8, after 0.049 ms of Dsum passes
// in PyTorch; this design takes 0.047 + 0.060 with Dsum inside.
//
// Tile shapes (Tile<BN, CONSUMERS, STAGES, FIXED> below; each can be
// replaced at build time, which is how examples/torch_attention_sweep.py
// compares them), from same-call comparisons on an H100 80GB HBM3 at
// 700 W, device ms per launch at level 0, B=8 (PERF.md):
// - dq at 48: 64-key tiles, two consumers, 5 stages, two fixed slots:
//   0.0463, against 0.0482 with 4 stages and 0.0511 with 4 stages and one
//   fixed slot (the ring has to run two tiles ahead);
// - dkv at 48: 64-query tiles, two consumers, 3 stages, two fixed slots:
//   0.0660 against 0.0669 with 4 stages and 0.0679 with one fixed slot in
//   one call, 0.0589 against 0.0723 with three consumers of 32-query
//   tiles in another (64-query tiles spill with three);
// - D = 80 and 160: the shapes below are within 0.0005 ms of the others
//   tried (32-row tiles at 80, 16-key tiles for dq and two consumers for
//   dkv at 160) at level 1, level 2 and the middle block.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "flash_common.cuh"

namespace {

using flash::box_cols;
using flash::box_rows;
using flash::ex2;
using flash::fence_regs;
using flash::kChunkCols;
using flash::kLog2e;
using flash::kRowBytes;
using flash::mbar_arrive;
using flash::mbar_expect_tx;
using flash::mbar_init;
using flash::mbar_wait;
using flash::pack_a;
using flash::smem_addr;
using flash::smem_desc;
using flash::tma_prefetch_map;
using flash::tma_tile;
using flash::turn_pass;
using flash::turn_wait;
using flash::wgmma_commit;
using flash::wgmma_fence;
using flash::wgmma_rs;
using flash::wgmma_ss;
using flash::wgmma_wait;
typedef __nv_bfloat16 bf16;

// Shape of an instance: BN rows of the streamed pair per ring slot,
// CONSUMERS warpgroups of 64 rows of the fixed pair, STAGES ring slots and
// FIXED slots of the fixed pair (two: the next work tile's loads under this
// one's products)
template <int BN, int CONSUMERS, int STAGES, int FIXED>
struct Tile {
  static constexpr int kBlockN = BN, kConsumers = CONSUMERS, kStages = STAGES, kFixed = FIXED;
};

#ifndef FLASH_BWD_DQ48
#define FLASH_BWD_DQ48 Tile<64, 2, 5, 2>
#endif
#ifndef FLASH_BWD_DQ80
#define FLASH_BWD_DQ80 Tile<64, 2, 3, 1>
#endif
#ifndef FLASH_BWD_DQ160
#define FLASH_BWD_DQ160 Tile<32, 1, 3, 1>
#endif
#ifndef FLASH_BWD_DKV48
#define FLASH_BWD_DKV48 Tile<64, 2, 3, 2>
#endif
#ifndef FLASH_BWD_DKV80
#define FLASH_BWD_DKV80 Tile<64, 2, 3, 1>
#endif
#ifndef FLASH_BWD_DKV160
#define FLASH_BWD_DKV160 Tile<16, 1, 3, 1>
#endif

template <int DP>
struct DqConfig;
template <>
struct DqConfig<48> : FLASH_BWD_DQ48 {};
template <>
struct DqConfig<80> : FLASH_BWD_DQ80 {};
template <>
struct DqConfig<160> : FLASH_BWD_DQ160 {};

template <int DP>
struct DkvConfig;
template <>
struct DkvConfig<48> : FLASH_BWD_DKV48 {};
template <>
struct DkvConfig<80> : FLASH_BWD_DKV80 {};
template <>
struct DkvConfig<160> : FLASH_BWD_DKV160 {};

// Sizes of an instance of config C at padded width DP: NFIX tensors in a
// fixed slot (dq: Q, dO, O; dkv: K, V), two in a ring slot, and with STATS
// the ring slots' lse and Dsum rows (dkv, whose producer warp copies them
// and keeps PRODUCER_REGS registers for it)
template <int DP, class C, int NFIX, bool STATS, int PRODUCER_REGS>
struct Layout {
  static constexpr int kBlockN = C::kBlockN, kConsumers = C::kConsumers;
  static constexpr int kStages = C::kStages, kFixed = C::kFixed;
  static_assert(kStages >= 3, "three ring slots: products of two tiles in flight, one loading");
  static_assert(kBlockN % 16 == 0 && kBlockN <= 128, "BN: a multiple of 16, at most 128");
  static constexpr int kBlockM = 64 * kConsumers;
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kChunks = (DP + kChunkCols - 1) / kChunkCols;
  static constexpr int kMTile = kChunks * kBlockM * kRowBytes;  // one fixed tensor's tile
  static constexpr int kNTile = kChunks * kBlockN * kRowBytes;  // one streamed tensor's tile
  static constexpr int kFixedBytes = NFIX * kMTile;
  static constexpr int kStageBytes = 2 * kNTile;
  static constexpr int kStatsOffset = kFixed * kFixedBytes + kStages * kStageBytes;
  static constexpr int kStatsBytes = STATS ? kStages * 2 * kBlockN * 4 : 0;
  static constexpr int kBarrierOffset = kStatsOffset + kStatsBytes;
  static constexpr int kSmemBytes = kBarrierOffset + (2 * kFixed + 2 * kStages) * 8 + 1024;
  // registers: the entry allocation of kMinBlocks blocks per SM, split by
  // setmaxnreg between the producer and the consumers (the rest, rounded
  // down to 8: with a producer of 24, 240 for two consumers and 232 for
  // one; of 32, 232 and 224)
  static constexpr int kMinBlocks = kConsumers == 1 ? 2 : 1;
  static constexpr int kEntryRegs = (65536 / (kThreads * kMinBlocks)) / 8 * 8;
  static constexpr int kProducerRegs = PRODUCER_REGS;
  static constexpr int kConsumerRegs =
      (kEntryRegs * kThreads - 128 * kProducerRegs) / (128 * kConsumers) / 8 * 8;
  static_assert(kConsumerRegs <= 256, "setmaxnreg takes at most 256");
};

template <int DP>
using DqShape = Layout<DP, DqConfig<DP>, 3, false, 24>;
template <int DP>
using DkvShape = Layout<DP, DkvConfig<DP>, 2, true, 32>;

// (batch, token, head) element strides of an output
struct OutStrides {
  long long b, t, h;
};

// Descriptor offset (>> 4) of k-step k (16 columns) of a K-major tile of
// ROWS rows: chunk k / 4, 32 bytes further along the swizzled row per step
template <int ROWS>
__device__ __forceinline__ uint64_t kstep(int k) {
  return (k / 4) * (ROWS * kRowBytes / 16) + (k % 4) * 2;
}

// d (+)= A B^T over the DP / 16 k-steps of two K-major tiles (A: the
// warpgroup's 64 rows of a fixed tile of MROWS rows; B: a streamed tile of
// N rows); `accumulate` false overwrites d
template <int DP, int MROWS, int N>
__device__ __forceinline__ void product_ss(float (&d)[N / 2], uint64_t a, uint64_t b,
                                           bool accumulate = false) {
#pragma unroll
  for (int k = 0; k < DP / 16; ++k) {
    wgmma_ss<N>(d, a + kstep<MROWS>(k), b + kstep<N>(k), accumulate || k > 0);
  }
}

// d += A B over the N / 16 k-steps of A (bf16 fragments in registers) and
// B, a streamed tile of N rows read MN-major (16 rows, 2048 bytes, per step)
template <int N, int DV>
__device__ __forceinline__ void product_rs(float (&d)[DV / 2], const uint32_t (&a)[N / 16][4],
                                           uint64_t b) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) wgmma_rs<DV>(d, a[kk], b + kk * (16 * kRowBytes / 16));
}

// Store rows r and r + 8 of a warpgroup's f32 accumulator times `mul` as
// bf16 pairs (columns < D, rows < n_rows)
template <int DV>
__device__ __forceinline__ void store_rows(bf16* dst, long long ld, const float (&acc)[DV / 2],
                                           int row0, int n_rows, int D, float mul) {
  const int tg = threadIdx.x & 3;
  const int row1 = row0 + 8;
#pragma unroll
  for (int i = 0; i < DV / 8; ++i) {
    const int col = i * 8 + tg * 2;
    if (col < D) {
      if (row0 < n_rows) {
        *reinterpret_cast<__nv_bfloat162*>(dst + (long long)row0 * ld + col) =
            __floats2bfloat162_rn(acc[4 * i] * mul, acc[4 * i + 1] * mul);
      }
      if (row1 < n_rows) {
        *reinterpret_cast<__nv_bfloat162*>(dst + (long long)row1 * ld + col) =
            __floats2bfloat162_rn(acc[4 * i + 2] * mul, acc[4 * i + 3] * mul);
      }
    }
  }
}

// Zero the tiles (so pad columns and rows no box reaches stay zero), make
// that visible to TMA and wgmma, and initialise the mbarriers: full ones
// count `full_arrivals` (the producer's expect_tx, and for dkv its 32
// lanes), empty ones one arrival per consumer warpgroup
__device__ __forceinline__ void init_block(unsigned char* smem, int zero_bytes, uint64_t* bars,
                                           int n_fixed, int n_stages, int full_arrivals,
                                           int consumers) {
  for (int i = threadIdx.x; i < zero_bytes / 16; i += blockDim.x) {
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (threadIdx.x == 0) {
    for (int i = 0; i < n_fixed; ++i) {
      mbar_init(bars + i, 1);
      mbar_init(bars + n_fixed + i, consumers);
    }
    uint64_t* ring = bars + 2 * n_fixed;
    for (int i = 0; i < n_stages; ++i) {
      mbar_init(ring + i, full_arrivals);
      mbar_init(ring + n_stages + i, consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// ---------------------------------------------------------------- dq ----

// The pointwise work of one key tile in place: s becomes P = 2^(s c - l2),
// dp becomes dS = P o (dP - Dsum).  kMask sets P = 0 for keys >= S.  Rows
// g (l2[0], ds[0]) and g + 8 (l2[1], ds[1]).
template <int BN, bool kMask>
__device__ __forceinline__ void dq_pointwise(float (&s)[BN / 2], float (&dp)[BN / 2],
                                             const float (&l2)[2], const float (&ds)[2], int kv0,
                                             int S, float c) {
  const int tg = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (kMask && kv0 + i * 8 + tg * 2 + j >= S) {
        s[4 * i + j] = s[4 * i + 2 + j] = -CUDART_INF_F;
      }
      s[4 * i + j] = ex2(fmaf(s[4 * i + j], c, -l2[0]));
      s[4 * i + 2 + j] = ex2(fmaf(s[4 * i + 2 + j], c, -l2[1]));
      dp[4 * i + j] = (dp[4 * i + j] - ds[0]) * s[4 * i + j];
      dp[4 * i + 2 + j] = (dp[4 * i + 2 + j] - ds[1]) * s[4 * i + 2 + j];
    }
  }
}

// rowsum(dO o O) of rows r and r + 8 of a fixed tile of BM rows (r % 8 =
// g, the 16-byte group swizzle of both rows): thread tg of the row's four
// sums the 16-byte groups tg, tg + 4, ... of the padded row, then the four
// partial sums are added by two shuffles
template <int DP, int BM>
__device__ __forceinline__ void rowsum_do_o(float (&sum)[2], const unsigned char* dot,
                                            const unsigned char* ot, int r) {
  const int g = (threadIdx.x & 31) >> 2, tg = threadIdx.x & 3;
  sum[0] = sum[1] = 0.f;
#pragma unroll
  for (int gg = 0; gg < DP / 8; gg += 4) {
    const int group = gg + tg;
    if (group < DP / 8) {
      const int off = (group / 8) * BM * kRowBytes + r * kRowBytes + (((group % 8) ^ g) << 4);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int o = off + half * 8 * kRowBytes;
        const uint4 a = *reinterpret_cast<const uint4*>(dot + o);
        const uint4 b = *reinterpret_cast<const uint4*>(ot + o);
        const uint32_t aw[4] = {a.x, a.y, a.z, a.w}, bw[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&aw[e]));
          const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bw[e]));
          sum[half] = fmaf(x.x, y.x, sum[half]);
          sum[half] = fmaf(x.y, y.y, sum[half]);
        }
      }
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 1);
    sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 2);
  }
}

template <int DP, int DV>
__global__ void __launch_bounds__(DqShape<DP>::kThreads, DqShape<DP>::kMinBlocks)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_o,
                    const __grid_constant__ CUtensorMap map_do, const float* __restrict__ lse,
                    bf16* __restrict__ dq, float* __restrict__ dsum, OutStrides sq, int B,
                    int H, int T, int S, int D, float c, float scale) {
  using L = DqShape<DP>;
  constexpr int BM = L::kBlockM, BN = L::kBlockN, STAGES = L::kStages, FIXED = L::kFixed;
  constexpr int CONSUMERS = L::kConsumers, CH = L::kChunks;
  extern __shared__ unsigned char smem_raw[];
  // swizzled tiles want 1024-byte alignment
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sfix = smem;                       // slot i: Q, dO, O
  unsigned char* sring = smem + FIXED * L::kFixedBytes;  // slot i: K, V
  uint64_t* fix_full = reinterpret_cast<uint64_t*>(smem + L::kBarrierOffset);
  uint64_t* fix_empty = fix_full + FIXED;
  uint64_t* ring_full = fix_empty + FIXED;
  uint64_t* ring_empty = ring_full + STAGES;
  init_block(smem, L::kBarrierOffset, fix_full, FIXED, STAGES, 1, CONSUMERS);
  // each side computes its tile counts after its setmaxnreg: a value live
  // across the split would have to fit the producer's few registers
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(L::kProducerRegs));
    const int n_m = (T + BM - 1) / BM, n_tiles = n_m * B * H, n_kv = (S + BN - 1) / BN;
    if (threadIdx.x == 0) {
      tma_prefetch_map(&map_q);
      tma_prefetch_map(&map_k);
      tma_prefetch_map(&map_v);
      tma_prefetch_map(&map_o);
      tma_prefetch_map(&map_do);
      const int row_bytes = CH * box_cols(CH, D) * 2;
      const uint32_t fix_bytes = 3 * row_bytes * box_rows(BM, T);
      const uint32_t kv_bytes = 2 * row_bytes * box_rows(BN, S);
      int stage = 0, phase = 0, count = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++count) {
        const int m_block = tile % n_m, bh = tile / n_m;
        const int b = bh / H, h = bh - b * H;
        const int fs = count % FIXED;
        unsigned char* fix = sfix + fs * L::kFixedBytes;
        mbar_wait(fix_empty + fs, ((count / FIXED) & 1) ^ 1);
        mbar_expect_tx(fix_full + fs, fix_bytes);
        tma_tile<BM, CH>(fix, &map_q, fix_full + fs, m_block * BM, h, b);
        tma_tile<BM, CH>(fix + L::kMTile, &map_do, fix_full + fs, m_block * BM, h, b);
        tma_tile<BM, CH>(fix + 2 * L::kMTile, &map_o, fix_full + fs, m_block * BM, h, b);
        for (int j = 0; j < n_kv; ++j) {
          unsigned char* slot = sring + stage * L::kStageBytes;
          mbar_wait(ring_empty + stage, phase ^ 1);
          mbar_expect_tx(ring_full + stage, kv_bytes);
          tma_tile<BN, CH>(slot, &map_k, ring_full + stage, j * BN, h, b);
          tma_tile<BN, CH>(slot + L::kNTile, &map_v, ring_full + stage, j * BN, h, b);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(L::kConsumerRegs));
    const int n_m = (T + BM - 1) / BM, n_tiles = n_m * B * H, n_kv = (S + BN - 1) / BN;
    const int w = wg - 1;
    const int lane = threadIdx.x & 31;
    const int r = w * 64 + ((threadIdx.x / 32) & 3) * 16 + (lane >> 2);  // row in the tile
    const bool leader = (threadIdx.x & 127) == 0;  // arrives for its warpgroup
    // descriptors of slot 0's tiles: Q and dO (this warpgroup's rows), K
    // and V K-major, K MN-major; a slot adds its offset / 16
    const uint64_t q_base = smem_desc(smem_addr(sfix) + w * 64 * kRowBytes, 16);
    const uint64_t do_base = q_base + L::kMTile / 16;
    const uint64_t k_base = smem_desc(smem_addr(sring), 16);
    const uint64_t v_base = k_base + L::kNTile / 16;
    const uint64_t kt_base = smem_desc(smem_addr(sring), BN * kRowBytes);
    const bool ragged = S % BN != 0;
    using Buf0 = std::integral_constant<int, 0>;
    using Buf1 = std::integral_constant<int, 1>;
    using More = std::true_type;
    using Last = std::false_type;

    int stage = 0, phase = 0, count = 0;  // the ring slot of the next key tile
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++count) {
      const int m_block = tile % n_m, bh = tile / n_m;
      const int fs = count % FIXED;
      const int row0 = m_block * BM + r, row1 = row0 + 8;
      const float* lrow = lse + (long long)bh * T;
      const float l2[2] = {row0 < T ? lrow[row0] * kLog2e : 0.f,
                           row1 < T ? lrow[row1] * kLog2e : 0.f};
      mbar_wait(fix_full + fs, (count / FIXED) & 1);
      const unsigned char* fix = sfix + fs * L::kFixedBytes;
      float ds[2];  // Dsum of rows row0, row1
      rowsum_do_o<DP, BM>(ds, fix + L::kMTile, fix + 2 * L::kMTile, r);
      if ((lane & 3) == 0) {
        float* drow = dsum + (long long)bh * T;
        if (row0 < T) drow[row0] = ds[0];
        if (row1 < T) drow[row1] = ds[1];
      }
      const uint64_t q_desc = q_base + fs * (L::kFixedBytes / 16);
      const uint64_t do_desc = do_base + fs * (L::kFixedBytes / 16);

      // two buffers of S and dP: one key tile's pointwise work runs while
      // the next tile's products fill the other
      float s[2][BN / 2], dp[2][BN / 2], acc[DV / 2];
      uint32_t dsa[BN / 16][4];
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
      // the zeros are written here, before any product is in flight: an
      // instruction that writes a product's accumulator while another is
      // in flight makes ptxas serialise every wgmma (C7515)
      fence_regs(acc);

      // S and dP of the key tile in ring slot `st` into buffer `buf`
      auto issue_scores = [&](auto buf, int st) {
        constexpr int kBuf = decltype(buf)::value;
        fence_regs(s[kBuf]);
        fence_regs(dp[kBuf]);
        wgmma_fence();
        const uint64_t off = st * (L::kStageBytes / 16);
        product_ss<DP, BM, BN>(s[kBuf], q_desc, k_base + off);
        product_ss<DP, BM, BN>(dp[kBuf], do_desc, v_base + off);
        wgmma_commit();
        fence_regs(s[kBuf]);
        fence_regs(dp[kBuf]);
      };
      // key tile j, its scores done in buffer `buf`: tile j + 1's scores go
      // to the other buffer first, tile j's pointwise work runs under them
      // (and under tile j - 1's dQ product), then, all products done and
      // tile j - 1's ring slot released, tile j's dQ += dS K is issued
      int prev = stage;
      // kMore: tile j + 1 exists.  The issue of its scores is never a
      // branch inside a step: a product issued on one path only makes ptxas
      // serialise every wgmma (C7515), so the last step is an instance of
      // its own, and only it masks a ragged key tile
      auto step = [&](auto buf, auto more, int j) {
        constexpr int kBuf = decltype(buf)::value;
        constexpr bool kMore = decltype(more)::value;
        using Next = std::integral_constant<int, 1 - kBuf>;
        int next = stage + 1, next_phase = phase;
        if (next == STAGES) {
          next = 0;
          next_phase ^= 1;
        }
        if constexpr (kMore) {
          mbar_wait(ring_full + next, next_phase);
          issue_scores(Next(), next);
          dq_pointwise<BN, false>(s[kBuf], dp[kBuf], l2, ds, j * BN, S, c);
        } else if (ragged) {
          dq_pointwise<BN, true>(s[kBuf], dp[kBuf], l2, ds, j * BN, S, c);
        } else {
          dq_pointwise<BN, false>(s[kBuf], dp[kBuf], l2, ds, j * BN, S, c);
        }
        // tile j - 1's dQ product and tile j + 1's scores: no product may
        // be in flight while dS is packed for the next one, or ptxas
        // serialises every wgmma (C7513)
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(dsa);
        fence_regs(s[1 - kBuf]);
        fence_regs(dp[1 - kBuf]);
        if (j > 0 && leader) mbar_arrive(ring_empty + prev);
        pack_a<BN>(dsa, dp[kBuf]);
        wgmma_fence();
        product_rs<BN, DV>(acc, dsa, kt_base + stage * (L::kStageBytes / 16));
        wgmma_commit();
        fence_regs(acc);
        fence_regs(dsa);
        prev = stage;
        stage = next;
        phase = next_phase;
      };

      mbar_wait(ring_full + stage, phase);
      issue_scores(Buf0(), stage);
      wgmma_wait<0>();
      fence_regs(s[0]);
      fence_regs(dp[0]);
      int j = 0;
      for (; j + 2 < n_kv; j += 2) {
        step(Buf0(), More(), j);
        step(Buf1(), More(), j + 1);
      }
      if (j + 2 == n_kv) {
        step(Buf0(), More(), j);
        step(Buf1(), Last(), j + 1);
      } else {
        step(Buf0(), Last(), j);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (leader) {
        mbar_arrive(ring_empty + prev);
        mbar_arrive(fix_empty + fs);
      }
      const int b = bh / H, h = bh - b * H;
      store_rows<DV>(dq + b * sq.b + h * sq.h, sq.t, acc, row0, T, D, scale);
    }
  }
}

// --------------------------------------------------------------- dkv ----

// The pointwise work of one query tile in place: s (S^T, keys x queries)
// becomes P^T = 2^(s c - l2), dp (dP^T, started at -Dsum) becomes dS^T =
// P^T o dP^T; `l2` holds the tile's lse * log2 e by query
template <int BN>
__device__ __forceinline__ void dkv_pointwise(float (&s)[BN / 2], float (&dp)[BN / 2],
                                              const float* l2, float c) {
  const int tg = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const float2 l = *reinterpret_cast<const float2*>(l2 + i * 8 + tg * 2);
    s[4 * i] = ex2(fmaf(s[4 * i], c, -l.x));
    s[4 * i + 1] = ex2(fmaf(s[4 * i + 1], c, -l.y));
    s[4 * i + 2] = ex2(fmaf(s[4 * i + 2], c, -l.x));
    s[4 * i + 3] = ex2(fmaf(s[4 * i + 3], c, -l.y));
#pragma unroll
    for (int e = 0; e < 4; ++e) dp[4 * i + e] *= s[4 * i + e];
  }
}

template <int DP, int DV>
__global__ void __launch_bounds__(DkvShape<DP>::kThreads, DkvShape<DP>::kMinBlocks)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_do, const float* __restrict__ lse,
                     const float* __restrict__ dsum, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, OutStrides sk, OutStrides sv, int B, int H, int T,
                     int S, int D, float c, float scale) {
  using L = DkvShape<DP>;
  constexpr int BM = L::kBlockM, BN = L::kBlockN, STAGES = L::kStages, FIXED = L::kFixed;
  constexpr int CONSUMERS = L::kConsumers, CH = L::kChunks;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sfix = smem;                            // slot i: K, V
  unsigned char* sring = smem + FIXED * L::kFixedBytes;  // slot i: Q, dO
  float* stats = reinterpret_cast<float*>(smem + L::kStatsOffset);  // slot i: lse * log2e, Dsum
  uint64_t* fix_full = reinterpret_cast<uint64_t*>(smem + L::kBarrierOffset);
  uint64_t* fix_empty = fix_full + FIXED;
  uint64_t* ring_full = fix_empty + FIXED;
  uint64_t* ring_empty = ring_full + STAGES;
  // a ring slot is full after the TMA bytes, the producer's expect_tx and
  // its 32 lanes' copies of lse and Dsum
  init_block(smem, L::kBarrierOffset, fix_full, FIXED, STAGES, 33, CONSUMERS);
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(L::kProducerRegs));
    const int n_m = (S + BM - 1) / BM, n_tiles = n_m * B * H, n_q = (T + BN - 1) / BN;
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        tma_prefetch_map(&map_q);
        tma_prefetch_map(&map_k);
        tma_prefetch_map(&map_v);
        tma_prefetch_map(&map_do);
      }
      const int row_bytes = CH * box_cols(CH, D) * 2;
      const uint32_t fix_bytes = 2 * row_bytes * box_rows(BM, S);
      const uint32_t q_bytes = 2 * row_bytes * box_rows(BN, T);
      int stage = 0, phase = 0, count = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++count) {
        const int m_block = tile % n_m, bh = tile / n_m;
        const int b = bh / H, h = bh - b * H;
        const int fs = count % FIXED;
        if (lane == 0) {
          unsigned char* fix = sfix + fs * L::kFixedBytes;
          mbar_wait(fix_empty + fs, ((count / FIXED) & 1) ^ 1);
          mbar_expect_tx(fix_full + fs, fix_bytes);
          tma_tile<BM, CH>(fix, &map_k, fix_full + fs, m_block * BM, h, b);
          tma_tile<BM, CH>(fix + L::kMTile, &map_v, fix_full + fs, m_block * BM, h, b);
        }
        // a query tile's lse and Dsum are read one tile ahead, so that their
        // loads run while the warp waits for the slot they go to
        const float* lrow = lse + (long long)bh * T;
        const float* drow = dsum + (long long)bh * T;
        constexpr int PER_LANE = (BN + 31) / 32;
        float l2[PER_LANE], ds[PER_LANE];
        auto fetch = [&](int j) {
#pragma unroll
          for (int p = 0; p < PER_LANE; ++p) {
            const int row = j * BN + lane + 32 * p;
            const bool in = lane + 32 * p < BN && row < T;
            l2[p] = in ? lrow[row] * kLog2e : 0.f;
            ds[p] = in ? drow[row] : 0.f;
          }
        };
        fetch(0);
        for (int j = 0; j < n_q; ++j) {
          mbar_wait(ring_empty + stage, phase ^ 1);
          if (lane == 0) {
            unsigned char* slot = sring + stage * L::kStageBytes;
            mbar_expect_tx(ring_full + stage, q_bytes);
            tma_tile<BN, CH>(slot, &map_q, ring_full + stage, j * BN, h, b);
            tma_tile<BN, CH>(slot + L::kNTile, &map_do, ring_full + stage, j * BN, h, b);
          }
          float* st = stats + stage * 2 * BN;
#pragma unroll
          for (int p = 0; p < PER_LANE; ++p) {
            if (lane + 32 * p < BN) {
              st[lane + 32 * p] = l2[p];
              st[BN + lane + 32 * p] = ds[p];
            }
          }
          mbar_arrive(ring_full + stage);
          if (j + 1 < n_q) fetch(j + 1);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(L::kConsumerRegs));
    const int n_m = (S + BM - 1) / BM, n_tiles = n_m * B * H, n_q = (T + BN - 1) / BN;
    const int w = wg - 1;
    const int lane = threadIdx.x & 31;
    const int r = w * 64 + ((threadIdx.x / 32) & 3) * 16 + (lane >> 2);  // key row in the tile
    const int tg = lane & 3;
    const bool leader = (threadIdx.x & 127) == 0;
    // descriptors of slot 0's tiles: K and V (this warpgroup's rows), Q and
    // dO K-major and MN-major; a slot adds its offset / 16
    const uint64_t k_base = smem_desc(smem_addr(sfix) + w * 64 * kRowBytes, 16);
    const uint64_t v_base = k_base + L::kMTile / 16;
    const uint64_t q_base = smem_desc(smem_addr(sring), 16);
    const uint64_t do_base = q_base + L::kNTile / 16;
    const uint64_t qt_base = smem_desc(smem_addr(sring), BN * kRowBytes);
    const uint64_t dot_base = qt_base + L::kNTile / 16;
    // warpgroup 0 takes the first turn
    if (CONSUMERS > 1 && w == CONSUMERS - 1) asm volatile("bar.arrive 1, 256;\n" ::: "memory");

    int stage = 0, phase = 0, count = 0;  // the ring slot of the next query tile
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++count) {
      const int m_block = tile % n_m, bh = tile / n_m;
      const bool last_tile = tile + (int)gridDim.x >= n_tiles;
      const int fs = count % FIXED;
      const uint64_t k_desc = k_base + fs * (L::kFixedBytes / 16);
      const uint64_t v_desc = v_base + fs * (L::kFixedBytes / 16);

      float s[BN / 2], dp[BN / 2], dk_acc[DV / 2], dv_acc[DV / 2];
      uint32_t pa[BN / 16][4], dsa[BN / 16][4];
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
      // the zeros are written before any product is in flight (see dq)
      fence_regs(dk_acc);
      fence_regs(dv_acc);

      // S^T and dP^T of the query tile in ring slot `st`, dP^T started at
      // -Dsum (nothing is in flight when the start is written)
      auto issue_scores = [&](int st) {
        const float* dsm = stats + st * 2 * BN + BN;
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
          const float2 d = *reinterpret_cast<const float2*>(dsm + i * 8 + tg * 2);
          dp[4 * i] = dp[4 * i + 2] = -d.x;
          dp[4 * i + 1] = dp[4 * i + 3] = -d.y;
        }
        fence_regs(s);
        fence_regs(dp);
        wgmma_fence();
        const uint64_t off = st * (L::kStageBytes / 16);
        product_ss<DP, BM, BN>(s, k_desc, q_base + off);
        product_ss<DP, BM, BN>(dp, v_desc, do_base + off, true);
        wgmma_commit();
        fence_regs(s);
        fence_regs(dp);
      };
      // dV += P^T dO and dK += dS^T Q with dO and Q of ring slot `st`
      auto issue_grads = [&](int st) {
        fence_regs(dv_acc);
        fence_regs(dk_acc);
        fence_regs(pa);
        fence_regs(dsa);
        wgmma_fence();
        const uint64_t off = st * (L::kStageBytes / 16);
        product_rs<BN, DV>(dv_acc, pa, dot_base + off);
        product_rs<BN, DV>(dk_acc, dsa, qt_base + off);
        wgmma_commit();
        fence_regs(dv_acc);
        fence_regs(dk_acc);
        fence_regs(pa);
        fence_regs(dsa);
      };
      // the last turn of the block's last tile is not passed on: warpgroup
      // 0's barrier got one arrival ahead at the start
      auto pass = [&](bool last_turn) {
        if (!(w == CONSUMERS - 1 && last_tile && last_turn)) turn_pass<CONSUMERS>(w);
      };
      auto advance = [&]() {
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      };

      mbar_wait(fix_full + fs, (count / FIXED) & 1);
      // query tile 0: its scores alone
      mbar_wait(ring_full + stage, phase);
      turn_wait<CONSUMERS>(w);
      issue_scores(stage);
      pass(false);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      dkv_pointwise<BN>(s, dp, stats + stage * 2 * BN, c);
      pack_a<BN>(pa, s);
      pack_a<BN>(dsa, dp);
      int prev = stage;
      advance();
      // query tiles 1 ..: tile j's scores in flight with tile j - 1's
      // gradient products; tile j's pointwise work under the latter
      for (int j = 1; j < n_q; ++j) {
        mbar_wait(ring_full + stage, phase);
        turn_wait<CONSUMERS>(w);
        issue_scores(stage);
        issue_grads(prev);
        pass(false);
        wgmma_wait<1>();  // the scores; the gradient products may still run
        fence_regs(s);
        fence_regs(dp);
        dkv_pointwise<BN>(s, dp, stats + stage * 2 * BN, c);
        wgmma_wait<0>();
        fence_regs(dv_acc);
        fence_regs(dk_acc);
        fence_regs(pa);
        fence_regs(dsa);
        if (leader) mbar_arrive(ring_empty + prev);
        pack_a<BN>(pa, s);
        pack_a<BN>(dsa, dp);
        prev = stage;
        advance();
      }
      turn_wait<CONSUMERS>(w);
      issue_grads(prev);
      pass(true);
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      if (leader) {
        mbar_arrive(ring_empty + prev);
        mbar_arrive(fix_empty + fs);
      }
      const int b = bh / H, h = bh - b * H;
      const int row0 = m_block * BM + r;
      store_rows<DV>(dk + b * sk.b + h * sk.h, sk.t, dk_acc, row0, S, D, scale);
      store_rows<DV>(dv + b * sv.b + h * sv.h, sv.t, dv_acc, row0, S, D, 1.f);
    }
  }
}

// ------------------------------------------------------------ launch ----

template <int DP, int DV>
int launch_dq(int B, int H, int T, int S, int D, const void* q, const void* k, const void* v,
              const void* o, const void* dout, const void* lse, void* dq, void* dsum,
              const long long* st, float scale, cudaStream_t stream) {
  using L = DqShape<DP>;
  static std::atomic<bool> smem_set[flash::kMaxDevices];
  static std::atomic<int> per_sm[flash::kMaxDevices];
  const long long tiles = (long long)((T + L::kBlockM - 1) / L::kBlockM) * B * H;
  unsigned grid = 0;
  int err = flash::persistent_grid(flash_bwd_dq_kernel<DP, DV>, L::kThreads, L::kSmemBytes,
                                   tiles, smem_set, per_sm, &grid);
  if (err != 0) return err;
  CUtensorMap maps[5];
  const int m_rows = box_rows(L::kBlockM, T), n_rows = box_rows(L::kBlockN, S);
  const int cols = box_cols(L::kChunks, D);
  if ((err = flash::encode_map(&maps[0], q, B, T, H, D, st, m_rows, cols)) != 0 ||
      (err = flash::encode_map(&maps[1], k, B, S, H, D, st + 3, n_rows, cols)) != 0 ||
      (err = flash::encode_map(&maps[2], v, B, S, H, D, st + 6, n_rows, cols)) != 0 ||
      (err = flash::encode_map(&maps[3], o, B, T, H, D, st + 9, m_rows, cols)) != 0 ||
      (err = flash::encode_map(&maps[4], dout, B, T, H, D, st + 12, m_rows, cols)) != 0) {
    return err;
  }
  const OutStrides sq = {st[15], st[16], st[17]};
  flash_bwd_dq_kernel<DP, DV><<<grid, L::kThreads, L::kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], static_cast<const float*>(lse),
      static_cast<bf16*>(dq), static_cast<float*>(dsum), sq, B, H, T, S, D,
      scale * kLog2e, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DP, int DV>
int launch_dkv(int B, int H, int T, int S, int D, const void* q, const void* k, const void* v,
               const void* dout, const void* lse, const void* dsum, void* dk, void* dv,
               const long long* st, float scale, cudaStream_t stream) {
  using L = DkvShape<DP>;
  static std::atomic<bool> smem_set[flash::kMaxDevices];
  static std::atomic<int> per_sm[flash::kMaxDevices];
  const long long tiles = (long long)((S + L::kBlockM - 1) / L::kBlockM) * B * H;
  unsigned grid = 0;
  int err = flash::persistent_grid(flash_bwd_dkv_kernel<DP, DV>, L::kThreads, L::kSmemBytes,
                                   tiles, smem_set, per_sm, &grid);
  if (err != 0) return err;
  CUtensorMap maps[4];
  const int m_rows = box_rows(L::kBlockM, S), n_rows = box_rows(L::kBlockN, T);
  const int cols = box_cols(L::kChunks, D);
  if ((err = flash::encode_map(&maps[0], q, B, T, H, D, st, n_rows, cols)) != 0 ||
      (err = flash::encode_map(&maps[1], k, B, S, H, D, st + 3, m_rows, cols)) != 0 ||
      (err = flash::encode_map(&maps[2], v, B, S, H, D, st + 6, m_rows, cols)) != 0 ||
      (err = flash::encode_map(&maps[3], dout, B, T, H, D, st + 9, n_rows, cols)) != 0) {
    return err;
  }
  const OutStrides sk = {st[12], st[13], st[14]}, sv = {st[15], st[16], st[17]};
  flash_bwd_dkv_kernel<DP, DV><<<grid, L::kThreads, L::kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(dsum), static_cast<bf16*>(dk), static_cast<bf16*>(dv), sk, sv,
      B, H, T, S, D, scale * kLog2e, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o, dout, dq: bf16 [B, T, H, D]; k, v, dk, dv: bf16 [B, S, H, D]; unit
// stride along D.  q, k, v, o and dout must suit a tensor map: 16-byte
// aligned, D % 8 == 0 and their strides multiples of 8 elements (the
// wrapper stages anything else); the outputs need 4-byte alignment.  lse
// and dsum: f32 [B, H, T], contiguous.  `dp` picks the padded width (48,
// 80 or 160) and must be >= D.  Each returns the cudaError_t of its launch.
//
// dq: dQ, and Dsum = rowsum(dO o O) into `dsum`.  `strides` holds the
// (batch, token, head) element strides of q, k, v, o, dout and dq.
extern "C" int flash_attention_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                           const void* o, const void* dout, const void* lse,
                                           void* dq, void* dsum, int B, int H, int T, int S,
                                           int D, int dp, const long long* strides,
                                           float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dp) {
    case 48:
      return D <= 40 ? launch_dq<48, 40>(B, H, T, S, D, q, k, v, o, dout, lse, dq, dsum, strides,
                                         scale, s)
                     : launch_dq<48, 48>(B, H, T, S, D, q, k, v, o, dout, lse, dq, dsum, strides,
                                         scale, s);
    case 80:
      return launch_dq<80, 80>(B, H, T, S, D, q, k, v, o, dout, lse, dq, dsum, strides, scale, s);
    case 160:
      return launch_dq<160, 160>(B, H, T, S, D, q, k, v, o, dout, lse, dq, dsum, strides, scale,
                                 s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dkv: dK and dV from the Dsum that dq wrote.  `strides` holds the (batch,
// token, head) element strides of q, k, v, dout, dk and dv.
extern "C" int flash_attention_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse, const void* dsum,
                                            void* dk, void* dv, int B, int H, int T, int S,
                                            int D, int dp, const long long* strides,
                                            float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dp) {
    case 48:
      return D <= 40 ? launch_dkv<48, 40>(B, H, T, S, D, q, k, v, dout, lse, dsum, dk, dv,
                                          strides, scale, s)
                     : launch_dkv<48, 48>(B, H, T, S, D, q, k, v, dout, lse, dsum, dk, dv,
                                          strides, scale, s);
    case 80:
      return launch_dkv<80, 80>(B, H, T, S, D, q, k, v, dout, lse, dsum, dk, dv, strides, scale,
                                s);
    case 160:
      return launch_dkv<160, 160>(B, H, T, S, D, q, k, v, dout, lse, dsum, dk, dv, strides,
                                  scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
