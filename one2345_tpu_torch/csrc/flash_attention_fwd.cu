// Flash-attention forward for Hopper (sm_90a), bf16 in, f32 accumulation.
//
// Replaces the Pallas TPU kernel `_flash_fwd_kernel`
// (one2345_tpu/ops/flash_attention.py:36-68, launched by `_fwd_impl`):
//   O = softmax(Q K^T / sqrt(D)) V   and   lse = log(sum_j exp(q.k_j / sqrt(D)))
// per query row, with an online softmax over key tiles so that no [T, S]
// score matrix reaches device memory.
//
// Where it runs: every multi-token self-attention of the Zero123 UNet
// (16 launches per UNet eval): level 0 T=S=1024 D=40, level 1 T=S=256
// D=80, level 2 T=S=64 D=160, middle T=S=16 D=160; 8 heads; B = 8 or 56.
//
// Bound on an H100 SXM, the largest of three terms.  At level 0, B=56:
// - tensor cores: 4*B*H*T*S*D = 75 GFLOP at 989 TFLOP/s -> 76 us;
// - bytes: Q, K, V, O (147 MB) and lse (1.8 MB) at 3.35 TB/s -> 44 us;
// - exp unit: one exp2 per score, B*H*T*S = 470 M, at 16 per clock per SM
//   (CUDA C++ Programming Guide, throughput table, compute capability 9.0)
//   x 132 SMs x 1.98 GHz = 4.2e12/s -> 112 us.
// So at D=40 the exp unit is the floor and the tensor cores come next: a
// kernel near the bound runs the products and the exps at the same time.
//
// What the previous design (cp.async ring, ldmatrix, mma.sync m16n8k16)
// did instead, read from its SASS (PERF.md): mma.sync is synchronous in
// the warp that issues it, so each warp ran a key tile's Q K^T (a run of
// 48 HMMA with no exp beside it), waited on it for the row max, and only
// then interleaved its exps with the P V HMMAs; with two warps per
// scheduler little filled the Q K^T phase, and level 0 cost about the sum
// of the two floors.
//
// Design:
// - warp specialisation: warpgroup 0 is the producer (setmaxnreg down to
//   24 registers; one thread issues every copy), the others are consumers
//   of 64 query rows each (setmaxnreg up): three at DP = 48 (192-row query
//   tiles, 160 registers), two at 80 (128 rows, 240), one at 160 (64 rows,
//   232; two blocks per SM);
// - the producer moves every operand with TMA (cp.async.bulk.tensor, 4-D
//   tensor maps over the [B, T|S, H, D] strides, 128-byte swizzle; the host
//   encodes the maps per call with cuTensorMapEncodeTiled, reached through
//   cudaGetDriverEntryPoint): Q into two slots (the next query tile's Q
//   loads under this one), K and V through rings of STAGES slots, each slot
//   guarded by a full and an empty mbarrier (the full one counts TMA bytes,
//   the empty one an arrival per consumer warpgroup).  A box brings 64
//   columns, or D rounded up to 8 when one 64-column chunk holds the row,
//   and the tile's rows, or the sequence's rounded up to 8 when it is
//   shorter: the TMA unit spends its time on the box, filled or not, so
//   the narrower boxes made every main-path shape faster (PERF.md).  Rows
//   past T or S inside a box are zero-filled; shared memory is zeroed once,
//   so pad columns D .. DP stay zero and V rows past a short S are finite;
// - S = Q K^T is wgmma m64nBNk16 with both operands in swizzled shared
//   memory (K-major); O += P V is wgmma m64nDVk16 with P in registers (the
//   score accumulator re-packed to bf16) and V from shared memory as a
//   transposed (MN-major) operand, DV = D rounded up to 8 (40 at level 0);
//   descriptors are built once and stepped by adding offsets;
// - overlap: a consumer issues tile j's Q K^T and tile j-1's P V together
//   and waits only for the first (wgmma.wait_group 1), so tile j's softmax
//   runs on the FP32 and exp units while P V runs on the tensor cores; the
//   consumer warpgroups take turns issuing their products (named barriers
//   1 .. 3, in a ring), so one's softmax runs under another's products;
// - bit for bit the previous kernel: the softmax moves in steps of 64 keys
//   (two per 128-key tile, each with its own max, rescale and P V, the
//   second P V issued under the second step's exps) and sums p in the
//   previous order; mma.sync and wgmma accumulate alike, so O and lse equal
//   the mma.sync kernel's at every shape, and the sampled images, meshes
//   and every check downstream of them are unchanged (a 128-key step is
//   faster and rounds otherwise: PERF.md);
// - persistent blocks: the blocks that fit on the SMs walk the query tiles
//   (tile = blockIdx.x, += gridDim.x; consecutive tiles share K and V in
//   L2), so the producer loads the next tile's Q, K and V under the
//   current tile's last products and epilogue;
// - softmax at the exp floor (as before): the running max stays in raw
//   score units and p = 2^(s*c - m*c), c = log2(e)/sqrt(D), is one FFMA and
//   one ex2.approx per score; O is rescaled once per step just before its
//   P V is issued; keys >= S are masked only in a ragged last tile;
// - O leaves registers as bf16 pairs through its [B, T, H, D] strides, lse
//   as f32 [B, H, T].
// Inputs a tensor map cannot describe (a base not 16-byte aligned, a
// stride not a multiple of 8 elements, D % 8 != 0) are staged into an
// aligned copy by the wrapper (ops/flash_attention.py) before the launch.
// Measured against that design (PERF.md): level 0 runs the exp unit at
// under half its rate; with no copies at all the consumers alone take most
// of the time, so what is left is the softmax's own latency between the
// turns, not the copies or the tensor cores.

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
using flash::pack_bf16;
using flash::smem_addr;
using flash::smem_desc;
using flash::tma_load;
using flash::tma_prefetch_map;
using flash::turn_pass;
using flash::turn_wait;
using flash::wgmma_commit;
using flash::wgmma_fence;
using flash::wgmma_rs;
using flash::wgmma_ss;
using flash::wgmma_wait;
typedef __nv_bfloat16 bf16;

// Shape of each instance: DP the padded head width of Q K^T (a multiple of
// 16), BN keys per K/V tile, CONSUMERS warpgroups of 64 query rows, STAGES
// slots in each of the K and V rings
template <int DP>
struct Config;
template <>
struct Config<48> {
  static constexpr int kBlockN = 128, kConsumers = 3, kStages = 3;
};
template <>
struct Config<80> {
  static constexpr int kBlockN = 128, kConsumers = 2, kStages = 2;
};
template <>
struct Config<160> {
  static constexpr int kBlockN = 64, kConsumers = 1, kStages = 1;
};

template <int DP>
struct Shape {
  static constexpr int kBlockN = Config<DP>::kBlockN;
  static constexpr int kConsumers = Config<DP>::kConsumers;
  static constexpr int kStages = Config<DP>::kStages;
  static constexpr int kBlockM = 64 * kConsumers;
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kChunks = (DP + kChunkCols - 1) / kChunkCols;
  static constexpr int kQBytes = kChunks * kBlockM * kRowBytes;
  static constexpr int kKVBytes = kChunks * kBlockN * kRowBytes;  // one K or V tile
  // blocks per SM the entry register count must allow (65536 / threads /
  // blocks: 128 at 512 or 256 threads, 168 at 384), and the registers
  // setmaxnreg leaves the producer and gives a consumer thread: together
  // they must fit the block's entry allocation (168 x 384 = 24 x 128 + 240
  // x 256; 128 x 512 >= 24 x 128 + 160 x 384; 128 x 256 = 24 x 128 + 232 x
  // 128), or the consumers' setmaxnreg.inc would wait forever
  static constexpr int kMinBlocks = kConsumers == 1 ? 2 : 1;
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = kConsumers == 3 ? 160 : kConsumers == 2 ? 240 : 232;
  static constexpr int kEntryRegs = (65536 / (kThreads * kMinBlocks)) / 8 * 8;
  static_assert(128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <= kEntryRegs * kThreads,
                "setmaxnreg asks for more registers than the block holds");
  // two Q slots (the next query tile loads under this one), the K ring,
  // the V ring, then the mbarriers; 1 KB to align the base
  static constexpr int kBarrierOffset = 2 * kQBytes + 2 * kStages * kKVBytes;
  static constexpr int kSmemBytes = kBarrierOffset + (4 + 4 * kStages) * 8 + 1024;
};

// ------------------------------------------------------- consumer pieces

// S = Q K^T over DP / 16 k-steps: chunk k / 4 of both operands, 32 bytes
// further along the swizzled row per step.  q_desc and k_desc describe the
// tiles' first rows; an offset below 256 KB adds to the start-address field
template <int DP>
__device__ __forceinline__ void issue_qk(float (&s)[Shape<DP>::kBlockN / 2], uint64_t q_desc,
                                         uint64_t k_desc) {
  constexpr int BM = Shape<DP>::kBlockM, BN = Shape<DP>::kBlockN;
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < DP / 16; ++k) {
    const uint64_t step = (k % 4) * 2;  // 32 bytes
    wgmma_ss<BN>(s, q_desc + (k / 4) * (BM * kRowBytes / 16) + step,
                 k_desc + (k / 4) * (BN * kRowBytes / 16) + step, k > 0);
  }
  wgmma_commit();
  fence_regs(s);
}

// O += P V over the 64 keys of step H of a key tile: k-steps 4 H .. 4 H + 3
// of 16 keys (2048 bytes of V each)
template <int H, int DP, int DV>
__device__ __forceinline__ void issue_pv(float (&o)[DV / 2], uint32_t (&p)[Shape<DP>::kBlockN / 16][4],
                                         uint64_t v_desc) {
  fence_regs(o);
  fence_regs(p);
  wgmma_fence();
#pragma unroll
  for (int kk = 4 * H; kk < 4 * H + 4; ++kk) {
    wgmma_rs<DV>(o, p[kk], v_desc + kk * (16 * kRowBytes / 16));
  }
  wgmma_commit();
  fence_regs(o);
  fence_regs(p);
}

// max of the 2 N values of one accumulator row held from n-tile I on:
// s[4 i + R] and s[4 i + R + 1] for I <= i < I + N, R = 0 (row g) or 2 (row
// g + 8), as a tree (a max is exact in any order)
template <int N, int I, int R, int M>
__device__ __forceinline__ float tree_max(const float (&s)[M]) {
  if constexpr (N == 1) {
    return fmaxf(s[4 * I + R], s[4 * I + R + 1]);
  } else {
    return fmaxf(tree_max<N / 2, I, R>(s), tree_max<N / 2, I + N / 2, R>(s));
  }
}

// The online softmax of the 64 keys of step H of a score tile, in place:
// they become p = 2^(s c - m c) with the new running max m (raw score
// units); `scale` gets the factor 2^((m_old - m) c) that O must take before
// this step's P V, and l (each thread's partial row sums) is rescaled and
// grows by the step's p, one n-tile after another.  The steps of 64 keys,
// the order of the sums and the FFMA + ex2 per score are those of the
// mma.sync kernel this one replaced, whose outputs it reproduces bit for
// bit.  kMask masks keys >= S (a ragged last tile).  Accumulator layout:
// n-tile i holds row g in s[4i], s[4i + 1] and row g + 8 in s[4i + 2],
// s[4i + 3], columns 8i + 2 (lane % 4) and + 1.
template <int H, int BN, bool kMask>
__device__ __forceinline__ void softmax_step(float (&s)[BN / 2], float (&m)[2], float (&l)[2],
                                             float (&scale)[2], int kv0, int S, float c) {
  constexpr int I0 = 8 * H;  // the step's first n-tile
  const int tg = threadIdx.x & 3;
  if (kMask) {
#pragma unroll
    for (int i = I0; i < I0 + 8; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (kv0 + i * 8 + tg * 2 + j >= S) s[4 * i + j] = s[4 * i + 2 + j] = -CUDART_INF_F;
      }
    }
  }
  float mx0 = fmaxf(m[0], tree_max<8, I0, 0>(s));
  float mx1 = fmaxf(m[1], tree_max<8, I0, 2>(s));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  // the first step holds a key < S, so mx is finite; 2^(-inf) = 0 on the
  // first; a later step of a ragged tile may hold none (p = 0, scale = 1)
  scale[0] = ex2((m[0] - mx0) * c);
  scale[1] = ex2((m[1] - mx1) * c);
  m[0] = mx0;
  m[1] = mx1;
  l[0] *= scale[0];
  l[1] *= scale[1];
  const float mc0 = mx0 * c, mc1 = mx1 * c;
#pragma unroll
  for (int i = I0; i < I0 + 8; ++i) {
    s[4 * i] = ex2(fmaf(s[4 * i], c, -mc0));
    s[4 * i + 1] = ex2(fmaf(s[4 * i + 1], c, -mc0));
    s[4 * i + 2] = ex2(fmaf(s[4 * i + 2], c, -mc1));
    s[4 * i + 3] = ex2(fmaf(s[4 * i + 3], c, -mc1));
    l[0] += s[4 * i] + s[4 * i + 1];
    l[1] += s[4 * i + 2] + s[4 * i + 3];
  }
}

// step H's p as the A fragments of P V: k-step kk (keys 16 kk .. 16 kk +
// 15) is n-tiles 2 kk and 2 kk + 1 of the score accumulator
template <int H, int BN>
__device__ __forceinline__ void pack_p(uint32_t (&p)[BN / 16][4], const float (&s)[BN / 2]) {
#pragma unroll
  for (int kk = 4 * H; kk < 4 * H + 4; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) p[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
  }
}

template <int DV>
__device__ __forceinline__ void rescale(float (&o)[DV / 2], const float (&scale)[2]) {
#pragma unroll
  for (int i = 0; i < DV / 8; ++i) {
    o[4 * i] *= scale[0];
    o[4 * i + 1] *= scale[0];
    o[4 * i + 2] *= scale[1];
    o[4 * i + 3] *= scale[1];
  }
}

// (batch, token, head) element strides of o
struct OutStrides {
  long long b, t, h;
};

template <int DP, int DV>
__global__ void __launch_bounds__(Shape<DP>::kThreads, Shape<DP>::kMinBlocks)
flash_fwd_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ o,
                 float* __restrict__ lse, OutStrides so, int B, int H, int T, int S, int D,
                 float c, float scale) {
  using Sh = Shape<DP>;
  constexpr int BM = Sh::kBlockM, BN = Sh::kBlockN, STAGES = Sh::kStages;
  constexpr int CONSUMERS = Sh::kConsumers;
  constexpr int STEPS = BN / 64;  // softmax steps of 64 keys per key tile
  using Step0 = std::integral_constant<int, 0>;
  using Step1 = std::integral_constant<int, STEPS - 1>;
  extern __shared__ unsigned char smem_raw[];
  // swizzled tiles want 1024-byte alignment
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sq = smem;                         // Q slot i at sq + i * kQBytes
  unsigned char* sk = sq + 2 * Sh::kQBytes;         // K slot i at sk + i * kKVBytes
  unsigned char* sv = sk + STAGES * Sh::kKVBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + Sh::kBarrierOffset);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + 2;
  uint64_t* k_full = bars + 4;
  uint64_t* k_empty = k_full + STAGES;
  uint64_t* v_full = k_empty + STAGES;
  uint64_t* v_empty = v_full + STAGES;

  // Boxes narrower or shorter than the tiles leave the rest of each tile as
  // it was: zero Q, K and V once, so that the pad columns D .. DP stay zero
  // and keys past S (P = 0) meet finite values in V
  for (int i = threadIdx.x; i < Sh::kBarrierOffset / 16; i += Sh::kThreads) {
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full + i, 1);
      mbar_init(q_empty + i, CONSUMERS);
    }
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(k_full + i, 1);
      mbar_init(k_empty + i, CONSUMERS);
      mbar_init(v_full + i, 1);
      mbar_init(v_empty + i, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n_m = (T + BM - 1) / BM;
  const int n_tiles = n_m * B * H;
  const int n_kv = (S + BN - 1) / BN;
  const int wg = threadIdx.x / 128;

  if (wg == 0) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(Sh::kProducerRegs));
    if (threadIdx.x == 0) {
      tma_prefetch_map(&map_q);
      tma_prefetch_map(&map_k);
      tma_prefetch_map(&map_v);
      // bytes each box completes on its barrier
      const int row_bytes = Sh::kChunks * box_cols(Sh::kChunks, D) * 2;
      const uint32_t q_bytes = row_bytes * box_rows(BM, T);
      const uint32_t kv_bytes = row_bytes * box_rows(BN, S);
      int stage = 0, phase = 0, q_count = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++q_count) {
        const int m_block = tile % n_m, bh = tile / n_m;
        const int b = bh / H, h = bh - b * H;
        const int qs = q_count & 1;  // Q slot; its round is q_count / 2
        mbar_wait(q_empty + qs, ((q_count >> 1) & 1) ^ 1);
        mbar_expect_tx(q_full + qs, q_bytes);
#pragma unroll
        for (int ch = 0; ch < Sh::kChunks; ++ch) {
          tma_load(sq + qs * Sh::kQBytes + ch * BM * kRowBytes, &map_q, q_full + qs,
                   ch * kChunkCols, m_block * BM, h, b);
        }
        for (int j = 0; j < n_kv; ++j) {
          mbar_wait(k_empty + stage, phase ^ 1);
          mbar_expect_tx(k_full + stage, kv_bytes);
#pragma unroll
          for (int ch = 0; ch < Sh::kChunks; ++ch) {
            tma_load(sk + stage * Sh::kKVBytes + ch * BN * kRowBytes, &map_k, k_full + stage,
                     ch * kChunkCols, j * BN, h, b);
          }
          mbar_wait(v_empty + stage, phase ^ 1);
          mbar_expect_tx(v_full + stage, kv_bytes);
#pragma unroll
          for (int ch = 0; ch < Sh::kChunks; ++ch) {
            tma_load(sv + stage * Sh::kKVBytes + ch * BN * kRowBytes, &map_v, v_full + stage,
                     ch * kChunkCols, j * BN, h, b);
          }
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(Sh::kConsumerRegs));
    const int w = wg - 1;                    // consumer index
    const int lane = threadIdx.x & 31;
    const int row_in_tile = w * 64 + ((threadIdx.x / 32) & 3) * 16 + (lane >> 2);
    const bool leader = (threadIdx.x & 127) == 0;  // arrives for its warpgroup
    // descriptors of the tiles' first rows; a slot adds its offset / 16
    const uint64_t q_base = smem_desc(smem_addr(sq) + w * 64 * kRowBytes, 16);
    const uint64_t k_base = smem_desc(smem_addr(sk), 16);
    const uint64_t v_base = smem_desc(smem_addr(sv), BN * kRowBytes);
    const bool ragged = S % BN != 0;
    // warpgroup 0 takes the first turn
    if (CONSUMERS > 1 && w == CONSUMERS - 1) asm volatile("bar.arrive 1, 256;\n" ::: "memory");

    int stage = 0, phase = 0, q_count = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++q_count) {
      const int m_block = tile % n_m, bh = tile / n_m;
      const bool last_tile = tile + (int)gridDim.x >= n_tiles;
      const int qs = q_count & 1;
      const uint64_t q_desc = q_base + qs * (Sh::kQBytes / 16);
      float s[BN / 2];
      uint32_t p[BN / 16][4];
      float o_acc[DV / 2];
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) o_acc[i] = 0.f;
      float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f}, sc[STEPS][2];

      // the softmax of step `step` (a std::integral_constant) of key tile j
      auto softmax = [&](auto step, int j) {
        constexpr int kStep = decltype(step)::value;
        if (ragged && j == n_kv - 1) {
          softmax_step<kStep, BN, true>(s, m, l, sc[kStep], j * BN, S, c);
        } else {
          softmax_step<kStep, BN, false>(s, m, l, sc[kStep], j * BN, S, c);
        }
      };
      // the last turn of the block's last tile is not passed on: warpgroup
      // 0's barrier got one arrival ahead at the start
      auto pass = [&](int j) {
        if (!(w == CONSUMERS - 1 && last_tile && j == n_kv - 1)) turn_pass<CONSUMERS>(w);
      };

      mbar_wait(q_full + qs, (q_count >> 1) & 1);
      // key tile 0: S alone
      mbar_wait(k_full + stage, phase);
      turn_wait<CONSUMERS>(w);
      issue_qk<DP>(s, q_desc, k_base + stage * (Sh::kKVBytes / 16));
      pass(0);
      wgmma_wait<0>();
      fence_regs(s);
      if (leader) {
        mbar_arrive(k_empty + stage);
        if (n_kv == 1) mbar_arrive(q_empty + qs);
      }
      softmax(Step0(), 0);
      pack_p<0, BN>(p, s);
      if constexpr (STEPS == 2) {
        softmax(Step1(), 0);
        pack_p<1, BN>(p, s);
      }
      int v_stage = stage, v_phase = phase;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
      // key tiles 1 ..: S of tile j in flight with P V of tile j - 1's first
      // step, then the second step's P V under tile j's second softmax step
      for (int j = 1; j < n_kv; ++j) {
        mbar_wait(k_full + stage, phase);
        turn_wait<CONSUMERS>(w);
        issue_qk<DP>(s, q_desc, k_base + stage * (Sh::kKVBytes / 16));
        rescale<DV>(o_acc, sc[0]);
        mbar_wait(v_full + v_stage, v_phase);
        const uint64_t v_desc = v_base + v_stage * (Sh::kKVBytes / 16);
        issue_pv<0, DP, DV>(o_acc, p, v_desc);
        pass(j);
        wgmma_wait<1>();  // S of tile j; P V may still run
        fence_regs(s);
        if (leader) {
          mbar_arrive(k_empty + stage);
          if (j == n_kv - 1) mbar_arrive(q_empty + qs);
        }
        softmax(Step0(), j);
        wgmma_wait<0>();
        fence_regs(o_acc);
        fence_regs(p);
        if constexpr (STEPS == 2) {
          rescale<DV>(o_acc, sc[1]);  // still tile j - 1's second factor
          issue_pv<1, DP, DV>(o_acc, p, v_desc);
          pack_p<0, BN>(p, s);  // the first step's P V is done with these
          softmax(Step1(), j);
          wgmma_wait<0>();
          fence_regs(o_acc);
          fence_regs(p);
        }
        if (leader) mbar_arrive(v_empty + v_stage);
        if constexpr (STEPS == 2) {
          pack_p<1, BN>(p, s);
        } else {
          pack_p<0, BN>(p, s);
        }
        v_stage = stage;
        v_phase = phase;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      // the last tile's P V
      rescale<DV>(o_acc, sc[0]);
      mbar_wait(v_full + v_stage, v_phase);
      const uint64_t v_desc = v_base + v_stage * (Sh::kKVBytes / 16);
      issue_pv<0, DP, DV>(o_acc, p, v_desc);
      wgmma_wait<0>();
      fence_regs(o_acc);
      if constexpr (STEPS == 2) {
        rescale<DV>(o_acc, sc[1]);
        issue_pv<1, DP, DV>(o_acc, p, v_desc);
        wgmma_wait<0>();
        fence_regs(o_acc);
      }
      if (leader) mbar_arrive(v_empty + v_stage);

      // epilogue: full row sums across the 4 threads of a row, O / l as
      // bf16 pairs, lse = m * scale + log(l)
      const int b = bh / H, h = bh - b * H;
      float l0 = l[0], l1 = l[1];
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float inv0 = 1.f / l0, inv1 = 1.f / l1;
      const int row0 = m_block * BM + row_in_tile, row1 = row0 + 8;
      bf16* ob = o + b * so.b + h * so.h;
      const int tg = lane & 3;
#pragma unroll
      for (int i = 0; i < DV / 8; ++i) {
        const int col = i * 8 + tg * 2;
        if (col < D) {
          if (row0 < T) {
            *reinterpret_cast<__nv_bfloat162*>(ob + row0 * so.t + col) =
                __floats2bfloat162_rn(o_acc[4 * i] * inv0, o_acc[4 * i + 1] * inv0);
          }
          if (row1 < T) {
            *reinterpret_cast<__nv_bfloat162*>(ob + row1 * so.t + col) =
                __floats2bfloat162_rn(o_acc[4 * i + 2] * inv1, o_acc[4 * i + 3] * inv1);
          }
        }
      }
      if (tg == 0) {
        float* lrow = lse + (long long)bh * T;
        if (row0 < T) lrow[row0] = m[0] * scale + logf(l0);
        if (row1 < T) lrow[row1] = m[1] * scale + logf(l1);
      }
    }
  }
}

template <int DP, int DV>
int launch(int B, int H, int T, int S, int D, const void* q, const void* k, const void* v,
           void* o, void* lse, const long long* st, float scale, cudaStream_t stream) {
  using Sh = Shape<DP>;
  static std::atomic<bool> smem_set[flash::kMaxDevices];
  static std::atomic<int> per_sm[flash::kMaxDevices];
  const long long tiles = (long long)((T + Sh::kBlockM - 1) / Sh::kBlockM) * B * H;
  unsigned grid = 0;
  int err = flash::persistent_grid(flash_fwd_kernel<DP, DV>, Sh::kThreads, Sh::kSmemBytes, tiles,
                                   smem_set, per_sm, &grid);
  if (err != 0) return err;
  CUtensorMap maps[3];
  const int q_rows = box_rows(Sh::kBlockM, T), kv_rows = box_rows(Sh::kBlockN, S);
  const int cols = box_cols(Sh::kChunks, D);
  if ((err = flash::encode_map(&maps[0], q, B, T, H, D, st, q_rows, cols)) != 0 ||
      (err = flash::encode_map(&maps[1], k, B, S, H, D, st + 3, kv_rows, cols)) != 0 ||
      (err = flash::encode_map(&maps[2], v, B, S, H, D, st + 6, kv_rows, cols)) != 0) {
    return err;
  }
  const OutStrides so = {st[9], st[10], st[11]};
  flash_fwd_kernel<DP, DV><<<grid, Sh::kThreads, Sh::kSmemBytes, stream>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(o), static_cast<float*>(lse), so, B, H, T, S,
      D, scale * kLog2e, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: bf16 [B, T|S, H, D] with unit stride along D; `strides` holds
// the (batch, token, head) element strides of q, k, v and o in that order.
// q, k and v must suit a tensor map: 16-byte aligned, D % 8 == 0 and their
// strides multiples of 8 (the wrapper stages anything else); o and lse
// (f32 [B, H, T], contiguous) need 4-byte alignment.  `dp` picks the padded
// width (48, 80 or 160) and must be >= D.  Returns the cudaError_t of the
// launch.
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k, const void* v,
                                        void* o, void* lse, int B, int H, int T, int S,
                                        int D, int dp, const long long* strides, float scale,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dp) {
    case 48:
      return D <= 40 ? launch<48, 40>(B, H, T, S, D, q, k, v, o, lse, strides, scale, s)
                     : launch<48, 48>(B, H, T, S, D, q, k, v, o, lse, strides, scale, s);
    case 80:
      return launch<80, 80>(B, H, T, S, D, q, k, v, o, lse, strides, scale, s);
    case 160:
      return launch<160, 160>(B, H, T, S, D, q, k, v, o, lse, strides, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
