// Flash-attention backward for Hopper (sm_90a): dQ, dK and dV, bf16 in and
// out, f32 accumulation.
//
// Replaces the Pallas TPU kernels `_flash_bwd_dq_kernel` and
// `_flash_bwd_dkv_kernel` (one2345_tpu/ops/flash_attention.py:71-132,
// launched by `_flash_folded_bwd`), the FlashAttention-2 backward:
//   P  = exp(Q K^T / sqrt(D) - lse)      (recomputed from the forward's lse)
//   dP = dO V^T,   dS = P o (dP - Dsum),   Dsum_i = rowsum(dO_i o O_i)
//   dQ = dS K / sqrt(D),   dK = dS^T Q / sqrt(D),   dV = P^T dO
// Dsum is one PyTorch reduction before the launches, as the JAX package
// computes it in XLA outside its kernels.  No [T, S] matrix reaches device
// memory.
//
// Where it runs: the backward of every multi-token self-attention of the
// Zero123 UNet under training (16 launches of each kernel per train step):
// level 0 T=S=1024 D=40, level 1 T=S=256 D=80, level 2 T=S=64 D=160,
// middle T=S=16 D=160; 8 heads; B = 8.
//
// Bound on an H100 SXM, the largest of three terms.  At level 0, B=8:
// - tensor cores: dq does 3 products, 6*B*H*T*S*D = 16.1 GFLOP, and dkv 4,
//   8*B*H*T*S*D = 21.5 GFLOP; at 989 TFLOP/s -> 16 and 22 us;
// - bytes: dq reads q, k, v, dO, lse, Dsum and writes dQ (27 MB), dkv
//   reads the same and writes dK, dV (32 MB); at 3.35 TB/s -> 8 and 10 us;
// - exp unit: one exp2 per score in each kernel, B*H*T*S = 67 M, at 16 per
//   clock per SM (CUDA C++ Programming Guide, compute capability 9.0) x 132
//   SMs x 1.98 GHz = 4.2e12/s -> 16 us.
// So both are bound by the tensor cores (dq only just, beside the exp
// unit); the smaller levels sit at their byte bound.  With D padded to 48
// the products do 1.2x the counted work.
//
// Design (K1's recipe, csrc/flash_attention_fwd.cu, on the helpers of
// flash_common.cuh):
// - two kernels and no atomics, so the gradients are deterministic: two
//   launches on the same inputs give bit-identical dQ, dK and dV;
// - each block owns a tile of one operand pair, fixed for its whole loop,
//   and streams the other pair through a ring of STAGES shared-memory
//   tiles filled with cp.async: tile t + STAGES - 1 is issued before tile
//   t's products, one __syncthreads per tile.
//   dkv: a block owns kRows keys of one (batch, head); K and V are its
//   fixed pair; Q, dO and the tile's lse and Dsum stream;
//   dq: a block owns kRows queries; Q and dO are fixed (with lse and Dsum
//   of its rows in registers); K and V stream;
// - each warp owns 16*MT rows.  The fixed pair's A fragments are read by
//   ldmatrix.x4, either once into registers for the whole loop (kRegs) or
//   from shared memory at every tile, where registers are short (D=160);
// - dkv computes the transposed products S^T = K Q^T and dP^T = V dO^T,
//   so P^T and dS^T come out with keys as rows and are re-packed in
//   registers as the A operands of dV += P^T dO and dK += dS^T Q; dq
//   computes S = Q K^T, dP = dO V^T, then dQ += dS K.  The B fragments of
//   K Q^T, V dO^T, Q K^T and dO V^T come from ldmatrix.x4 on the row-major
//   tiles, those of P^T dO, dS^T Q and dS K from ldmatrix.x4.trans; one
//   ldmatrix feeds two mma.sync m16n8k16 (bf16 in, f32 accumulate) per row
//   tile;
// - per score: the dP accumulator starts at -Dsum instead of 0, so
//   dS = P o dP is one multiply; P is one FFMA and one ex2.approx;
// - dkv needs no mask: queries >= T are zero-filled rows of Q and dO with
//   lse = Dsum = 0, so their P is exactly 1, their dS exactly 0, and they
//   add exactly 0 to dK and dV; keys >= S are rows whose outputs are not
//   stored.  dq masks keys >= S (P = 0: their P from lse could overflow)
//   only in a ragged last key tile, a separate instance of the tile body;
// - copies move 16 bytes (cp.async.cg) when D is a multiple of 8 and every
//   row of q, k, v and dO starts 16-byte aligned (all train-step calls),
//   else 4 bytes; the wrapper picks.  Rows >= T or S and the pad columns
//   D..DP are zero-filled by the copy itself; lse and Dsum move in 4-byte
//   copies;
// - D padded with zeros to DP (48, 80 or 160); tensors read and written
//   through their [B, T, H, D] strides.  Row pitch DP + 8 bf16, an odd
//   multiple of 16 bytes: the 8 rows of one ldmatrix phase hit distinct
//   banks.
// Tile shapes (Shape<MT, warps, tile, stages, regs> below) come from
// same-call comparisons on an H100 80GB HBM3 at 700 W
// (examples/torch_attention_sweep.py, two calls; device ms per launch at
// level 0, B=8):
// - dkv: 32 rows per warp, 4 warps, 32-query slots, 3 stages, K/V
//   fragments in registers: 0.0815-0.0820, against 0.1116-0.1120 for 16
//   rows per warp in 64-key blocks, 0.1068 with 8 such warps, 0.0907 with
//   the fragments re-read from shared memory, 0.0960 with 8 warps of 32
//   rows, 0.0826 with 2 stages;
// - dq: 32 rows per warp, 4 warps, 32-key slots, 2 stages, Q/dO fragments
//   in registers: 0.0633-0.0638, against 0.0800-0.0836 for 16 rows per
//   warp, 0.0697 with 8 warps of 16 rows, 0.0853 with fragments re-read,
//   0.0656-0.0658 with 3 stages, 0.0665 with 8 warps of 32 rows;
// - D=80 and 160: the shapes below read within 0.001 ms of every other
//   shape that did not spill, except 16-key slots for dq at 160 (the
//   middle block, S=16: 0.0040 against 0.0057 with 64-key slots), 8 warps
//   for dkv at 80 (0.0173 against 0.0185), and 32 rows per warp for dq at
//   80 (0.0122 against 0.0133-0.0138, not kept: 255 registers, the limit).
// 32 rows per warp win as in K1: each B fragment from ldmatrix feeds two
// row tiles.  Shapes where ptxas spilled were dropped (for example dq at
// D=48 with fragments re-read: 128 or 168 registers, though 255 were
// allowed).
// Not used: wgmma and TMA (at DP=48 a 96-byte row does not fill wgmma's
// 128-byte swizzle), and a fused one-kernel backward (its dQ needs
// atomics, so the result would change from run to run).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>

#include "flash_common.cuh"

namespace {

using flash::copy_tile;
using flash::cp_async;
using flash::cp_async_commit;
using flash::cp_async_wait;
using flash::ex2;
using flash::ldmatrix_x4;
using flash::ldmatrix_x4_trans;
using flash::mma_16816;
using flash::pack_bf16;
typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;

// (batch, token, head) element strides of q, k, v, dO and the outputs:
// dQ for the dq kernel, dK then dV for the dkv kernel
struct Strides {
  long long v[18];
};

// Shape of a kernel instance: MT 16-row tiles per warp, WARPS warps, TILE
// rows of the streamed pair per ring slot, STAGES slots, and whether the
// fixed pair's A fragments are held in registers (else re-read from shared
// memory at every tile)
template <int MT, int WARPS, int TILE, int STAGES, bool REGS>
struct Shape {
  static constexpr int kMT = MT, kWarps = WARPS, kTile = TILE, kStages = STAGES;
  static constexpr bool kRegs = REGS;
  static constexpr int kThreads = 32 * WARPS;
  static constexpr int kRows = 16 * MT * WARPS;  // rows of the fixed pair a block owns
};

// Each instance's shape can be replaced at build time (a file that defines
// FLASH_BWD_DQ48 etc. and includes this one), which is how
// examples/torch_attention_sweep.py compares shapes.
#ifndef FLASH_BWD_DQ48
#define FLASH_BWD_DQ48 Shape<2, 4, 32, 2, true>
#endif
#ifndef FLASH_BWD_DQ80
#define FLASH_BWD_DQ80 Shape<1, 4, 64, 2, true>
#endif
#ifndef FLASH_BWD_DQ160
#define FLASH_BWD_DQ160 Shape<1, 4, 16, 2, false>
#endif
#ifndef FLASH_BWD_DKV48
#define FLASH_BWD_DKV48 Shape<2, 4, 32, 3, true>
#endif
#ifndef FLASH_BWD_DKV80
#define FLASH_BWD_DKV80 Shape<1, 8, 64, 2, false>
#endif
#ifndef FLASH_BWD_DKV160
#define FLASH_BWD_DKV160 Shape<1, 4, 32, 2, false>
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

// A fragments (blocks: rows 0-7 | 8-15 x columns k0 | k0+8) of a warp's MT
// row tiles of a row-major shared tile, at every k-step
template <int DP, int MT>
__device__ __forceinline__ void load_a(uint32_t (&a)[MT][DP / 16][4], const bf16* tile,
                                       int wrow) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int kt = 0; kt < DP / 16; ++kt) {
      ldmatrix_x4(a[mt][kt],
                  tile + (wrow + mt * 16 + (lane & 15)) * (DP + 8) + kt * 16 + ((lane >> 4) << 3));
    }
  }
}

// The A fragments of k-step kt: from `held` (registers) when REGS, else
// read from the shared tile
template <int DP, int MT, bool REGS>
__device__ __forceinline__ void a_at(uint32_t (&f)[MT][4], const uint32_t (&held)[MT][DP / 16][4],
                                     const bf16* tile, int wrow, int kt) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    if constexpr (REGS) {
#pragma unroll
      for (int e = 0; e < 4; ++e) f[mt][e] = held[mt][kt][e];
    } else {
      ldmatrix_x4(f[mt],
                  tile + (wrow + mt * 16 + (lane & 15)) * (DP + 8) + kt * 16 + ((lane >> 4) << 3));
    }
  }
}

// acc[mt][nt] += a[mt] . X^T at k-step kt, for the NT 8-row tiles of a
// row-major shared tile X: one ldmatrix gives the B fragments of row tiles
// nt and nt+1 (blocks: rows 0-7 | 8-15 of the pair x columns k0 | k0+8)
template <int DP, int MT, int NT>
__device__ __forceinline__ void mma_xt(float (&acc)[MT][NT][4], const uint32_t (&a)[MT][4],
                                       const bf16* x, int kt) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < NT; nt += 2) {
    uint32_t b[4];
    ldmatrix_x4(b, x + (nt * 8 + (lane & 7) + ((lane >> 4) << 3)) * (DP + 8) + kt * 16 + (lane & 8));
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      mma_16816(acc[mt][nt], a[mt], b[0], b[1]);
      mma_16816(acc[mt][nt + 1], a[mt], b[2], b[3]);
    }
  }
}

// acc[mt] += a[mt] . X over KK 16-row k-steps of a row-major shared tile X
// (rows are the k index): one ldmatrix.trans gives the B fragments of
// column tiles nd and nd+1 (blocks: rows 0-7 | 8-15 x columns nd | nd+1)
template <int DP, int MT, int KK>
__device__ __forceinline__ void mma_x(float (&acc)[MT][DP / 8][4], const uint32_t (&a)[MT][KK][4],
                                      const bf16* x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
    for (int nd = 0; nd < DP / 8; nd += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, x + (kk * 16 + (lane & 15)) * (DP + 8) + nd * 8 + ((lane >> 4) << 3));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_16816(acc[mt][nd], a[mt][kk], b[0], b[1]);
        mma_16816(acc[mt][nd + 1], a[mt][kk], b[2], b[3]);
      }
    }
  }
}

// Store rows r and r + 8 of a warp's 16 x DP f32 accumulator, times `mul`,
// as bf16 (columns < D, rows < n_rows).
template <int ND>
__device__ __forceinline__ void store_rows(bf16* dst, long long ld, const float (&acc)[ND][4],
                                           int row0, int n_rows, int D, float mul) {
  const int tg = threadIdx.x & 3;
  const int row1 = row0 + 8;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int c = nd * 8 + tg * 2;
    if (c < D) {
      if (row0 < n_rows) {
        *reinterpret_cast<__nv_bfloat162*>(dst + (long long)row0 * ld + c) =
            __floats2bfloat162_rn(acc[nd][0] * mul, acc[nd][1] * mul);
      }
      if (row1 < n_rows) {
        *reinterpret_cast<__nv_bfloat162*>(dst + (long long)row1 * ld + c) =
            __floats2bfloat162_rn(acc[nd][2] * mul, acc[nd][3] * mul);
      }
    }
  }
}

// Issue 4-byte copies of lse[row0 .. row0 + ROWS) and dsum[...] into
// dst[0 .. ROWS) and dst[ROWS .. 2 ROWS), zero-filling rows >= n_rows
template <int ROWS, int THREADS>
__device__ __forceinline__ void copy_stats(float* dst, const float* lse, const float* dsum,
                                           int row0, int n_rows) {
  for (int i = threadIdx.x; i < 2 * ROWS; i += THREADS) {
    const int r = i < ROWS ? i : i - ROWS;
    const float* src = i < ROWS ? lse : dsum;
    const bool in = row0 + r < n_rows;
    cp_async<4>(dst + i, in ? src + row0 + r : src, in);
  }
}

// ---------------------------------------------------------------- dq ----

// One key tile for a warp's MT query-row tiles: S = Q K^T, dP = dO V^T
// (started at -Dsum), P = 2^(S c - lse log2e), dS = P o dP re-packed as
// bf16 A fragments, dQ += dS K.  kMask zeroes P of keys >= S.
template <class C, int DP, bool kMask>
__device__ __forceinline__ void dq_tile(const bf16* ks, const bf16* vs, const bf16* qs,
                                        const bf16* dos,
                                        const uint32_t (&qa)[C::kMT][DP / 16][4],
                                        const uint32_t (&da)[C::kMT][DP / 16][4],
                                        const float (&l2)[C::kMT][2],
                                        const float (&dd)[C::kMT][2],
                                        float (&acc)[C::kMT][DP / 8][4], int wrow, int kv0,
                                        int S, float c) {
  constexpr int MT = C::kMT;
  constexpr int NT = C::kTile / 8;  // 8-key column tiles of S and dP
  const int tg = threadIdx.x & 3;

  float s[MT][NT][4], dp[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[mt][nt][0] = s[mt][nt][1] = s[mt][nt][2] = s[mt][nt][3] = 0.f;
      dp[mt][nt][0] = dp[mt][nt][1] = -dd[mt][0];
      dp[mt][nt][2] = dp[mt][nt][3] = -dd[mt][1];
    }
  }
#pragma unroll
  for (int kt = 0; kt < DP / 16; ++kt) {
    uint32_t qf[MT][4], df[MT][4];
    a_at<DP, MT, C::kRegs>(qf, qa, qs, wrow, kt);
    mma_xt<DP, MT, NT>(s, qf, ks, kt);
    a_at<DP, MT, C::kRegs>(df, da, dos, wrow, kt);
    mma_xt<DP, MT, NT>(dp, df, vs, kt);
  }
  if (kMask) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (kv0 + nt * 8 + tg * 2 + j >= S) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) s[mt][nt][j] = s[mt][nt][2 + j] = -CUDART_INF_F;
        }
      }
    }
  }

  uint32_t dsa[MT][NT / 2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float p0 = ex2(fmaf(s[mt][nt][0], c, -l2[mt][0]));
      const float p1 = ex2(fmaf(s[mt][nt][1], c, -l2[mt][0]));
      const float p2 = ex2(fmaf(s[mt][nt][2], c, -l2[mt][1]));
      const float p3 = ex2(fmaf(s[mt][nt][3], c, -l2[mt][1]));
      dsa[mt][nt / 2][(nt % 2) * 2 + 0] = pack_bf16(p0 * dp[mt][nt][0], p1 * dp[mt][nt][1]);
      dsa[mt][nt / 2][(nt % 2) * 2 + 1] = pack_bf16(p2 * dp[mt][nt][2], p3 * dp[mt][nt][3]);
    }
  }
  mma_x<DP, MT, NT / 2>(acc, dsa, ks);
}

template <int DP, int VEC>
__global__ void __launch_bounds__(DqConfig<DP>::kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dsum,
                    bf16* __restrict__ dq, int H, int T, int S, int D, Strides st, float c,
                    float scale) {
  using C = DqConfig<DP>;
  constexpr int MT = C::kMT;
  constexpr int BQ = C::kRows;   // queries of the block
  constexpr int BK = C::kTile;   // keys per ring slot
  constexpr int STAGES = C::kStages;
  constexpr int P = DP + 8;
  constexpr int kSlot = 2 * BK * P;  // K then V
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + BQ * P;
  bf16* ring = dos + BQ * P;

  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * BQ;
  const long long* sv = st.v;
  const bf16* kb = k + b * sv[3] + h * sv[5];
  const bf16* vb = v + b * sv[6] + h * sv[8];
  const int n_tiles = (S + BK - 1) / BK;

  auto issue = [&](int t, int slot) {
    bf16* dst = ring + slot * kSlot;
    copy_tile<DP, BK, C::kThreads, VEC>(dst, kb, sv[4], t * BK, S, D);
    copy_tile<DP, BK, C::kThreads, VEC>(dst + BK * P, vb, sv[7], t * BK, S, D);
  };
  copy_tile<DP, BQ, C::kThreads, VEC>(qs, q + b * sv[0] + h * sv[2], sv[1], q0, T, D);
  copy_tile<DP, BQ, C::kThreads, VEC>(dos, dout + b * sv[9] + h * sv[11], sv[10], q0, T, D);
  cp_async_commit();
  flash::ring_fill<STAGES>(n_tiles, issue);

  // lse * log2e and Dsum of the rows g and g + 8 of each row tile; rows >=
  // T get 0 (their zero Q and dO rows give dS = 0, and they are not stored)
  const int wrow = warp * 16 * MT;
  float l2[MT][2], dd[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = q0 + wrow + mt * 16 + g + 8 * j;
      const bool in = row < T;
      l2[mt][j] = in ? lse[(long long)bh * T + row] * kLog2e : 0.f;
      dd[mt][j] = in ? dsum[(long long)bh * T + row] : 0.f;
    }
  }
  cp_async_wait<STAGES - 1>();  // the Q / dO group
  __syncthreads();
  uint32_t qa[MT][DP / 16][4], da[MT][DP / 16][4];
  if constexpr (C::kRegs) {
    load_a<DP, MT>(qa, qs, wrow);
    load_a<DP, MT>(da, dos, wrow);
  }

  float acc[MT][DP / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nd = 0; nd < DP / 8; ++nd) {
      acc[mt][nd][0] = acc[mt][nd][1] = acc[mt][nd][2] = acc[mt][nd][3] = 0.f;
    }
  }

  const bool ragged = S % BK != 0;
  auto body = [&](int t, int slot) {
    const bf16* ks = ring + slot * kSlot;
    if (ragged && t == n_tiles - 1) {
      dq_tile<C, DP, true>(ks, ks + BK * P, qs, dos, qa, da, l2, dd, acc, wrow, t * BK, S, c);
    } else {
      dq_tile<C, DP, false>(ks, ks + BK * P, qs, dos, qa, da, l2, dd, acc, wrow, t * BK, S, c);
    }
  };
  flash::ring_run<STAGES>(n_tiles, issue, body);

  bf16* dqb = dq + b * sv[12] + h * sv[14];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    store_rows<DP / 8>(dqb, sv[13], acc[mt], q0 + wrow + mt * 16 + g, T, D, scale);
  }
}

// --------------------------------------------------------------- dkv ----

// One query tile for a warp's MT key-row tiles: S^T = K Q^T, dP^T = V dO^T
// (started at -Dsum), P^T = 2^(S^T c - lse log2e), dS^T = P^T o dP^T, both
// re-packed as bf16 A fragments, then dV += P^T dO and dK += dS^T Q.
template <class C, int DP>
__device__ __forceinline__ void dkv_tile(const bf16* qs, const bf16* dos, const float* ls,
                                         const float* dsm, const bf16* ks, const bf16* vs,
                                         const uint32_t (&ka)[C::kMT][DP / 16][4],
                                         const uint32_t (&va)[C::kMT][DP / 16][4],
                                         float (&dka)[C::kMT][DP / 8][4],
                                         float (&dva)[C::kMT][DP / 8][4], int wrow, float c) {
  constexpr int MT = C::kMT;
  constexpr int NQ = C::kTile / 8;  // 8-query column tiles of S^T and dP^T
  const int tg = threadIdx.x & 3;

  float s[MT][NQ][4], dp[MT][NQ][4];
#pragma unroll
  for (int nt = 0; nt < NQ; ++nt) {
    const float2 d = *reinterpret_cast<const float2*>(dsm + nt * 8 + tg * 2);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      s[mt][nt][0] = s[mt][nt][1] = s[mt][nt][2] = s[mt][nt][3] = 0.f;
      dp[mt][nt][0] = dp[mt][nt][2] = -d.x;
      dp[mt][nt][1] = dp[mt][nt][3] = -d.y;
    }
  }
#pragma unroll
  for (int kt = 0; kt < DP / 16; ++kt) {
    uint32_t kf[MT][4], vf[MT][4];
    a_at<DP, MT, C::kRegs>(kf, ka, ks, wrow, kt);
    mma_xt<DP, MT, NQ>(s, kf, qs, kt);
    a_at<DP, MT, C::kRegs>(vf, va, vs, wrow, kt);
    mma_xt<DP, MT, NQ>(dp, vf, dos, kt);
  }

  uint32_t pa[MT][NQ / 2][4], dsa[MT][NQ / 2][4];
#pragma unroll
  for (int nt = 0; nt < NQ; ++nt) {
    const float2 l = *reinterpret_cast<const float2*>(ls + nt * 8 + tg * 2);
    const float l0 = l.x * kLog2e, l1 = l.y * kLog2e;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const float p0 = ex2(fmaf(s[mt][nt][0], c, -l0));
      const float p1 = ex2(fmaf(s[mt][nt][1], c, -l1));
      const float p2 = ex2(fmaf(s[mt][nt][2], c, -l0));
      const float p3 = ex2(fmaf(s[mt][nt][3], c, -l1));
      pa[mt][nt / 2][(nt % 2) * 2 + 0] = pack_bf16(p0, p1);
      pa[mt][nt / 2][(nt % 2) * 2 + 1] = pack_bf16(p2, p3);
      dsa[mt][nt / 2][(nt % 2) * 2 + 0] = pack_bf16(p0 * dp[mt][nt][0], p1 * dp[mt][nt][1]);
      dsa[mt][nt / 2][(nt % 2) * 2 + 1] = pack_bf16(p2 * dp[mt][nt][2], p3 * dp[mt][nt][3]);
    }
  }
  mma_x<DP, MT, NQ / 2>(dva, pa, dos);
  mma_x<DP, MT, NQ / 2>(dka, dsa, qs);
}

template <int DP, int VEC>
__global__ void __launch_bounds__(DkvConfig<DP>::kThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ dsum,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int T, int S, int D,
                     Strides st, float c, float scale) {
  using C = DkvConfig<DP>;
  constexpr int MT = C::kMT;
  constexpr int BK = C::kRows;   // keys of the block
  constexpr int BQ = C::kTile;   // queries per ring slot
  constexpr int STAGES = C::kStages;
  constexpr int P = DP + 8;
  constexpr int kSlot = 2 * BQ * P;  // Q then dO
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + BK * P;
  bf16* ring = vs + BK * P;
  float* stats = reinterpret_cast<float*>(ring + STAGES * kSlot);  // per slot: lse, Dsum

  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kv0 = blockIdx.x * BK;
  const long long* sv = st.v;
  const bf16* qb = q + b * sv[0] + h * sv[2];
  const bf16* dob = dout + b * sv[9] + h * sv[11];
  const float* lrow = lse + (long long)bh * T;
  const float* drow = dsum + (long long)bh * T;
  const int n_tiles = (T + BQ - 1) / BQ;

  auto issue = [&](int t, int slot) {
    bf16* dst = ring + slot * kSlot;
    copy_tile<DP, BQ, C::kThreads, VEC>(dst, qb, sv[1], t * BQ, T, D);
    copy_tile<DP, BQ, C::kThreads, VEC>(dst + BQ * P, dob, sv[10], t * BQ, T, D);
    copy_stats<BQ, C::kThreads>(stats + slot * 2 * BQ, lrow, drow, t * BQ, T);
  };
  copy_tile<DP, BK, C::kThreads, VEC>(ks, k + b * sv[3] + h * sv[5], sv[4], kv0, S, D);
  copy_tile<DP, BK, C::kThreads, VEC>(vs, v + b * sv[6] + h * sv[8], sv[7], kv0, S, D);
  cp_async_commit();
  flash::ring_fill<STAGES>(n_tiles, issue);
  cp_async_wait<STAGES - 1>();  // the K / V group
  __syncthreads();

  const int wrow = warp * 16 * MT;
  uint32_t ka[MT][DP / 16][4], va[MT][DP / 16][4];
  if constexpr (C::kRegs) {
    load_a<DP, MT>(ka, ks, wrow);
    load_a<DP, MT>(va, vs, wrow);
  }

  float dka[MT][DP / 8][4], dva[MT][DP / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nd = 0; nd < DP / 8; ++nd) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[mt][nd][e] = dva[mt][nd][e] = 0.f;
    }
  }

  auto body = [&](int t, int slot) {
    const bf16* qs = ring + slot * kSlot;
    const float* ls = stats + slot * 2 * BQ;
    dkv_tile<C, DP>(qs, qs + BQ * P, ls, ls + BQ, ks, vs, ka, va, dka, dva, wrow, c);
  };
  flash::ring_run<STAGES>(n_tiles, issue, body);

  bf16* dkb = dk + b * sv[12] + h * sv[14];
  bf16* dvb = dv + b * sv[15] + h * sv[17];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int row0 = kv0 + wrow + mt * 16 + g;
    store_rows<DP / 8>(dkb, sv[13], dka[mt], row0, S, D, scale);
    store_rows<DP / 8>(dvb, sv[16], dva[mt], row0, S, D, 1.f);
  }
}

// ------------------------------------------------------------ launch ----

template <int DP, int VEC>
int launch_dq(int B, int H, int T, int S, int D, const void* q, const void* k, const void* v,
              const void* dout, const void* lse, const void* dsum, void* dq, const Strides& st,
              float scale, cudaStream_t stream) {
  using C = DqConfig<DP>;
  constexpr int smem = (2 * C::kRows + 2 * C::kStages * C::kTile) * (DP + 8) *
                       static_cast<int>(sizeof(bf16));
  static std::atomic<bool> smem_set[flash::kMaxDevices];
  const int err = flash::set_smem_once(flash_bwd_dq_kernel<DP, VEC>, smem, smem_set);
  if (err != 0) return err;
  const dim3 grid((T + C::kRows - 1) / C::kRows, B * H);
  flash_bwd_dq_kernel<DP, VEC><<<grid, C::kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dsum), static_cast<bf16*>(dq), H, T, S, D, st,
      scale * kLog2e, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DP, int VEC>
int launch_dkv(int B, int H, int T, int S, int D, const void* q, const void* k, const void* v,
               const void* dout, const void* lse, const void* dsum, void* dk, void* dv,
               const Strides& st, float scale, cudaStream_t stream) {
  using C = DkvConfig<DP>;
  constexpr int smem = (2 * C::kRows + 2 * C::kStages * C::kTile) * (DP + 8) *
                           static_cast<int>(sizeof(bf16)) +
                       2 * C::kStages * C::kTile * static_cast<int>(sizeof(float));
  static std::atomic<bool> smem_set[flash::kMaxDevices];
  const int err = flash::set_smem_once(flash_bwd_dkv_kernel<DP, VEC>, smem, smem_set);
  if (err != 0) return err;
  const dim3 grid((S + C::kRows - 1) / C::kRows, B * H);
  flash_bwd_dkv_kernel<DP, VEC><<<grid, C::kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dsum), static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, T, S,
      D, st, scale * kLog2e, scale);
  return static_cast<int>(cudaGetLastError());
}

// The instance for the padded width `dp` and copy width VEC
template <int VEC>
int dq_width(int dp, int B, int H, int T, int S, int D, const void* q, const void* k,
             const void* v, const void* dout, const void* lse, const void* dsum, void* dq,
             const Strides& st, float scale, cudaStream_t s) {
  switch (dp) {
    case 48:
      return launch_dq<48, VEC>(B, H, T, S, D, q, k, v, dout, lse, dsum, dq, st, scale, s);
    case 80:
      return launch_dq<80, VEC>(B, H, T, S, D, q, k, v, dout, lse, dsum, dq, st, scale, s);
    case 160:
      return launch_dq<160, VEC>(B, H, T, S, D, q, k, v, dout, lse, dsum, dq, st, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int VEC>
int dkv_width(int dp, int B, int H, int T, int S, int D, const void* q, const void* k,
              const void* v, const void* dout, const void* lse, const void* dsum, void* dk,
              void* dv, const Strides& st, float scale, cudaStream_t s) {
  switch (dp) {
    case 48:
      return launch_dkv<48, VEC>(B, H, T, S, D, q, k, v, dout, lse, dsum, dk, dv, st, scale, s);
    case 80:
      return launch_dkv<80, VEC>(B, H, T, S, D, q, k, v, dout, lse, dsum, dk, dv, st, scale, s);
    case 160:
      return launch_dkv<160, VEC>(B, H, T, S, D, q, k, v, dout, lse, dsum, dk, dv, st, scale,
                                  s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

Strides copy_strides(const long long* strides, int n) {
  Strides st = {};
  for (int i = 0; i < n; ++i) st.v[i] = strides[i];
  return st;
}

}  // namespace

// q, dout, dq: bf16 [B, T, H, D]; k, v, dk, dv: bf16 [B, S, H, D]; unit
// stride along D.  `strides` holds the (batch, token, head) element strides
// of q, k, v, dout and the outputs in that order: dq (15 values), or dk and
// dv (18 values).  lse and dsum: f32 [B, H, T], contiguous.  `dp` picks the
// padded width (48, 80 or 160) and must be >= D.  `copy_bytes` is 16 when
// D % 8 == 0, every stride is a multiple of 8 and q, k, v, dout are
// 16-byte aligned, else 4 (D and the strides even, 4-byte alignment).
// Each returns the cudaError_t of its launch.
extern "C" int flash_attention_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse,
                                           const void* dsum, void* dq, int B, int H, int T,
                                           int S, int D, int dp, int copy_bytes,
                                           const long long* strides, float scale,
                                           void* stream) {
  const Strides st = copy_strides(strides, 15);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (copy_bytes) {
    case 16:
      return dq_width<16>(dp, B, H, T, S, D, q, k, v, dout, lse, dsum, dq, st, scale, s);
    case 4:
      return dq_width<4>(dp, B, H, T, S, D, q, k, v, dout, lse, dsum, dq, st, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_attention_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse,
                                            const void* dsum, void* dk, void* dv, int B,
                                            int H, int T, int S, int D, int dp, int copy_bytes,
                                            const long long* strides, float scale,
                                            void* stream) {
  const Strides st = copy_strides(strides, 18);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (copy_bytes) {
    case 16:
      return dkv_width<16>(dp, B, H, T, S, D, q, k, v, dout, lse, dsum, dk, dv, st, scale, s);
    case 4:
      return dkv_width<4>(dp, B, H, T, S, D, q, k, v, dout, lse, dsum, dk, dv, st, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
