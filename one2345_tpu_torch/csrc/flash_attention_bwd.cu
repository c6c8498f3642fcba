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
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): at level 0,
// B=8, the dq kernel does 3 products, 6*B*H*T*S*D = 16.1 GFLOP -> 16 us,
// and the dkv kernel 4 products, 8*B*H*T*S*D = 21.5 GFLOP -> 22 us,
// against 27 MB and 32 MB of traffic (8 and 10 us): both are bound by the
// tensor cores; the smaller levels sit closer to the memory bound.
//
// Design (a simple kernel that is right first; wgmma/TMA is later work):
// - two kernels and no atomics, so the gradients are deterministic;
// - dq: one block of 4 warps per (64-row query tile, batch*head); each warp
//   owns 16 query rows and loops over 64-key tiles of K and V:
//   S = Q K^T and dP = dO V^T, then dS re-packed from the f32 accumulators
//   into bf16 A fragments in registers, then dQ += dS K;
// - dkv: one block of 4 warps per (64-row key tile, batch*head); each warp
//   owns 16 key rows and loops over query tiles of Q and dO.  It computes
//   the transposed products S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T
//   come out with keys as rows and are re-packed in registers as the A
//   operands of dV += P^T dO and dK += dS^T Q (no trip through shared
//   memory).  The dK and dV accumulators (2 x 16 x DP f32 per warp) live in
//   registers; at DP = 160 the query tile is 32 rows to leave room for them;
// - every product is mma.sync m16n8k16 (bf16 in, f32 accumulate); a B
//   operand that needs the transpose of a row-major tile (K in dS K, dO in
//   P^T dO, Q in dS^T Q) is read with ldmatrix.trans;
// - tiles sit in dynamic shared memory (up to 84 KB, above the 48 KB
//   static limit), D padded with zeros to DP (48, 80 or 160) as in the
//   forward kernel; rows beyond T or S are zero-filled and their P is set
//   to exactly 0, so ragged T and S need no fallback;
// - tensors are read and written through their [B, T, H, D] strides.
// Row pitches are (DP + 8) bf16: an odd multiple of 16 bytes, so the 8
// rows an ldmatrix phase or a fragment load touches hit distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;  // 4 warps of 16 rows
constexpr int kRows = 64;      // rows of the tile a block owns
constexpr float kLog2e = 1.4426950408889634f;

// (batch, token, head) element strides of q, k, v, dO and the outputs:
// dQ for the dq kernel, dK then dV for the dkv kernel
struct Strides {
  long long v[18];
};

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

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment (16 rows x 16 k) of a row-major tile: rows r0.., columns k0..
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* tile, int pitch,
                                       int r0, int k0) {
  const int lane = threadIdx.x & 31;
  const bf16* p = tile + (r0 + (lane >> 2)) * pitch + k0 + (lane & 3) * 2;
  a[0] = lds32(p);
  a[1] = lds32(p + 8 * pitch);
  a[2] = lds32(p + 8);
  a[3] = lds32(p + 8 * pitch + 8);
}

// B fragment (16 k x 8 n) of B = X^T for a row-major tile X: n indexes
// X's rows n0.., k its columns k0..
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1, const bf16* tile,
                                       int pitch, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  const bf16* p = tile + (n0 + (lane >> 2)) * pitch + k0 + (lane & 3) * 2;
  b0 = lds32(p);
  b1 = lds32(p + 8);
}

// B fragments of two adjacent 8-column tiles of B = X for a row-major tile
// X: k indexes X's rows k0..k0+15, n its columns n0..n0+15.  r[0], r[1]
// feed columns n0..n0+7 and r[2], r[3] columns n0+8..n0+15.
__device__ __forceinline__ void load_b_trans_x2(uint32_t r[4], const bf16* tile,
                                                int pitch, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  const int m = lane >> 3;  // which 8x8 block this lane addresses
  const bf16* p = tile + (k0 + (m & 1) * 8 + (lane & 7)) * pitch + n0 + (m >> 1) * 8;
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Copy rows [row0, row0 + ROWS) x columns [0, DP) of a [rows, D] matrix
// with row stride `ld` into shared memory with pitch DP + 8, zero-filling
// rows >= n_rows and columns >= D.  D and `ld` are even, so columns move
// in pairs as 32-bit words.
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long ld,
                                          int row0, int n_rows, int D) {
  constexpr int kPairs = DP / 2;
  for (int i = threadIdx.x; i < ROWS * kPairs; i += kThreads) {
    const int r = i / kPairs;
    const int c = (i - r * kPairs) * 2;
    uint32_t w = 0;
    if (row0 + r < n_rows && c < D) {
      w = *reinterpret_cast<const uint32_t*>(src + (long long)(row0 + r) * ld + c);
    }
    *reinterpret_cast<uint32_t*>(dst + r * (DP + 8) + c) = w;
  }
}

// Store rows r and r + 8 of a warp's 16 x DP f32 accumulator, times `mul`,
// as bf16 (columns < D, rows < n_rows).
template <int ND>
__device__ __forceinline__ void store_rows(bf16* dst, long long ld, float (&acc)[ND][4],
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

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dsum,
                    bf16* __restrict__ dq, int H, int T, int S, int D, Strides st,
                    float scale_log2, float scale) {
  constexpr int P = DP + 8;         // row pitch of every tile
  constexpr int KT = DP / 16;       // k-steps of Q K^T and dO V^T
  constexpr int ND = DP / 8;        // 8-wide column tiles of dQ
  constexpr int NT = kRows / 8;     // 8-key column tiles of S and dP
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + kRows * P;
  bf16* ks = dos + kRows * P;
  bf16* vs = ks + kRows * P;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kRows;
  const long long* s = st.v;

  load_tile<DP, kRows>(qs, q + b * s[0] + h * s[2], s[1], q0, T, D);
  load_tile<DP, kRows>(dos, dout + b * s[9] + h * s[11], s[10], q0, T, D);
  const bf16* kb = k + b * s[3] + h * s[5];
  const bf16* vb = v + b * s[6] + h * s[8];

  const int r0 = warp * 16;  // this warp's first row in the tile
  const int row0 = q0 + r0 + g, row1 = row0 + 8;
  const float* lrow = lse + (long long)bh * T;
  const float* drow = dsum + (long long)bh * T;
  const float lse0 = row0 < T ? lrow[row0] * kLog2e : 0.f;
  const float lse1 = row1 < T ? lrow[row1] * kLog2e : 0.f;
  const float d0 = row0 < T ? drow[row0] : 0.f;
  const float d1 = row1 < T ? drow[row1] : 0.f;

  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  }

  for (int kv0 = 0; kv0 < S; kv0 += kRows) {
    __syncthreads();  // previous K/V tile fully read
    load_tile<DP, kRows>(ks, kb, s[4], kv0, S, D);
    load_tile<DP, kRows>(vs, vb, s[7], kv0, S, D);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x 64 keys
    float sc[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.f;
    }
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      uint32_t qa[4], da[4];
      load_a(qa, qs, P, r0, kt * 16);
      load_a(da, dos, P, r0, kt * 16);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b0, b1;
        load_b(b0, b1, ks, P, nt * 8, kt * 16);
        mma_16816(sc[nt], qa, b0, b1);
        load_b(b0, b1, vs, P, nt * 8, kt * 16);
        mma_16816(dp[nt], da, b0, b1);
      }
    }

    // dS = P o (dP - Dsum), P = exp2(S log2e / sqrt(D) - lse log2e), zero
    // for keys >= S; re-packed as bf16 A fragments (16 keys each)
    uint32_t dsa[NT / 2][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool valid = kv0 + nt * 8 + tg * 2 + j < S;
        const float p0 = valid ? exp2f(sc[nt][j] * scale_log2 - lse0) : 0.f;
        const float p1 = valid ? exp2f(sc[nt][2 + j] * scale_log2 - lse1) : 0.f;
        sc[nt][j] = p0 * (dp[nt][j] - d0);
        sc[nt][2 + j] = p1 * (dp[nt][2 + j] - d1);
      }
      dsa[nt / 2][(nt % 2) * 2 + 0] = pack_bf16(sc[nt][0], sc[nt][1]);
      dsa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(sc[nt][2], sc[nt][3]);
    }

    // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
#pragma unroll
      for (int nd = 0; nd < ND; nd += 2) {
        uint32_t bt[4];
        load_b_trans_x2(bt, ks, P, kk * 16, nd * 8);
        mma_16816(acc[nd], dsa[kk], bt[0], bt[1]);
        mma_16816(acc[nd + 1], dsa[kk], bt[2], bt[3]);
      }
    }
  }

  store_rows<ND>(dq + b * s[12] + h * s[14], s[13], acc, row0, T, D, scale);
}

template <int DP, int BQ>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ dsum,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int T, int S,
                     int D, Strides st, float scale_log2, float scale) {
  constexpr int P = DP + 8;
  constexpr int KT = DP / 16;    // k-steps of K Q^T and V dO^T
  constexpr int ND = DP / 8;     // 8-wide column tiles of dK and dV
  constexpr int NQ = BQ / 8;     // 8-query column tiles of S^T and dP^T
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kRows * P;
  bf16* qs = vs + kRows * P;
  bf16* dos = qs + BQ * P;
  float* ls = reinterpret_cast<float*>(dos + BQ * P);  // lse * log2e of the query tile
  float* dsm = ls + BQ;                                // Dsum of the query tile

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kv0 = blockIdx.x * kRows;
  const long long* s = st.v;

  load_tile<DP, kRows>(ks, k + b * s[3] + h * s[5], s[4], kv0, S, D);
  load_tile<DP, kRows>(vs, v + b * s[6] + h * s[8], s[7], kv0, S, D);
  const bf16* qb = q + b * s[0] + h * s[2];
  const bf16* dob = dout + b * s[9] + h * s[11];
  const float* lrow = lse + (long long)bh * T;
  const float* drow = dsum + (long long)bh * T;

  const int r0 = warp * 16;
  const int key0 = kv0 + r0 + g, key1 = key0 + 8;
  const bool kvalid0 = key0 < S, kvalid1 = key1 < S;

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nd][e] = dva[nd][e] = 0.f;
  }

  for (int qt0 = 0; qt0 < T; qt0 += BQ) {
    __syncthreads();  // previous query tile fully read
    load_tile<DP, BQ>(qs, qb, s[1], qt0, T, D);
    load_tile<DP, BQ>(dos, dob, s[10], qt0, T, D);
    for (int i = threadIdx.x; i < BQ; i += kThreads) {
      const bool in = qt0 + i < T;
      ls[i] = in ? lrow[qt0 + i] * kLog2e : 0.f;
      dsm[i] = in ? drow[qt0 + i] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x BQ queries
    float sc[NQ][4], dp[NQ][4];
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.f;
    }
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      uint32_t ka[4], va[4];
      load_a(ka, ks, P, r0, kt * 16);
      load_a(va, vs, P, r0, kt * 16);
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt) {
        uint32_t b0, b1;
        load_b(b0, b1, qs, P, nt * 8, kt * 16);
        mma_16816(sc[nt], ka, b0, b1);
        load_b(b0, b1, dos, P, nt * 8, kt * 16);
        mma_16816(dp[nt], va, b0, b1);
      }
    }

    // P^T and dS^T, zero for queries >= T and keys >= S, re-packed as
    // bf16 A fragments (16 queries each)
    uint32_t pa[NQ / 2][4], dsa[NQ / 2][4];
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qi = nt * 8 + tg * 2 + j;
        const bool qvalid = qt0 + qi < T;
        const float l = ls[qi], dd = dsm[qi];
        const float p0 = (qvalid && kvalid0) ? exp2f(sc[nt][j] * scale_log2 - l) : 0.f;
        const float p1 = (qvalid && kvalid1) ? exp2f(sc[nt][2 + j] * scale_log2 - l) : 0.f;
        sc[nt][j] = p0;
        sc[nt][2 + j] = p1;
        dp[nt][j] = p0 * (dp[nt][j] - dd);
        dp[nt][2 + j] = p1 * (dp[nt][2 + j] - dd);
      }
      pa[nt / 2][(nt % 2) * 2 + 0] = pack_bf16(sc[nt][0], sc[nt][1]);
      pa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(sc[nt][2], sc[nt][3]);
      dsa[nt / 2][(nt % 2) * 2 + 0] = pack_bf16(dp[nt][0], dp[nt][1]);
      dsa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(dp[nt][2], dp[nt][3]);
    }

    // dV += P^T dO and dK += dS^T Q
#pragma unroll
    for (int kk = 0; kk < NQ / 2; ++kk) {
#pragma unroll
      for (int nd = 0; nd < ND; nd += 2) {
        uint32_t bt[4];
        load_b_trans_x2(bt, dos, P, kk * 16, nd * 8);
        mma_16816(dva[nd], pa[kk], bt[0], bt[1]);
        mma_16816(dva[nd + 1], pa[kk], bt[2], bt[3]);
        load_b_trans_x2(bt, qs, P, kk * 16, nd * 8);
        mma_16816(dka[nd], dsa[kk], bt[0], bt[1]);
        mma_16816(dka[nd + 1], dsa[kk], bt[2], bt[3]);
      }
    }
  }

  store_rows<ND>(dk + b * s[12] + h * s[14], s[13], dka, key0, S, D, scale);
  store_rows<ND>(dv + b * s[15] + h * s[17], s[16], dva, key0, S, D, 1.f);
}

template <int DP>
int launch_dq(int B, int H, int T, int S, int D, const void* q, const void* k,
              const void* v, const void* dout, const void* lse, const void* dsum,
              void* dq, const Strides& st, float scale, cudaStream_t stream) {
  const int smem = 4 * kRows * (DP + 8) * static_cast<int>(sizeof(bf16));
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kRows - 1) / kRows, B * H);
  flash_bwd_dq_kernel<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dsum), static_cast<bf16*>(dq), H, T, S, D, st,
      scale * kLog2e, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DP, int BQ>
int launch_dkv(int B, int H, int T, int S, int D, const void* q, const void* k,
               const void* v, const void* dout, const void* lse, const void* dsum,
               void* dk, void* dv, const Strides& st, float scale, cudaStream_t stream) {
  const int smem = (2 * kRows + 2 * BQ) * (DP + 8) * static_cast<int>(sizeof(bf16)) +
                   2 * BQ * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<DP, BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kRows - 1) / kRows, B * H);
  flash_bwd_dkv_kernel<DP, BQ><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dsum), static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, T,
      S, D, st, scale * kLog2e, scale);
  return static_cast<int>(cudaGetLastError());
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
// dv (18 values).  lse and dsum:
// f32 [B, H, T], contiguous.  `dp` picks the padded width (48, 80 or 160)
// and must be >= D.  Each returns the cudaError_t of its launch.
extern "C" int flash_attention_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse,
                                           const void* dsum, void* dq, int B, int H, int T,
                                           int S, int D, int dp, const long long* strides,
                                           float scale, void* stream) {
  const Strides st = copy_strides(strides, 15);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dp) {
    case 48:
      return launch_dq<48>(B, H, T, S, D, q, k, v, dout, lse, dsum, dq, st, scale, s);
    case 80:
      return launch_dq<80>(B, H, T, S, D, q, k, v, dout, lse, dsum, dq, st, scale, s);
    case 160:
      return launch_dq<160>(B, H, T, S, D, q, k, v, dout, lse, dsum, dq, st, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_attention_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse,
                                            const void* dsum, void* dk, void* dv, int B,
                                            int H, int T, int S, int D, int dp,
                                            const long long* strides, float scale,
                                            void* stream) {
  const Strides st = copy_strides(strides, 18);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dp) {
    case 48:
      return launch_dkv<48, 64>(B, H, T, S, D, q, k, v, dout, lse, dsum, dk, dv, st, scale, s);
    case 80:
      return launch_dkv<80, 64>(B, H, T, S, D, q, k, v, dout, lse, dsum, dk, dv, st, scale, s);
    case 160:
      return launch_dkv<160, 32>(B, H, T, S, D, q, k, v, dout, lse, dsum, dk, dv, st, scale,
                                 s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
