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
// Bound on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): level 0 at
// B=56 is 4*B*H*T*S*D = 75 GFLOP -> 76 us, against 147 MB of Q/K/V/O
// -> 44 us, so the heaviest call is bound by the tensor cores; with D=40
// the operations per byte are low (~510), and the smaller levels sit
// closer to the memory bound.
//
// Design (a simple kernel that is right first; wgmma/TMA is later work):
// - one block of 4 warps per (64-row query tile, batch*head); each warp
//   owns 16 query rows, held as bf16 mma.sync A fragments in registers;
// - key/value tiles of 64 rows are staged in shared memory; V is stored
//   transposed so the P.V product reads its B fragments as 32-bit words;
// - both products run on the tensor cores as mma.sync m16n8k16 (bf16 in,
//   f32 accumulate); the P tile never leaves registers: the f32 score
//   fragment of Q K^T is re-packed as the A fragment of P V;
// - softmax statistics (running max, row sum) stay f32 in registers, in
//   base-2 units (scores pre-multiplied by log2(e)/sqrt(D));
// - D is padded with zeros in shared memory to the template width DP
//   (48, 80 or 160: the next multiple of 16, not 128); rows beyond T or S
//   are zero-filled and keys beyond S are masked to -inf, so ragged T and
//   S need no fallback;
// - Q/K/V/O are read and written through their [B, T, H, D] strides, so
//   the caller never folds heads or pads.
// Row pitches of the shared tiles are (DP + 8) and (64 + 8) bf16: an odd
// multiple of 4 words, which spreads the 8 rows a fragment load touches
// over all 32 banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;   // query rows per block: 4 warps x 16
constexpr int kBlockKV = 64;  // keys per shared-memory tile
constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copy rows [row0, row0 + 64) x columns [0, DP) of a [rows, D] matrix with
// row stride `ld` into shared memory with pitch `pitch`, zero-filling rows
// >= n_rows and columns >= D.  D and `ld` are even, so columns move in
// pairs as 32-bit words.
template <int DP, bool kTranspose>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int pitch,
                                          const __nv_bfloat16* src,
                                          long long ld, int row0, int n_rows,
                                          int D) {
  constexpr int kPairs = DP / 2;
  for (int i = threadIdx.x; i < kBlockKV * kPairs; i += kThreads) {
    const int r = i / kPairs;
    const int c = (i - r * kPairs) * 2;
    uint32_t w = 0;
    if (row0 + r < n_rows && c < D) {
      w = *reinterpret_cast<const uint32_t*>(src + (long long)(row0 + r) * ld + c);
    }
    if (kTranspose) {
      const uint16_t lo = (uint16_t)(w & 0xffffu), hi = (uint16_t)(w >> 16);
      reinterpret_cast<uint16_t*>(dst)[c * pitch + r] = lo;
      reinterpret_cast<uint16_t*>(dst)[(c + 1) * pitch + r] = hi;
    } else {
      *reinterpret_cast<uint32_t*>(dst + r * pitch + c) = w;
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int H, int T, int S, int D,
                 long long q_sb, long long q_st, long long q_sh,
                 long long k_sb, long long k_st, long long k_sh,
                 long long v_sb, long long v_st, long long v_sh,
                 long long o_sb, long long o_st, long long o_sh,
                 float scale_log2) {
  constexpr int KP = DP + 8;        // pitch of the K (and initial Q) tile
  constexpr int VP = kBlockKV + 8;  // pitch of the transposed V tile
  constexpr int KT = DP / 16;       // k-steps of Q K^T
  constexpr int NT = kBlockKV / 8;  // 8-key column tiles of the score block
  constexpr int ND = DP / 8;        // 8-wide column tiles of O
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockKV * KP];
  __shared__ __align__(16) __nv_bfloat16 vt[DP * VP];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // fragment row group
  const int tg = lane & 3;   // thread within the group
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kBlockQ;

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;

  // Q tile -> shared (through the K buffer) -> A fragments in registers
  load_tile<DP, false>(ks, KP, qb, q_st, q0, T, D);
  __syncthreads();
  uint32_t qa[KT][4];
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    const int c = kt * 16 + tg * 2;
    qa[kt][0] = lds32(ks + r0 * KP + c);
    qa[kt][1] = lds32(ks + (r0 + 8) * KP + c);
    qa[kt][2] = lds32(ks + r0 * KP + c + 8);
    qa[kt][3] = lds32(ks + (r0 + 8) * KP + c + 8);
  }

  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  }
  float m0 = -1e30f, m1 = -1e30f;  // running max of rows g and g+8 (base 2)
  float l0 = 0.f, l1 = 0.f;        // this thread's share of the row sums

  for (int kv0 = 0; kv0 < S; kv0 += kBlockKV) {
    __syncthreads();  // previous tile (or the Q tile) fully read
    load_tile<DP, false>(ks, KP, kb, k_st, kv0, S, D);
    load_tile<DP, true>(vt, VP, vb, v_st, kv0, S, D);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* krow = ks + (nt * 8 + g) * KP + tg * 2;
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        mma_16816(s[nt], qa[kt], lds32(krow + kt * 16), lds32(krow + kt * 16 + 8));
      }
    }

    // scale to base-2 units, mask keys >= S, new running max
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool valid = kv0 + nt * 8 + tg * 2 + j < S;
        s[nt][j] = valid ? s[nt][j] * scale_log2 : -CUDART_INF_F;
        s[nt][2 + j] = valid ? s[nt][2 + j] * scale_log2 : -CUDART_INF_F;
        mx0 = fmaxf(mx0, s[nt][j]);
        mx1 = fmaxf(mx1, s[nt][2 + j]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float alpha0 = exp2f(m0 - mx0);
    const float alpha1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      acc[nd][0] *= alpha0;
      acc[nd][1] *= alpha0;
      acc[nd][2] *= alpha1;
      acc[nd][3] *= alpha1;
    }

    // P = exp2(S - m), re-packed as bf16 A fragments (16 keys each)
    uint32_t pa[NT / 2][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float p0 = exp2f(s[nt][0] - m0), p1 = exp2f(s[nt][1] - m0);
      const float p2 = exp2f(s[nt][2] - m1), p3 = exp2f(s[nt][3] - m1);
      l0 += p0 + p1;
      l1 += p2 + p3;
      pa[nt / 2][(nt % 2) * 2 + 0] = pack_bf16(p0, p1);
      pa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O += P V
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        const __nv_bfloat16* vrow = vt + (nd * 8 + g) * VP + kk * 16 + tg * 2;
        mma_16816(acc[nd], pa[kk], lds32(vrow), lds32(vrow + 8));
      }
    }
  }

  // full row sums across the 4 threads of a group
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int row0 = q0 + r0, row1 = row0 + 8;
  __nv_bfloat16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int c = nd * 8 + tg * 2;
    if (c < D) {
      if (row0 < T) {
        *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row0 * o_st + c) =
            __floats2bfloat162_rn(acc[nd][0] * inv0, acc[nd][1] * inv0);
      }
      if (row1 < T) {
        *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row1 * o_st + c) =
            __floats2bfloat162_rn(acc[nd][2] * inv1, acc[nd][3] * inv1);
      }
    }
  }
  if (tg == 0) {
    float* lrow = lse + (long long)bh * T;
    if (row0 < T) lrow[row0] = m0 * kLn2 + logf(l0);
    if (row1 < T) lrow[row1] = m1 * kLn2 + logf(l1);
  }
}

template <int DP>
void launch(dim3 grid, cudaStream_t stream, const void* q, const void* k,
            const void* v, void* o, void* lse, int H, int T, int S, int D,
            const long long* st, float scale_log2) {
  flash_fwd_kernel<DP><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), H, T, S, D, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale_log2);
}

}  // namespace

// q, k, v, o: bf16 [B, T|S, H, D] with unit stride along D; `strides` holds
// the (batch, token, head) element strides of q, k, v and o in that order.
// lse: f32 [B, H, T], contiguous.  `dp` picks the padded width (48, 80 or
// 160) and must be >= D.  Returns the cudaError_t of the launch.
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        int B, int H, int T, int S, int D,
                                        int dp, const long long* strides,
                                        float scale, void* stream) {
  const dim3 grid((T + kBlockQ - 1) / kBlockQ, B * H);
  const float scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dp) {
    case 48:
      launch<48>(grid, s, q, k, v, o, lse, H, T, S, D, strides, scale_log2);
      break;
    case 80:
      launch<80>(grid, s, q, k, v, o, lse, H, T, S, D, strides, scale_log2);
      break;
    case 160:
      launch<160>(grid, s, q, k, v, o, lse, H, T, S, D, strides, scale_log2);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
