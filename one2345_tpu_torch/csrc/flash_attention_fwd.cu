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
// So at D=40 the exp unit, not the tensor cores, is the floor, and every
// FP32 instruction spent per score competes with it for issue slots.
//
// Design:
// - one block per (query tile, batch*head), no atomics.  Each warp owns
//   16*MT query rows; its Q fragments stay in registers for the whole key
//   loop.  The 48 instance has 4 warps of 32 rows (MT=2, 128-row tiles),
//   the 80 instance 8 warps of 16 rows (128-row tiles), the 160 instance 4
//   warps of 16 rows (64-row tiles: there T <= 64).  With MT=2 every K or V
//   fragment read from shared memory feeds two row tiles, which halves the
//   ldmatrix traffic per product (at 16 rows per warp, 8 warps share each
//   staged tile and read it 8 times);
// - K and V stream through a ring of STAGES 64-key tiles in shared memory
//   (3 at DP=48, else 2), filled with cp.async: tile t + STAGES - 1 is
//   issued before tile t's products, so the copies run under the mma and
//   exp work; one __syncthreads per tile.  Tiles above 48 KB sit in
//   dynamic shared memory.  Copies move 16 bytes (cp.async.cg) when D is
//   a multiple of 8 and every row starts 16-byte aligned (all main-path
//   calls), else 4 bytes (cp.async.ca); the wrapper picks.  Rows >= T or
//   S and the pad columns D..DP are zero-filled by the copy itself.  The
//   ring and its copies live in flash_common.cuh, shared with the
//   backward kernels;
// - V stays row-major in shared memory; the P.V B fragments come from
//   ldmatrix.x4.trans, the Q and K fragments from ldmatrix.x4, one
//   instruction per two mma.sync m16n8k16 (bf16 in, f32 accumulate) per
//   row tile.  The P tile never leaves registers: the f32 score fragment
//   of Q K^T is re-packed as the A fragment of P V;
// - softmax at the exp floor: the running max m stays in raw score units
//   and p = 2^(s*c - m*c), c = log2(e)/sqrt(D), is one FFMA and one
//   ex2.approx per score; besides them a score costs one max, one add to
//   the row sum, half a bf16x2 pack and the rescale of O (DP/64 of a
//   multiply).  Keys >= S are masked only in the last tile, and only when
//   S % 64 != 0 (a separate instance of the tile body): the main-path
//   shapes never mask;
// - D is padded with zeros to DP (48, 80 or 160); tensors are read and
//   written through their [B, T, H, D] strides, so ragged T and S, and
//   views, need no copy and no fallback.
// Row pitch is DP + 8 bf16 (112, 176 or 336 bytes: 7, 11 or 21 units of 16
// bytes, all odd), so the 8 rows of one ldmatrix phase fall on 8 distinct
// 16-byte bank groups.
// Measured on an H100 (PERF.md): dropping the row-sum add (ones in
// a pad column of V) and most rescales (a max that moves only by > 2^8)
// made level 0 slower, so the FP32 work per score is not this kernel's
// limit; neither is kept.
// Not used here: wgmma, TMA and warp specialisation.  At D=40 the floor is
// the exp unit (112 us), not the tensor cores (76 us); mma.sync at about
// two thirds of wgmma's rate does level 0's 75 GFLOP in about the exp
// floor's time, and wgmma's swizzled layouts want 128-byte rows, which
// D=48 (96 bytes) does not fill.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>

#include "flash_common.cuh"

namespace {

using flash::copy_tile;
using flash::cp_async_commit;
using flash::cp_async_wait;
using flash::ex2;
using flash::ldmatrix_x4;
using flash::ldmatrix_x4_trans;
using flash::mma_16816;
using flash::pack_bf16;
typedef __nv_bfloat16 bf16;

constexpr int kBlockKV = 64;  // keys per shared-memory tile
constexpr float kLog2e = 1.4426950408889634f;

// (batch, token, head) element strides of q, k, v and o
struct Strides {
  long long v[12];
};

constexpr int kMinBlocks = 2;  // blocks per SM the register count must allow

// Shape of each instance: 16*MT query rows per warp, WARPS warps, STAGES
// K/V tiles in the ring
template <int DP>
struct Config;
template <>
struct Config<48> {
  static constexpr int kMT = 2, kWarps = 4, kStages = 3;
};
template <>
struct Config<80> {
  static constexpr int kMT = 1, kWarps = 8, kStages = 2;
};
template <>
struct Config<160> {
  static constexpr int kMT = 1, kWarps = 4, kStages = 2;
};

template <int DP>
__host__ __device__ constexpr int block_rows() {
  return 16 * Config<DP>::kMT * Config<DP>::kWarps;
}

template <int DP>
__host__ __device__ constexpr int smem_bytes() {
  return (block_rows<DP>() + 2 * Config<DP>::kStages * kBlockKV) * (DP + 8) *
         static_cast<int>(sizeof(bf16));
}

// One 64-key tile for a warp's MT row tiles: S = Q K^T, the online-softmax
// update of (m, l, acc), and acc += P V.  kMask masks keys >= S.
template <int DP, int MT, bool kMask>
__device__ __forceinline__ void attend_tile(const bf16* ks, const bf16* vs,
                                            const uint32_t (&qa)[MT][DP / 16][4],
                                            float (&acc)[MT][DP / 8][4], float (&m)[MT][2],
                                            float (&l)[MT][2], int kv0, int S, float c) {
  constexpr int P = DP + 8;
  constexpr int KT = DP / 16;        // k-steps of Q K^T
  constexpr int NT = kBlockKV / 8;  // 8-key column tiles of S
  constexpr int ND = DP / 8;         // 8-wide column tiles of O
  static_assert(ND % 2 == 0, "V fragments come in pairs of 8-column tiles");
  const int lane = threadIdx.x & 31;
  const int tg = lane & 3;

  float s[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[mt][nt][0] = s[mt][nt][1] = s[mt][nt][2] = s[mt][nt][3] = 0.f;
  }
  // S = Q K^T: one ldmatrix gives the B fragments of key tiles nt and nt+1
  // (blocks: keys 0-7 | 8-15 of the pair x columns k0 | k0+8)
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t kf[4];
      ldmatrix_x4(kf, ks + (nt * 8 + (lane & 7) + ((lane >> 4) << 3)) * P + kt * 16 + (lane & 8));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_16816(s[mt][nt], qa[mt][kt], kf[0], kf[1]);
        mma_16816(s[mt][nt + 1], qa[mt][kt], kf[2], kf[3]);
      }
    }
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

  // online softmax, max in raw score units: p = 2^(s c - m c); P re-packed
  // as bf16 A fragments of 16 keys
  uint32_t pa[MT][NT / 2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float mx0 = m[mt][0], mx1 = m[mt][1];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[mt][nt][0], s[mt][nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[mt][nt][2], s[mt][nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // every tile holds a key < S, so mx is finite; 2^(-inf) = 0 on the first
    const float alpha0 = ex2((m[mt][0] - mx0) * c);
    const float alpha1 = ex2((m[mt][1] - mx1) * c);
    m[mt][0] = mx0;
    m[mt][1] = mx1;
    l[mt][0] *= alpha0;
    l[mt][1] *= alpha1;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      acc[mt][nd][0] *= alpha0;
      acc[mt][nd][1] *= alpha0;
      acc[mt][nd][2] *= alpha1;
      acc[mt][nd][3] *= alpha1;
    }
    const float mc0 = mx0 * c, mc1 = mx1 * c;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float p0 = ex2(fmaf(s[mt][nt][0], c, -mc0));
      const float p1 = ex2(fmaf(s[mt][nt][1], c, -mc0));
      const float p2 = ex2(fmaf(s[mt][nt][2], c, -mc1));
      const float p3 = ex2(fmaf(s[mt][nt][3], c, -mc1));
      l[mt][0] += p0 + p1;
      l[mt][1] += p2 + p3;
      pa[mt][nt / 2][(nt % 2) * 2 + 0] = pack_bf16(p0, p1);
      pa[mt][nt / 2][(nt % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
  }

  // O += P V: one ldmatrix.trans gives the B fragments of column tiles nd
  // and nd+1 (blocks: keys 0-7 | 8-15 x columns nd | nd+1)
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
#pragma unroll
    for (int nd = 0; nd < ND; nd += 2) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, vs + (kk * 16 + (lane & 15)) * P + nd * 8 + ((lane >> 4) << 3));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_16816(acc[mt][nd], pa[mt][kk], vf[0], vf[1]);
        mma_16816(acc[mt][nd + 1], pa[mt][kk], vf[2], vf[3]);
      }
    }
  }
}

template <int DP, int VEC>
__global__ void __launch_bounds__(Config<DP>::kWarps * 32, kMinBlocks)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int H, int T, int S, int D, Strides st,
                 float c, float scale) {
  constexpr int MT = Config<DP>::kMT;
  constexpr int STAGES = Config<DP>::kStages;
  constexpr int kThreads = Config<DP>::kWarps * 32;
  constexpr int BQ = block_rows<DP>();
  constexpr int P = DP + 8;
  constexpr int KT = DP / 16;
  constexpr int ND = DP / 8;
  constexpr int kTile = kBlockKV * P;  // elements of one K or V tile
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* kvs = qs + BQ * P;  // stage i: K at kvs + 2 i kTile, V after it

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // fragment row group
  const int tg = lane & 3;   // thread within the group
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * BQ;
  const long long* sv = st.v;
  const bf16* kb = k + b * sv[3] + h * sv[5];
  const bf16* vb = v + b * sv[6] + h * sv[8];
  const int n_tiles = (S + kBlockKV - 1) / kBlockKV;

  // the K/V ring: one copy group per 64-key tile
  auto issue = [&](int t, int slot) {
    bf16* dst = kvs + slot * 2 * kTile;
    copy_tile<DP, kBlockKV, kThreads, VEC>(dst, kb, sv[4], t * kBlockKV, S, D);
    copy_tile<DP, kBlockKV, kThreads, VEC>(dst + kTile, vb, sv[7], t * kBlockKV, S, D);
  };

  copy_tile<DP, BQ, kThreads, VEC>(qs, q + b * sv[0] + h * sv[2], sv[1], q0, T, D);
  cp_async_commit();
  flash::ring_fill<STAGES>(n_tiles, issue);
  cp_async_wait<STAGES - 1>();  // the Q group
  __syncthreads();

  const int wrow = warp * 16 * MT;  // this warp's first row in the tile
  // A fragments (blocks: rows 0-7 | 8-15 x columns k0 | k0+8)
  uint32_t qa[MT][KT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      ldmatrix_x4(qa[mt][kt], qs + (wrow + mt * 16 + (lane & 15)) * P + kt * 16 + ((lane >> 4) << 3));
    }
  }

  float acc[MT][ND][4];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      acc[mt][nd][0] = acc[mt][nd][1] = acc[mt][nd][2] = acc[mt][nd][3] = 0.f;
    }
    m[mt][0] = m[mt][1] = -CUDART_INF_F;
    l[mt][0] = l[mt][1] = 0.f;
  }

  const bool ragged = S % kBlockKV != 0;
  auto body = [&](int t, int slot) {
    const bf16* ks = kvs + slot * 2 * kTile;
    if (ragged && t == n_tiles - 1) {
      attend_tile<DP, MT, true>(ks, ks + kTile, qa, acc, m, l, t * kBlockKV, S, c);
    } else {
      attend_tile<DP, MT, false>(ks, ks + kTile, qa, acc, m, l, t * kBlockKV, S, c);
    }
  };
  flash::ring_run<STAGES>(n_tiles, issue, body);

  bf16* ob = o + b * sv[9] + h * sv[11];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float l0 = l[mt][0], l1 = l[mt][1];  // full row sums across the 4 threads of a group
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    const int row0 = q0 + wrow + mt * 16 + g, row1 = row0 + 8;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const int col = nd * 8 + tg * 2;
      if (col < D) {
        if (row0 < T) {
          *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row0 * sv[10] + col) =
              __floats2bfloat162_rn(acc[mt][nd][0] * inv0, acc[mt][nd][1] * inv0);
        }
        if (row1 < T) {
          *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row1 * sv[10] + col) =
              __floats2bfloat162_rn(acc[mt][nd][2] * inv1, acc[mt][nd][3] * inv1);
        }
      }
    }
    if (tg == 0) {
      float* lrow = lse + (long long)bh * T;
      if (row0 < T) lrow[row0] = m[mt][0] * scale + logf(l0);
      if (row1 < T) lrow[row1] = m[mt][1] * scale + logf(l1);
    }
  }
}

template <int DP, int VEC>
int launch(int B, int H, int T, int S, int D, const void* q, const void* k, const void* v,
           void* o, void* lse, const Strides& st, float scale, cudaStream_t stream) {
  constexpr int smem = smem_bytes<DP>();
  static std::atomic<bool> smem_set[flash::kMaxDevices];
  const int err = flash::set_smem_once(flash_fwd_kernel<DP, VEC>, smem, smem_set);
  if (err != 0) return err;
  const dim3 grid((T + block_rows<DP>() - 1) / block_rows<DP>(), B * H);
  flash_fwd_kernel<DP, VEC><<<grid, Config<DP>::kWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), H, T, S, D, st, scale * kLog2e, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_width(int copy_bytes, int B, int H, int T, int S, int D, const void* q,
                 const void* k, const void* v, void* o, void* lse, const Strides& st,
                 float scale, cudaStream_t stream) {
  switch (copy_bytes) {
    case 16:
      return launch<DP, 16>(B, H, T, S, D, q, k, v, o, lse, st, scale, stream);
    case 4:
      return launch<DP, 4>(B, H, T, S, D, q, k, v, o, lse, st, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k, v, o: bf16 [B, T|S, H, D] with unit stride along D; `strides` holds
// the (batch, token, head) element strides of q, k, v and o in that order.
// lse: f32 [B, H, T], contiguous.  `dp` picks the padded width (48, 80 or
// 160) and must be >= D.  `copy_bytes` is 16 when D % 8 == 0, every stride
// is a multiple of 8 and q, k, v are 16-byte aligned, else 4 (D and the
// strides even, 4-byte alignment).  Returns the cudaError_t of the launch.
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k, const void* v,
                                        void* o, void* lse, int B, int H, int T, int S,
                                        int D, int dp, int copy_bytes,
                                        const long long* strides, float scale,
                                        void* stream) {
  Strides st;
  for (int i = 0; i < 12; ++i) st.v[i] = strides[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dp) {
    case 48:
      return launch_width<48>(copy_bytes, B, H, T, S, D, q, k, v, o, lse, st, scale, s);
    case 80:
      return launch_width<80>(copy_bytes, B, H, T, S, D, q, k, v, o, lse, st, scale, s);
    case 160:
      return launch_width<160>(copy_bytes, B, H, T, S, D, q, k, v, o, lse, st, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
