// Flash-attention backward, dk and dv, for Hopper (sm_90a), plain C interface
// for ctypes.
//
// Replaces the Pallas TPU kernel ray_tpu/ops/flash_attention.py
// `_bwd_dkv_kernel` (lines 191-244, launched by `_flash_backward` at line
// 273): for each key, recompute p = exp(s * scale - lse) over the query rows
// (s scaled before the subtraction; masked entries zeroed after the exp,
// causal top-left row >= col also when T != Tk), dp = dO.v and
// ds = p * (dp - delta) * scale, then dv = sum_q p * dO and
// dk = sum_q ds * q. lse and delta come in as [B*H, T] float32.
//
// Layout: q, k, v and dO are read in the [B, T, H, D] layout through their
// batch, sequence and head strides (D contiguous), so no transposed copy is
// made; dk and dv are written contiguous [B, Tk, H, D] in k's type.
//
// Bound at the main path's shape (B=2, T=Tk=2048, H=32, D=128, causal, bf16),
// from the H100 SXM data sheet: four products (k.q, v.dO, p.dO, ds.q) over
// the 2,098,176 kept (row, key) pairs of each (b, h) are 8*B*H*D*pairs
// ~= 1.38e11 operations, ~0.139 ms at 989 TFLOP/s; the bytes (q, k, v, dO,
// dk and dv at 2 bytes, lse and delta at 4) are ~101 MB, ~0.030 ms at
// 3.35 TB/s. So the kernel is bound by operations, and only the tensor cores
// can approach it.
//
// Two bodies, chosen statically by dtype and head dim (never by a failure):
//
// bf16, D = 64 and 128: `flash_bwd_dkv_tc_kernel`, the four products on the
// tensor cores (mma.sync m16n8k16, bf16 in, float32 accumulators; the helpers
// are in flash_tc.cuh). A block of 4 warps owns 64 keys of one (batch, head),
// 16 keys a warp, and keeps its K and V rows in shared memory as swizzled
// bf16 tiles. Q and dO stream through a two-stage ring of 64-row tiles filled
// by 16-byte cp.async, with each tile's lse and delta (4-byte cp.async), so
// the next tile loads while the current one computes; the loop starts at the
// first query tile that holds a row >= the block's first key (top-left
// causal). A warp takes each tile in sub-blocks of 16 rows: it runs
// S^T = K Q^T and dP^T = V dO^T into float32 registers, forms p and ds there,
// and feeds both, rounded to bf16, straight from the accumulator layout into
// dV += P^T dO and dK += dS^T Q as the A operand: neither touches shared
// memory. The dk and dv accumulators (16 x D float32 each a warp, 128
// registers a thread at D = 128) live in registers and are written once, so
// no atomics are needed; the 16-row sub-blocks keep S^T and dP^T to 16
// registers beside them, which is what keeps ptxas from spilling (32-row
// sub-blocks spilled 44 bytes a thread at D = 128). The grid is (B*H, key
// tiles), so blocks launch in order of rising k0, which under a causal mask
// is the heaviest first.
// Rounding: p and ds are rounded to bf16 before dV += P^T dO and
// dK += dS^T Q (JAX keeps both in float32); ds itself is formed from the
// float32 p. S^T and dP^T are the JAX products exactly up to summation order.
// Not reached yet: wgmma for S^T and dP^T (the two products that do not
// depend on p), and TMA in place of cp.async.
//
// float32 (every D), and bf16 at D = 256: `flash_bwd_dkv_kernel`, float32 FMA
// loops on the CUDA cores. For float32 that is the rule: the path must not
// round through TF32 (the reference bound is 5e-5 + 5e-4 |d|), so it never
// touches the tensor cores. For bf16 at D = 256 the tensor-core body's two
// 16 x 256 float32 accumulators a warp (256 registers a thread) do not fit,
// so that head dim keeps the FMA body until a design splits D across warps.
// One block owns one tile of keys, K and V in shared memory in float32, and
// loops over 32-row query tiles; each of the 256 threads owns BN/16 keys x
// D/16 columns of each accumulator, with BN 64 keys for D <= 128 and 32 for
// D = 256.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_tc.cuh"

namespace {

// ------------------------------------------- float32 body (and bf16 D=256)
constexpr int kBlockQ = 32;    // query rows per staged tile
constexpr int kThreads = 256;  // 16 key groups x 16 column lanes

template <int D>
__host__ __device__ constexpr int block_n() { return D == 256 ? 32 : 64; }  // keys per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <int D>
constexpr size_t smem_bytes() {
  // sK, sV [BN][D+1]; sQ, sdO [BQ][D+1]; sP, sS [BN][BQ+1]; lse, delta [BQ].
  // The +1 pads keep the column reads free of bank conflicts.
  return sizeof(float) * (2 * block_n<D>() * (D + 1) + 2 * kBlockQ * (D + 1) +
                          2 * block_n<D>() * (kBlockQ + 1) + 2 * kBlockQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int H, int Tq, int Tk,
                     long long q_sb, long long q_st, long long q_sh,
                     long long k_sb, long long k_st, long long k_sh,
                     long long v_sb, long long v_st, long long v_sh,
                     long long o_sb, long long o_st, long long o_sh,
                     float scale, int causal) {
  constexpr int BN = block_n<D>();
  constexpr int KR = BN / 16;          // keys per thread
  constexpr int DP = D + 1;
  constexpr int QP = kBlockQ + 1;
  constexpr int NC = kBlockQ / 16;     // score columns (query rows) per thread
  constexpr int ND = D / 16;           // dk/dv columns per thread
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BN * DP;
  float* sQ = sV + BN * DP;
  float* sdO = sQ + kBlockQ * DP;
  float* sP = sdO + kBlockQ * DP;      // p of the current tile, [key][row]
  float* sS = sP + BN * QP;            // ds of the current tile, [key][row]
  float* sL = sS + BN * QP;
  float* sDl = sL + kBlockQ;

  const int tid = threadIdx.x;
  const int rg = tid >> 4;  // keys KR*rg .. KR*rg+KR-1 of the tile
  const int cl = tid & 15;  // columns cl, cl+16, ...
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.x * BN;

  const T* qp = q + b * q_sb + h * q_sh;
  const T* kp = k + b * k_sb + h * k_sh;
  const T* vp = v + b * v_sb + h * v_sh;
  const T* op = dout + b * o_sb + h * o_sh;
  const float* lp = lse + static_cast<long long>(bh) * Tq;
  const float* dlp = delta + static_cast<long long>(bh) * Tq;

  for (int idx = tid; idx < BN * D; idx += kThreads) {
    const int j = idx / D, d = idx - (idx / D) * D;
    const int t = k0 + j;
    const bool in = t < Tk;
    sK[j * DP + d] = in ? to_f32(kp[t * k_st + d]) : 0.f;
    sV[j * DP + d] = in ? to_f32(vp[t * v_st + d]) : 0.f;
  }

  float acc_k[KR][ND], acc_v[KR][ND];
#pragma unroll
  for (int kk = 0; kk < KR; ++kk)
#pragma unroll
    for (int dd = 0; dd < ND; ++dd) acc_k[kk][dd] = acc_v[kk][dd] = 0.f;

  // causal: the first query tile that holds a row >= the tile's first key
  const int q_begin = causal ? (k0 / kBlockQ) * kBlockQ : 0;
  for (int q0 = q_begin; q0 < Tq; q0 += kBlockQ) {
    __syncthreads();  // the previous tile's sQ/sdO/sP/sS/sL readers are done
    for (int idx = tid; idx < kBlockQ * D; idx += kThreads) {
      const int i = idx / D, d = idx - (idx / D) * D;
      const int t = q0 + i;
      const bool in = t < Tq;
      sQ[i * DP + d] = in ? to_f32(qp[t * q_st + d]) : 0.f;
      sdO[i * DP + d] = in ? to_f32(op[t * o_st + d]) : 0.f;
    }
    // rows past Tq have no lse: guard the load, not just the product
    if (tid < kBlockQ) {
      const bool in = q0 + tid < Tq;
      sL[tid] = in ? lp[q0 + tid] : 0.f;
      sDl[tid] = in ? dlp[q0 + tid] : 0.f;
    }
    __syncthreads();

    float s[KR][NC], dp[KR][NC];
#pragma unroll
    for (int kk = 0; kk < KR; ++kk)
#pragma unroll
      for (int c = 0; c < NC; ++c) s[kk][c] = dp[kk][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[KR], vv[KR], qv[NC], ov[NC];
#pragma unroll
      for (int kk = 0; kk < KR; ++kk) {
        kv[kk] = sK[(KR * rg + kk) * DP + d];
        vv[kk] = sV[(KR * rg + kk) * DP + d];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        qv[c] = sQ[(cl + 16 * c) * DP + d];
        ov[c] = sdO[(cl + 16 * c) * DP + d];
      }
#pragma unroll
      for (int kk = 0; kk < KR; ++kk)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          s[kk][c] = fmaf(kv[kk], qv[c], s[kk][c]);
          dp[kk][c] = fmaf(vv[kk], ov[c], dp[kk][c]);
        }
    }

#pragma unroll
    for (int kk = 0; kk < KR; ++kk) {
      const int key = k0 + KR * rg + kk;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int i = cl + 16 * c;
        const int row = q0 + i;
        const bool ok = row < Tq && key < Tk && (!causal || row >= key);
        const float p = ok ? expf(s[kk][c] * scale - sL[i]) : 0.f;
        sP[(KR * rg + kk) * QP + i] = p;
        sS[(KR * rg + kk) * QP + i] = p * (dp[kk][c] - sDl[i]) * scale;
      }
    }
    // sP/sS rows KR*rg.. are written and read only by this key group's 16 lanes
    __syncwarp();

#pragma unroll 4
    for (int i = 0; i < kBlockQ; ++i) {
      float pv[KR], dsv[KR];
#pragma unroll
      for (int kk = 0; kk < KR; ++kk) {
        pv[kk] = sP[(KR * rg + kk) * QP + i];
        dsv[kk] = sS[(KR * rg + kk) * QP + i];
      }
#pragma unroll
      for (int dd = 0; dd < ND; ++dd) {
        const float o = sdO[i * DP + cl + 16 * dd];
        const float qq = sQ[i * DP + cl + 16 * dd];
#pragma unroll
        for (int kk = 0; kk < KR; ++kk) {
          acc_v[kk][dd] = fmaf(pv[kk], o, acc_v[kk][dd]);
          acc_k[kk][dd] = fmaf(dsv[kk], qq, acc_k[kk][dd]);
        }
      }
    }
  }

#pragma unroll
  for (int kk = 0; kk < KR; ++kk) {
    const int key = k0 + KR * rg + kk;
    if (key >= Tk) continue;
    const long long off = ((static_cast<long long>(b) * Tk + key) * H + h) * D;
#pragma unroll
    for (int dd = 0; dd < ND; ++dd) {
      store(dk + off + cl + 16 * dd, acc_k[kk][dd]);
      store(dv + off + cl + 16 * dd, acc_v[kk][dd]);
    }
  }
}

// ------------------------------------------------- bf16 body, D = 64, 128
template <int D>
struct TcTile {
  static_assert(D == 64 || D == 128, "the tensor-core dk/dv body takes D = 64 or 128");
  static constexpr int kBN = 64;              // keys per block, 16 per warp
  static constexpr int kBQ = 64;              // query rows per streamed tile
  static constexpr int kSub = 16;             // query rows per sub-block of a tile
  static constexpr int kThreads = 2 * kBN;    // a warp per 16 keys
  static constexpr int kStages = 2;           // Q/dO ring depth
  static constexpr int kTileK = kBN * D * 2;  // bytes of the K or the V tile
  static constexpr int kTileQ = kBQ * D * 2;  // bytes of one Q or dO tile
  static constexpr int kRow = kBQ * 4;        // bytes of one tile's lse or delta
  // sK, sV, then sQ[kStages], sdO[kStages], sL[kStages], sDl[kStages]
  static constexpr size_t kSmem = 2 * kTileK + kStages * (2 * kTileQ + 2 * kRow);
};

template <int D>
__global__ void __launch_bounds__(TcTile<D>::kThreads)
flash_bwd_dkv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                        int H, int Tq, int Tk,
                        long long q_sb, long long q_st, long long q_sh,
                        long long k_sb, long long k_st, long long k_sh,
                        long long v_sb, long long v_st, long long v_sh,
                        long long o_sb, long long o_st, long long o_sh,
                        float scale, int causal) {
  using namespace flash_tc;
  using C = TcTile<D>;
  constexpr int BN = C::kBN, BQ = C::kBQ, SQ = C::kSub, NT = C::kThreads, S = C::kStages;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  const uint32_t sK = smem_u32(smem_tc);
  const uint32_t sV = sK + C::kTileK;
  const uint32_t sQ0 = sV + C::kTileK;
  const uint32_t sdO0 = sQ0 + S * C::kTileQ;
  const uint32_t sL0 = sdO0 + S * C::kTileQ;
  const uint32_t sDl0 = sL0 + S * C::kRow;
  const float* rowL = reinterpret_cast<const float*>(smem_tc + 2 * C::kTileK + 2 * S * C::kTileQ);
  const float* rowDl = rowL + S * BQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.y * BN;  // rising k0: under a causal mask, heaviest first
  const int w0 = k0 + warp * 16;   // this warp's first key

  const __nv_bfloat16* qp = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kp = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vp = v + b * v_sb + h * v_sh;
  const __nv_bfloat16* op = dout + b * o_sb + h * o_sh;
  const float* lp = lse + static_cast<long long>(bh) * Tq;
  const float* dlp = delta + static_cast<long long>(bh) * Tq;

  // causal: the first query tile that holds a row >= the block's first key
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  const int n_tiles = q_begin < Tq ? (Tq - q_begin + BQ - 1) / BQ : 0;

  // one query tile, rows [q0, q0 + BQ), into ring stage st; rows past Tq have
  // no lse: their loads are guarded (zero-filled) and they add nothing
  auto load_q_tile = [&](int q0, int st) {
    load_tile<D, BQ, NT>(sQ0 + st * C::kTileQ, qp, q_st, q0, Tq, tid);
    load_tile<D, BQ, NT>(sdO0 + st * C::kTileQ, op, o_st, q0, Tq, tid);
    if (tid < 2 * BQ) {
      const int i = tid & (BQ - 1);
      const bool in = q0 + i < Tq;
      const float* src = (tid < BQ ? lp : dlp) + (in ? q0 + i : 0);
      cp_async_4((tid < BQ ? sL0 : sDl0) + st * C::kRow + i * 4, src, in);
    }
  };

  // group 0: this block's K and V rows and the first query tile; then one
  // group for each further tile the ring holds ahead
  load_tile<D, BN, NT>(sK, kp, k_st, k0, Tk, tid);
  load_tile<D, BN, NT>(sV, vp, v_st, k0, Tk, tid);
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < n_tiles) load_q_tile(q_begin + i * BQ, i);
    cp_async_commit();
  }

  // each lane's keys are kr0 = w0 + g and kr1 = kr0 + 8
  const int kr0 = w0 + g, kr1 = kr0 + 8;
  const float scale_log2 = scale * kLog2e;

  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[i][e] = acc_v[i][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int q0 = q_begin + j * BQ;
    const int st = j % S;
    if (j + S - 1 < n_tiles)  // loads while this one computes
      load_q_tile(q0 + (S - 1) * BQ, (j + S - 1) % S);
    cp_async_commit();
    cp_async_wait<S - 1>();  // tile j's group has landed
    __syncthreads();
    const uint32_t sQ = sQ0 + st * C::kTileQ;
    const uint32_t sdO = sdO0 + st * C::kTileQ;
    const float* tL = rowL + st * BQ;
    const float* tDl = rowDl + st * BQ;

    // the tile in sub-blocks of SQ rows, so that only SQ columns of S^T and
    // dP^T are live next to the dk and dv accumulators
#pragma unroll
    for (int sb = 0; sb < BQ / SQ; ++sb) {
      const int r0s = q0 + sb * SQ;                 // the sub-block's first row
      if (causal && r0s + SQ - 1 < w0) continue;    // warp-uniform: wholly before its keys
      // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x SQ rows
      float s[SQ / 8][4], dp[SQ / 8][4];
#pragma unroll
      for (int i = 0; i < SQ / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        uint32_t ka[4], va[4];
        ldsm_x4(ka, tile_addr<D>(sK, warp * 16 + a_row(lane), kc * 16 + a_col(lane)));
        ldsm_x4(va, tile_addr<D>(sV, warp * 16 + a_row(lane), kc * 16 + a_col(lane)));
#pragma unroll
        for (int nb = 0; nb < SQ / 16; ++nb) {
          const int row = sb * SQ + nb * 16 + bn_row(lane);
          uint32_t qb[4], ob[4];
          ldsm_x4(qb, tile_addr<D>(sQ, row, kc * 16 + bn_col(lane)));
          ldsm_x4(ob, tile_addr<D>(sdO, row, kc * 16 + bn_col(lane)));
          mma_16816(s[2 * nb], ka, qb[0], qb[1]);
          mma_16816(s[2 * nb + 1], ka, qb[2], qb[3]);
          mma_16816(dp[2 * nb], va, ob[0], ob[1]);
          mma_16816(dp[2 * nb + 1], va, ob[2], ob[3]);
        }
      }

      // p = exp(s scale - lse), zeroed where masked; ds = p (dp - delta) scale.
      // Only sub-blocks on an edge (ragged rows or keys, or the causal
      // diagonal) mask.
      const bool edge = r0s + SQ > Tq || w0 + 16 > Tk || (causal && r0s < w0 + 15);
#pragma unroll
      for (int nt = 0; nt < SQ / 8; ++nt) {
        const int i = sb * SQ + nt * 8 + 2 * t4;  // row within the tile
        const float2 l2 = *reinterpret_cast<const float2*>(tL + i);
        const float2 d2 = *reinterpret_cast<const float2*>(tDl + i);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = e < 2 ? kr0 : kr1;
          const int row = q0 + i + (e & 1);
          const float l = (e & 1) ? l2.y : l2.x;
          const float dl = (e & 1) ? d2.y : d2.x;
          float p = exp2f(s[nt][e] * scale_log2 - l * kLog2e);
          if (edge && !(row < Tq && key < Tk && (!causal || row >= key))) p = 0.f;
          dp[nt][e] = p * (dp[nt][e] - dl) * scale;
          s[nt][e] = p;
        }
      }

      // dV += P^T dO and dK += dS^T Q: p and ds (bf16) from the accumulators
      // as the A operand, dO and Q as B through transposed ldmatrix
#pragma unroll
      for (int kk = 0; kk < SQ / 16; ++kk) {
        uint32_t pa[4], dsa[4];
        pack_a(pa, s[2 * kk], s[2 * kk + 1]);
        pack_a(dsa, dp[2 * kk], dp[2 * kk + 1]);
        const int row = sb * SQ + kk * 16 + bk_row(lane);
#pragma unroll
        for (int db = 0; db < D / 16; ++db) {
          uint32_t ob[4], qb[4];
          ldsm_x4_t(ob, tile_addr<D>(sdO, row, db * 16 + bk_col(lane)));
          mma_16816(acc_v[2 * db], pa, ob[0], ob[1]);
          mma_16816(acc_v[2 * db + 1], pa, ob[2], ob[3]);
          ldsm_x4_t(qb, tile_addr<D>(sQ, row, db * 16 + bk_col(lane)));
          mma_16816(acc_k[2 * db], dsa, qb[0], qb[1]);
          mma_16816(acc_k[2 * db + 1], dsa, qb[2], qb[3]);
        }
      }
    }
    __syncthreads();  // this stage's readers are done before it is refilled
  }
  cp_async_wait<0>();

  // keys past Tk are not written; keys no query row reaches get zeros
  const long long off0 = ((static_cast<long long>(b) * Tk + kr0) * H + h) * D;
  const long long off1 = ((static_cast<long long>(b) * Tk + kr1) * H + h) * D;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int col = nt * 8 + 2 * t4;
    if (kr0 < Tk) {
      store_bf16x2(dk + off0 + col, acc_k[nt][0], acc_k[nt][1]);
      store_bf16x2(dv + off0 + col, acc_v[nt][0], acc_v[nt][1]);
    }
    if (kr1 < Tk) {
      store_bf16x2(dk + off1 + col, acc_k[nt][2], acc_k[nt][3]);
      store_bf16x2(dv + off1 + col, acc_v[nt][2], acc_v[nt][3]);
    }
  }
}

// ---------------------------------------------------------------- launch
template <typename T, int D>
int launch_fma(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               int B, int H, int Tq, int Tk, const long long* st, float scale, int causal,
               cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  constexpr int BN = block_n<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Tk + BN - 1) / BN, B * H);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), H, Tq, Tk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dk, void* dv,
              int B, int H, int Tq, int Tk, const long long* st, float scale, int causal,
              cudaStream_t stream) {
  using C = TcTile<D>;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_tc_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_k = (Tk + C::kBN - 1) / C::kBN;
  if (n_k > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(B * H, n_k);
  using bf = __nv_bfloat16;
  flash_bwd_dkv_tc_kernel<D><<<grid, C::kThreads, C::kSmem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const bf*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf*>(dk), static_cast<bf*>(dv), H, Tq, Tk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// The static dispatch: bf16 at D = 64, 128 runs the tensor-core body; float32,
// and bf16 at D = 256, the FMA body.
int launch_d(int dtype, int D, const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dk, void* dv, int B, int H, int Tq,
             int Tk, const long long* st, float scale, int causal, cudaStream_t s) {
  if (dtype == 0) {
    switch (D) {
      case 64:
        return launch_fma<float, 64>(q, k, v, dout, lse, delta, dk, dv, B, H, Tq, Tk, st,
                                     scale, causal, s);
      case 128:
        return launch_fma<float, 128>(q, k, v, dout, lse, delta, dk, dv, B, H, Tq, Tk, st,
                                      scale, causal, s);
      case 256:
        return launch_fma<float, 256>(q, k, v, dout, lse, delta, dk, dv, B, H, Tq, Tk, st,
                                      scale, causal, s);
    }
  } else if (dtype == 1) {
    switch (D) {
      case 64:
        return launch_tc<64>(q, k, v, dout, lse, delta, dk, dv, B, H, Tq, Tk, st, scale,
                             causal, s);
      case 128:
        return launch_tc<128>(q, k, v, dout, lse, delta, dk, dv, B, H, Tq, Tk, st, scale,
                              causal, s);
      case 256:
        return launch_fma<__nv_bfloat16, 256>(q, k, v, dout, lse, delta, dk, dv, B, H, Tq, Tk,
                                              st, scale, causal, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, (batch,
// sequence, head) for q, k, v and dout in that order; for bfloat16 every row
// must start 16-byte aligned (else cudaErrorInvalidValue, and nothing runs).
// Returns the launch's cudaError_t (0 on success); the kernel runs on
// `stream`.
int flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dk, void* dv,
                            int B, int H, int Tq, int Tk, int D, int dtype,
                            long long q_sb, long long q_st, long long q_sh,
                            long long k_sb, long long k_st, long long k_sh,
                            long long v_sb, long long v_st, long long v_sh,
                            long long o_sb, long long o_st, long long o_sh,
                            float scale, int causal, void* stream) {
  using flash_tc::rows_aligned16;
  if (dtype == 1 && !(rows_aligned16(q, q_sb, q_st, q_sh) &&
                      rows_aligned16(k, k_sb, k_st, k_sh) &&
                      rows_aligned16(v, v_sb, v_st, v_sh) &&
                      rows_aligned16(dout, o_sb, o_st, o_sh)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[12] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh,
                            v_sb, v_st, v_sh, o_sb, o_st, o_sh};
  return launch_d(dtype, D, q, k, v, dout, lse, delta, dk, dv, B, H, Tq, Tk, st, scale,
                  causal, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of the kernel that (D, dtype) launches, in bytes;
// -1 for a pair the kernel does not take.
int flash_attention_bwd_dkv_smem_bytes(int D, int dtype) {
  if (dtype == 1 && D == 64) return static_cast<int>(TcTile<64>::kSmem);
  if (dtype == 1 && D == 128) return static_cast<int>(TcTile<128>::kSmem);
  if ((dtype == 0 || dtype == 1) && D == 256) return static_cast<int>(smem_bytes<256>());
  if (dtype == 0 && D == 64) return static_cast<int>(smem_bytes<64>());
  if (dtype == 0 && D == 128) return static_cast<int>(smem_bytes<128>());
  return -1;
}

const char* rt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
