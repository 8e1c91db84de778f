// Flash-attention backward, dq, for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel ray_tpu/ops/flash_attention.py
// `_bwd_dq_kernel` (lines 144-188, launched by `_flash_backward` at line
// 258): for each query row, recompute p = exp(s * scale - lse) over the keys
// (s = q.k, scaled before the subtraction; masked entries zeroed after the
// exp, causal top-left row >= col also when T != Tk), dp = dO.v,
// ds = p * (dp - delta) * scale and dq = sum_k ds * k. delta = rowsum(dO * O)
// comes in precomputed, [B*H, T] float32, as lse does.
//
// Layout: q, k, v and dO are read in the [B, T, H, D] layout through their
// batch, sequence and head strides (D contiguous), so no transposed copy is
// made; dq is written contiguous [B, T, H, D] in q's type.
//
// Bound at the main path's shape (B=2, T=Tk=2048, H=32, D=128, causal, bf16),
// from the H100 SXM data sheet: three products (q.k, dO.v, ds.k) over the
// 2,098,176 kept (row, key) pairs of each (b, h) are 6*B*H*D*pairs ~= 1.03e11
// operations, ~0.104 ms at 989 TFLOP/s; the bytes (q, k, v, dO and dq at
// 2 bytes, lse and delta at 4) are ~85 MB, ~0.025 ms at 3.35 TB/s. So the
// kernel is bound by operations, and only the tensor cores can approach it.
//
// Two bodies, chosen statically by dtype (never by a failure):
//
// bf16 (D = 64, 128, 256): `flash_bwd_dq_tc_kernel`, the three products on
// the tensor cores (mma.sync m16n8k16, bf16 in, float32 accumulators; the
// helpers are in flash_tc.cuh). A block of 4 warps owns 64 query rows of one
// (batch, head), 16 rows a warp, and keeps its Q and dO rows in shared memory
// as swizzled bf16 tiles for the whole pass. K and V stream through a
// two-stage ring of 64-key tiles (32 at D = 256) filled by 16-byte cp.async,
// so the next tile loads while the current one computes. A warp takes each
// tile in sub-blocks of 32 keys: it runs S = Q K^T and dP = dO V^T into
// float32 registers, forms p and ds there, and feeds ds, rounded to bf16,
// straight from the accumulator layout into dQ += dS K as the A operand: ds
// never touches shared memory. The dq accumulator (16 x D float32 a warp, 64
// registers a thread at D = 128) lives in registers and is written once, so
// no atomics are needed (the reason JAX split the backward in two); the
// 32-key sub-blocks keep S and dP to 32 registers beside it, which is what
// keeps ptxas from spilling (64-key sub-blocks spilled 144 bytes a thread at
// D = 128). The grid is (B*H, query tiles) with the tile index reversed,
// so the causal tiles with the most keys start first and the grid ends on
// light ones.
// Rounding: p stays float32 here; ds is rounded to bf16 before dQ += dS K
// (JAX keeps ds in float32). K and V are bf16 as given, so S and dP are the
// JAX products exactly up to summation order.
// Not reached yet: wgmma for S and dP (the two products that do not depend
// on p), and TMA in place of cp.async.
//
// float32: `flash_bwd_dq_kernel`, float32 FMA loops on the CUDA cores, never
// the tensor cores: the float32 path must not round through TF32 (the
// reference bound is 5e-5 + 5e-4 |dq|). One block owns 64 query rows and
// loops over 32-key tiles up to the causal limit, q and dO staged in shared
// memory in float32, each of the 256 threads owning 4 rows x D/16 columns of
// the dq accumulator.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_tc.cuh"

namespace {

// ------------------------------------------------------------ float32 body
constexpr int kBlockM = 64;    // query rows per block
constexpr int kBlockN = 32;    // keys per staged tile
constexpr int kThreads = 256;  // 16 row groups x 16 column lanes

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

template <int D>
constexpr size_t smem_bytes() {
  // sQ, sdO [BM][D+1]; sK, sV [BN][D+1]; sS [BM][BN+1], all float32.
  // The +1 pads keep the column reads free of bank conflicts.
  return sizeof(float) *
         (2 * kBlockM * (D + 1) + 2 * kBlockN * (D + 1) + kBlockM * (kBlockN + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int H, int Tq, int Tk,
                    long long q_sb, long long q_st, long long q_sh,
                    long long k_sb, long long k_st, long long k_sh,
                    long long v_sb, long long v_st, long long v_sh,
                    long long o_sb, long long o_st, long long o_sh,
                    float scale, int causal) {
  constexpr int DP = D + 1;
  constexpr int SP = kBlockN + 1;
  constexpr int NC = kBlockN / 16;  // score columns per thread
  constexpr int ND = D / 16;        // dq columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + kBlockM * DP;
  float* sK = sdO + kBlockM * DP;
  float* sV = sK + kBlockN * DP;
  float* sS = sV + kBlockN * DP;  // ds of the current tile

  const int tid = threadIdx.x;
  const int rg = tid >> 4;  // rows 4*rg .. 4*rg+3 of the tile
  const int cl = tid & 15;  // columns cl, cl+16, ...
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kBlockM;

  const T* qp = q + b * q_sb + h * q_sh;
  const T* kp = k + b * k_sb + h * k_sh;
  const T* vp = v + b * v_sb + h * v_sh;
  const T* op = dout + b * o_sb + h * o_sh;

  for (int idx = tid; idx < kBlockM * D; idx += kThreads) {
    const int i = idx / D, d = idx - (idx / D) * D;
    const int t = q0 + i;
    const bool in = t < Tq;
    sQ[i * DP + d] = in ? to_f32(qp[t * q_st + d]) : 0.f;
    sdO[i * DP + d] = in ? to_f32(op[t * o_st + d]) : 0.f;
  }

  // rows past Tq have no lse: their loads are guarded and they add nothing
  float row_lse[4], row_delta[4];
  float acc[4][ND];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int row = q0 + 4 * rg + ii;
    const bool in = row < Tq;
    row_lse[ii] = in ? lse[static_cast<long long>(bh) * Tq + row] : 0.f;
    row_delta[ii] = in ? delta[static_cast<long long>(bh) * Tq + row] : 0.f;
#pragma unroll
    for (int dd = 0; dd < ND; ++dd) acc[ii][dd] = 0.f;
  }

  // causal: a key tile is needed only if its first key is <= the tile's last row
  const int k_end = causal ? min(Tk, q0 + kBlockM) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += kBlockN) {
    __syncthreads();  // the previous tile's sK/sV/sS readers are done
    for (int idx = tid; idx < kBlockN * D; idx += kThreads) {
      const int j = idx / D, d = idx - (idx / D) * D;
      const int t = k0 + j;
      const bool in = t < Tk;
      sK[j * DP + d] = in ? to_f32(kp[t * k_st + d]) : 0.f;
      sV[j * DP + d] = in ? to_f32(vp[t * v_st + d]) : 0.f;
    }
    __syncthreads();

    float s[4][NC], dp[4][NC];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < NC; ++jj) s[ii][jj] = dp[ii][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[NC], vv[NC];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        qv[ii] = sQ[(4 * rg + ii) * DP + d];
        ov[ii] = sdO[(4 * rg + ii) * DP + d];
      }
#pragma unroll
      for (int jj = 0; jj < NC; ++jj) {
        kv[jj] = sK[(cl + 16 * jj) * DP + d];
        vv[jj] = sV[(cl + 16 * jj) * DP + d];
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < NC; ++jj) {
          s[ii][jj] = fmaf(qv[ii], kv[jj], s[ii][jj]);
          dp[ii][jj] = fmaf(ov[ii], vv[jj], dp[ii][jj]);
        }
    }

#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int row = q0 + 4 * rg + ii;
#pragma unroll
      for (int jj = 0; jj < NC; ++jj) {
        const int col = k0 + cl + 16 * jj;
        const bool ok = row < Tq && col < Tk && (!causal || row >= col);
        const float p = ok ? expf(s[ii][jj] * scale - row_lse[ii]) : 0.f;
        sS[(4 * rg + ii) * SP + cl + 16 * jj] = p * (dp[ii][jj] - row_delta[ii]) * scale;
      }
    }
    // sS rows 4*rg.. are written and read only by this row group's 16 lanes
    __syncwarp();

#pragma unroll 4
    for (int j = 0; j < kBlockN; ++j) {
      float dsv[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) dsv[ii] = sS[(4 * rg + ii) * SP + j];
#pragma unroll
      for (int dd = 0; dd < ND; ++dd) {
        const float kk = sK[j * DP + cl + 16 * dd];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) acc[ii][dd] = fmaf(dsv[ii], kk, acc[ii][dd]);
      }
    }
  }

#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int row = q0 + 4 * rg + ii;
    if (row >= Tq) continue;
    T* dp_out = dq + ((static_cast<long long>(b) * Tq + row) * H + h) * D;
#pragma unroll
    for (int dd = 0; dd < ND; ++dd) store(dp_out + cl + 16 * dd, acc[ii][dd]);
  }
}

// --------------------------------------------------------------- bf16 body
template <int D>
struct TcTile {
  static constexpr int kBM = 64;                  // query rows per block, 16 per warp
  static constexpr int kBN = D == 256 ? 32 : 64;  // keys per streamed tile
  static constexpr int kSub = 32;                 // keys per sub-block of a tile
  static constexpr int kThreads = 2 * kBM;        // a warp per 16 rows
  static constexpr int kStages = 2;               // K/V ring depth
  static constexpr int kTileQ = kBM * D * 2;      // bytes of one Q or dO tile
  static constexpr int kTileK = kBN * D * 2;      // bytes of one K or V tile
  // sQ, sdO, then sK[kStages], sV[kStages]
  static constexpr size_t kSmem = 2 * kTileQ + 2 * kStages * kTileK;
};

template <int D>
__global__ void __launch_bounds__(TcTile<D>::kThreads)
flash_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, int H, int Tq, int Tk,
                       long long q_sb, long long q_st, long long q_sh,
                       long long k_sb, long long k_st, long long k_sh,
                       long long v_sb, long long v_st, long long v_sh,
                       long long o_sb, long long o_st, long long o_sh,
                       float scale, int causal) {
  using namespace flash_tc;
  using C = TcTile<D>;
  constexpr int BM = C::kBM, BN = C::kBN, SB = C::kSub, NT = C::kThreads, S = C::kStages;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  const uint32_t sQ = smem_u32(smem_tc);
  const uint32_t sdO = sQ + C::kTileQ;
  const uint32_t sK0 = sdO + C::kTileQ;
  const uint32_t sV0 = sK0 + C::kStages * C::kTileK;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // heaviest causal tiles first
  const int w0 = q0 + warp * 16;                      // this warp's first row

  const __nv_bfloat16* qp = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kp = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vp = v + b * v_sb + h * v_sh;
  const __nv_bfloat16* op = dout + b * o_sb + h * o_sh;

  // causal: a key tile is needed only if its first key is <= the block's last row
  const int k_end = causal ? min(Tk, q0 + BM) : Tk;
  const int n_tiles = (k_end + BN - 1) / BN;

  // group 0: this block's Q and dO rows and the first K/V tile; then one
  // group for each further tile the ring holds ahead
  load_tile<D, BM, NT>(sQ, qp, q_st, q0, Tq, tid);
  load_tile<D, BM, NT>(sdO, op, o_st, q0, Tq, tid);
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < n_tiles) {
      load_tile<D, BN, NT>(sK0 + i * C::kTileK, kp, k_st, i * BN, Tk, tid);
      load_tile<D, BN, NT>(sV0 + i * C::kTileK, vp, v_st, i * BN, Tk, tid);
    }
    cp_async_commit();
  }

  // each lane's rows are r0 = w0 + g and r1 = r0 + 8; rows past Tq have no
  // lse: their loads are guarded and they add nothing
  const int r0 = w0 + g, r1 = r0 + 8;
  const long long lrow = static_cast<long long>(bh) * Tq;
  const float scale_log2 = scale * kLog2e;
  const float lse0 = r0 < Tq ? lse[lrow + r0] * kLog2e : 0.f;
  const float lse1 = r1 < Tq ? lse[lrow + r1] * kLog2e : 0.f;
  const float dl0 = r0 < Tq ? delta[lrow + r0] : 0.f;
  const float dl1 = r1 < Tq ? delta[lrow + r1] : 0.f;

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BN;
    const int st = j % S;
    if (j + S - 1 < n_tiles) {  // loads while this one computes
      const int ahead = (j + S - 1) % S;
      load_tile<D, BN, NT>(sK0 + ahead * C::kTileK, kp, k_st, k0 + (S - 1) * BN, Tk, tid);
      load_tile<D, BN, NT>(sV0 + ahead * C::kTileK, vp, v_st, k0 + (S - 1) * BN, Tk, tid);
    }
    cp_async_commit();
    cp_async_wait<S - 1>();  // tile j's group has landed
    __syncthreads();
    const uint32_t sK = sK0 + st * C::kTileK;
    const uint32_t sV = sV0 + st * C::kTileK;

    // the tile in sub-blocks of SB keys, so that only SB columns of S and dP
    // are live next to the dq accumulator
#pragma unroll
    for (int sb = 0; sb < BN / SB; ++sb) {
      const int c0 = k0 + sb * SB;                  // the sub-block's first key
      if (causal && c0 > w0 + 15) continue;         // warp-uniform: wholly above its rows
      // S = Q K^T and dP = dO V^T for this warp's 16 rows x SB keys
      float s[SB / 8][4], dp[SB / 8][4];
#pragma unroll
      for (int i = 0; i < SB / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        uint32_t qa[4], oa[4];
        ldsm_x4(qa, tile_addr<D>(sQ, warp * 16 + a_row(lane), kc * 16 + a_col(lane)));
        ldsm_x4(oa, tile_addr<D>(sdO, warp * 16 + a_row(lane), kc * 16 + a_col(lane)));
#pragma unroll
        for (int nb = 0; nb < SB / 16; ++nb) {
          const int row = sb * SB + nb * 16 + bn_row(lane);
          uint32_t kb[4], vb[4];
          ldsm_x4(kb, tile_addr<D>(sK, row, kc * 16 + bn_col(lane)));
          ldsm_x4(vb, tile_addr<D>(sV, row, kc * 16 + bn_col(lane)));
          mma_16816(s[2 * nb], qa, kb[0], kb[1]);
          mma_16816(s[2 * nb + 1], qa, kb[2], kb[3]);
          mma_16816(dp[2 * nb], oa, vb[0], vb[1]);
          mma_16816(dp[2 * nb + 1], oa, vb[2], vb[3]);
        }
      }

      // p = exp(s scale - lse), zeroed where masked; ds = p (dp - delta) scale.
      // Only sub-blocks on an edge (ragged rows or keys, or the causal
      // diagonal) mask.
      const bool edge = c0 + SB > Tk || w0 + 16 > Tq || (causal && c0 + SB - 1 > w0);
#pragma unroll
      for (int nt = 0; nt < SB / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? r0 : r1;
          const int col = c0 + nt * 8 + 2 * t4 + (e & 1);
          float p = exp2f(s[nt][e] * scale_log2 - (e < 2 ? lse0 : lse1));
          if (edge && !(row < Tq && col < Tk && (!causal || row >= col))) p = 0.f;
          dp[nt][e] = p * (dp[nt][e] - (e < 2 ? dl0 : dl1)) * scale;
        }
      }

      // dQ += dS K: ds (bf16) from the accumulators as the A operand, K as B
      // through transposed ldmatrix
#pragma unroll
      for (int kk = 0; kk < SB / 16; ++kk) {
        uint32_t dsa[4];
        pack_a(dsa, dp[2 * kk], dp[2 * kk + 1]);
        const int row = sb * SB + kk * 16 + bk_row(lane);
#pragma unroll
        for (int db = 0; db < D / 16; ++db) {
          uint32_t kb[4];
          ldsm_x4_t(kb, tile_addr<D>(sK, row, db * 16 + bk_col(lane)));
          mma_16816(acc[2 * db], dsa, kb[0], kb[1]);
          mma_16816(acc[2 * db + 1], dsa, kb[2], kb[3]);
        }
      }
    }
    __syncthreads();  // this stage's readers are done before it is refilled
  }
  cp_async_wait<0>();

  __nv_bfloat16* dq0 = dq + ((static_cast<long long>(b) * Tq + r0) * H + h) * D;
  __nv_bfloat16* dq1 = dq + ((static_cast<long long>(b) * Tq + r1) * H + h) * D;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int col = nt * 8 + 2 * t4;
    if (r0 < Tq) store_bf16x2(dq0 + col, acc[nt][0], acc[nt][1]);
    if (r1 < Tq) store_bf16x2(dq1 + col, acc[nt][2], acc[nt][3]);
  }
}

// ---------------------------------------------------------------- launch
template <typename T, int D>
int launch_fma(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dq, int B, int H, int Tq, int Tk,
               const long long* st, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Tq + kBlockM - 1) / kBlockM, B * H);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), H, Tq, Tk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int H, int Tq, int Tk,
              const long long* st, float scale, int causal, cudaStream_t stream) {
  using C = TcTile<D>;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_tc_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_q = (Tq + C::kBM - 1) / C::kBM;
  if (n_q > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(B * H, n_q);
  using bf = __nv_bfloat16;
  flash_bwd_dq_tc_kernel<D><<<grid, C::kThreads, C::kSmem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const bf*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf*>(dq), H, Tq, Tk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// The static dispatch: bf16 runs the tensor-core body, float32 the FMA body.
int launch_d(int dtype, int D, const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dq, int B, int H, int Tq, int Tk,
             const long long* st, float scale, int causal, cudaStream_t s) {
  if (dtype == 0) {
    switch (D) {
      case 64:
        return launch_fma<float, 64>(q, k, v, dout, lse, delta, dq, B, H, Tq, Tk, st, scale,
                                     causal, s);
      case 128:
        return launch_fma<float, 128>(q, k, v, dout, lse, delta, dq, B, H, Tq, Tk, st, scale,
                                      causal, s);
      case 256:
        return launch_fma<float, 256>(q, k, v, dout, lse, delta, dq, B, H, Tq, Tk, st, scale,
                                      causal, s);
    }
  } else if (dtype == 1) {
    switch (D) {
      case 64:
        return launch_tc<64>(q, k, v, dout, lse, delta, dq, B, H, Tq, Tk, st, scale, causal, s);
      case 128:
        return launch_tc<128>(q, k, v, dout, lse, delta, dq, B, H, Tq, Tk, st, scale, causal, s);
      case 256:
        return launch_tc<256>(q, k, v, dout, lse, delta, dq, B, H, Tq, Tk, st, scale, causal, s);
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
int flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dq,
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
  return launch_d(dtype, D, q, k, v, dout, lse, delta, dq, B, H, Tq, Tk, st, scale, causal,
                  static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of the kernel that (D, dtype) launches, in bytes;
// -1 for a pair the kernel does not take.
int flash_attention_bwd_dq_smem_bytes(int D, int dtype) {
  if (D != 64 && D != 128 && D != 256) return -1;
  if (dtype == 0)
    return static_cast<int>(D == 64 ? smem_bytes<64>() : D == 128 ? smem_bytes<128>()
                                                                  : smem_bytes<256>());
  if (dtype == 1)
    return static_cast<int>(D == 64 ? TcTile<64>::kSmem : D == 128 ? TcTile<128>::kSmem
                                                                   : TcTile<256>::kSmem);
  return -1;
}

const char* rt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
