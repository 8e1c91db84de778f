// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel ray_tpu/ops/flash_attention.py `_fwd_kernel`
// (lines 49-104, launched by `_flash_forward`, lines 107-140): online-softmax
// attention with out = acc / max(l, 1e-30) and lse = m + log(l), causal
// top-left (row >= col, also when T != Tk), mask value -1e30 with masked
// probabilities zeroed, and key tiles wholly above the diagonal skipped.
//
// Layout: q/k/v are read in the [B, T, H, D] layout through their batch,
// sequence and head strides (D contiguous), so no transposed copy is made.
// out is a contiguous [B, T, H, D] tensor in the input type; lse is slim,
// [B*H, T] float32 (the TPU kernel's 128-lane broadcast was a VMEM layout).
//
// Bound at the main path's shape (B=2, T=Tk=2048, H=32, D=128, causal, bf16),
// from the H100 SXM data sheet: the causal products need
// 2*B*H*D*T*(T+1) ~= 6.9e10 operations, ~0.07 ms at 989 TFLOP/s on the
// tensor cores; the bytes are 4*B*T*H*D*2 + 4*B*H*T ~= 135 MB, ~0.04 ms at
// 3.35 TB/s. So the kernel is bound by operations, and only the tensor cores
// can approach it.
//
// Two bodies, chosen statically by dtype (never by a failure):
//
// bf16 (D = 64, 128, 256): `flash_fwd_tc_kernel`, both products on the
// tensor cores (mma.sync m16n8k16, bf16 in, float32 accumulators; the helpers
// are in flash_tc.cuh). A block of 4 warps owns 64 query rows of one (batch,
// head), 16 rows a warp; two blocks share an SM, out of step with each
// other, so one's softmax overlaps the other's products. Q is copied once by
// cp.async into a swizzled bf16 tile; at D <= 128 each warp then holds its Q
// rows as A fragments in registers for the whole pass, at D = 256 (where the
// 16 x 256 float32 O accumulator takes 128 registers a thread) it re-reads
// them with ldmatrix. K and V stream through a three-stage ring of 64-key
// tiles (32 at D = 256) filled by 16-byte cp.async, two tiles loading while
// one computes. S = Q K^T runs with K's B fragments through plain ldmatrix;
// the online softmax works on the accumulator layout (each lane holds rows
// g and g+8, the row max is reduced over the quad, m, l and O are rescaled
// in registers); p = 2^(s scale log2 e - m) by ex2.approx is packed to bf16
// straight from the accumulators as the A operand of O += P V (pack_a), V's
// B fragments through transposed ldmatrix: P never touches shared memory.
// l sums the unrounded float32 p, as FlashAttention-2 does. Causal: key
// tiles wholly above a warp's rows are skipped, only tiles crossing the
// diagonal or the ragged end col >= Tk pay for the mask, masked p is
// exactly 0, and the grid is (B*H, query tiles) with the tile index
// reversed so the heaviest tiles start first. The output is staged through
// the warp's own rows of the Q tile and stored in 16-byte rows; rows >= Tq
// are not written.
// Rounding: p is rounded to bf16 before P V (JAX keeps it float32); S, the
// softmax and l are float32, and out is rounded to bf16 once.
// Not reached yet: wgmma for S and P V (a warpgroup shares each B read
// where a warp now reads its own), and TMA in place of cp.async.
//
// float32: `flash_fwd_kernel`, float32 FMA loops on the CUDA cores, never the
// tensor cores: the float32 path must not round through TF32 (the reference
// bound is 2e-5). Each block owns 64 query rows of one (batch, head); Q stays
// in shared memory for the whole pass, 32-key K/V tiles are staged there one
// at a time, and the running max, denominator and accumulator live in
// registers (each of the 256 threads owns 4 rows x D/16 output columns).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "flash_tc.cuh"

namespace {

// ------------------------------------------------------------ float32 body
constexpr int kBlockM = 64;    // query rows per block
constexpr int kBlockN = 32;    // keys per staged tile
constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr float kNegBig = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// Reduce across the 16 lanes that share a row group (one half of a warp).
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  // sQ [BM][D+1], sK [BN][D+1], sV [BN][D], sP [BM][BN+1], all float32.
  // The +1 pads keep the column reads of sQ/sK/sP free of bank conflicts.
  return sizeof(float) *
         (kBlockM * (D + 1) + kBlockN * (D + 1) + kBlockN * D + kBlockM * (kBlockN + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse,
                 int H, int Tq, int Tk,
                 long long q_sb, long long q_st, long long q_sh,
                 long long k_sb, long long k_st, long long k_sh,
                 long long v_sb, long long v_st, long long v_sh,
                 float scale, int causal) {
  constexpr int DP = D + 1;
  constexpr int PP = kBlockN + 1;
  constexpr int NC = kBlockN / 16;  // score columns per thread
  constexpr int ND = D / 16;        // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBlockM * DP;
  float* sV = sK + kBlockN * DP;
  float* sP = sV + kBlockN * D;

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

  for (int idx = tid; idx < kBlockM * D; idx += kThreads) {
    const int i = idx / D, d = idx - (idx / D) * D;
    const int t = q0 + i;
    sQ[i * DP + d] = t < Tq ? to_f32(qp[t * q_st + d]) : 0.f;
  }

  float acc[4][ND];
  float m_run[4], l_run[4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    m_run[ii] = kNegBig;
    l_run[ii] = 0.f;
#pragma unroll
    for (int dd = 0; dd < ND; ++dd) acc[ii][dd] = 0.f;
  }

  // causal: a key tile is needed only if its first key is <= the tile's last row
  const int k_end = causal ? min(Tk, q0 + kBlockM) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += kBlockN) {
    __syncthreads();  // the previous tile's sK/sV/sP readers are done
    for (int idx = tid; idx < kBlockN * D; idx += kThreads) {
      const int j = idx / D, d = idx - (idx / D) * D;
      const int t = k0 + j;
      const bool in = t < Tk;
      sK[j * DP + d] = in ? to_f32(kp[t * k_st + d]) : 0.f;
      sV[j * D + d] = in ? to_f32(vp[t * v_st + d]) : 0.f;
    }
    __syncthreads();

    float s[4][NC];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < NC; ++jj) s[ii][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[NC];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) qv[ii] = sQ[(4 * rg + ii) * DP + d];
#pragma unroll
      for (int jj = 0; jj < NC; ++jj) kv[jj] = sK[(cl + 16 * jj) * DP + d];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < NC; ++jj) s[ii][jj] = fmaf(qv[ii], kv[jj], s[ii][jj]);
    }

#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int row = q0 + 4 * rg + ii;
      bool ok[NC];
      float mx = kNegBig;
#pragma unroll
      for (int jj = 0; jj < NC; ++jj) {
        const int col = k0 + cl + 16 * jj;
        ok[jj] = col < Tk && (!causal || row >= col);
        s[ii][jj] = ok[jj] ? s[ii][jj] * scale : kNegBig;
        mx = fmaxf(mx, s[ii][jj]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m_run[ii], mx);
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < NC; ++jj) {
        const float p = ok[jj] ? expf(s[ii][jj] - m_new) : 0.f;
        sP[(4 * rg + ii) * PP + cl + 16 * jj] = p;
        rs += p;
      }
      rs = half_warp_sum(rs);
      const float corr = expf(m_run[ii] - m_new);
      l_run[ii] = l_run[ii] * corr + rs;
      m_run[ii] = m_new;
#pragma unroll
      for (int dd = 0; dd < ND; ++dd) acc[ii][dd] *= corr;
    }
    // sP rows 4*rg.. are written and read only by this row group's 16 lanes
    __syncwarp();

#pragma unroll 4
    for (int j = 0; j < kBlockN; ++j) {
      float pv[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) pv[ii] = sP[(4 * rg + ii) * PP + j];
#pragma unroll
      for (int dd = 0; dd < ND; ++dd) {
        const float vv = sV[j * D + cl + 16 * dd];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) acc[ii][dd] = fmaf(pv[ii], vv, acc[ii][dd]);
      }
    }
  }

#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int row = q0 + 4 * rg + ii;
    if (row >= Tq) continue;
    const float denom = fmaxf(l_run[ii], 1e-30f);
    T* op = out + ((static_cast<long long>(b) * Tq + row) * H + h) * D;
#pragma unroll
    for (int dd = 0; dd < ND; ++dd) store(op + cl + 16 * dd, acc[ii][dd] / denom);
    if (cl == 0) lse[static_cast<long long>(bh) * Tq + row] = m_run[ii] + logf(denom);
  }
}

// --------------------------------------------------------------- bf16 body
template <int D>
struct TcTile {
  static constexpr int kBM = 64;                  // query rows per block, 16 per warp
  static constexpr int kBN = D == 256 ? 32 : 64;  // keys per streamed tile
  static constexpr int kThreads = 2 * kBM;        // a warp per 16 rows
  static constexpr int kStages = 3;               // K/V ring depth
  static constexpr bool kQInRegs = D <= 128;      // Q's A fragments held for the pass
  static constexpr int kTileQ = kBM * D * 2;      // bytes of the Q tile
  static constexpr int kTileK = kBN * D * 2;      // bytes of one K or V tile
  // sQ, then sK[kStages], sV[kStages]
  static constexpr size_t kSmem = kTileQ + 2 * kStages * kTileK;
};

template <int D>
__global__ void __launch_bounds__(TcTile<D>::kThreads)
flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                    float* __restrict__ lse, int H, int Tq, int Tk,
                    long long q_sb, long long q_st, long long q_sh,
                    long long k_sb, long long k_st, long long k_sh,
                    long long v_sb, long long v_st, long long v_sh,
                    float scale, int causal) {
  using namespace flash_tc;
  using C = TcTile<D>;
  constexpr int BM = C::kBM, BN = C::kBN, NT = C::kThreads, S = C::kStages;
  constexpr float kLog2e = 1.4426950408889634f;
  constexpr float kLn2 = 0.6931471805599453f;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  const uint32_t sQ = smem_u32(smem_tc);
  const uint32_t sK0 = sQ + C::kTileQ;
  const uint32_t sV0 = sK0 + S * C::kTileK;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // heaviest causal tiles first
  const int w0 = q0 + warp * 16;                      // this warp's first row
  const int r0 = w0 + g, r1 = r0 + 8;                 // this lane's two rows

  const __nv_bfloat16* qp = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kp = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vp = v + b * v_sb + h * v_sh;

  // causal: a key tile is needed only if its first key is <= the block's last row
  const int k_end = causal ? min(Tk, q0 + BM) : Tk;
  const int n_tiles = (k_end + BN - 1) / BN;

  // one copy group for the Q tile, then one for each K/V tile the ring holds ahead
  load_tile<D, BM, NT>(sQ, qp, q_st, q0, Tq, tid);
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < n_tiles) {
      load_tile<D, BN, NT>(sK0 + i * C::kTileK, kp, k_st, i * BN, Tk, tid);
      load_tile<D, BN, NT>(sV0 + i * C::kTileK, vp, v_st, i * BN, Tk, tid);
    }
    cp_async_commit();
  }

  // this warp's 16 Q rows as A fragments; a warp reads only its own rows of sQ
  uint32_t qa[C::kQInRegs ? D / 16 : 1][4];
  if constexpr (C::kQInRegs) {
    cp_async_wait<S - 1>();  // the Q group has landed
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
      ldsm_x4(qa[kc], tile_addr<D>(sQ, warp * 16 + a_row(lane), kc * 16 + a_col(lane)));
  }

  // m: running row max of s * scale * log2 e; l: this lane's share of the
  // running sum of p (the quad is summed once, at the end)
  const float scale_log2 = scale * kLog2e;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;
  float l0 = 0.f, l1 = 0.f;
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

    // warp-uniform: a warp past Tq or a tile wholly above this warp's rows
    // adds nothing. A tile crossing the diagonal is computed whole and
    // masked: skipping its 16-key groups above the rows split the unrolled
    // products into branches, which cost more than the products saved.
    if (w0 < Tq && (!causal || k0 <= w0 + 15)) {
      // S = Q K^T for this warp's 16 rows x BN keys
      float s[BN / 8][4];
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        uint32_t qf[4];
        if constexpr (C::kQInRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) qf[e] = qa[kc][e];
        } else {
          ldsm_x4(qf, tile_addr<D>(sQ, warp * 16 + a_row(lane), kc * 16 + a_col(lane)));
        }
#pragma unroll
        for (int nb = 0; nb < BN / 16; ++nb) {
          uint32_t kb[4];
          ldsm_x4(kb, tile_addr<D>(sK, nb * 16 + bn_row(lane), kc * 16 + bn_col(lane)));
          mma_16816(s[2 * nb], qf, kb[0], kb[1]);
          mma_16816(s[2 * nb + 1], qf, kb[2], kb[3]);
        }
      }

      // scale into the exp2 domain; only a tile on an edge (the ragged key
      // end or the causal diagonal) masks, to -inf, so that p is exactly 0
      const bool edge = k0 + BN > Tk || (causal && k0 + BN - 1 > w0);
      float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? r0 : r1;
          const int col = k0 + nt * 8 + 2 * t4 + (e & 1);
          float x = s[nt][e] * scale_log2;
          if (edge && !(col < Tk && (!causal || row >= col))) x = -CUDART_INF_F;
          s[nt][e] = x;
          if (e < 2) mx0 = fmaxf(mx0, x);
          else mx1 = fmaxf(mx1, x);
        }
      }
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      // the first tile a row sees has corr 0 (there is nothing to rescale);
      // a row with every key so far masked keeps a zero base and p = 0
      const float c0 = m0 == -CUDART_INF_F ? 0.f : ex2(m0 - mn0);
      const float c1 = m1 == -CUDART_INF_F ? 0.f : ex2(m1 - mn1);
      const float base0 = mn0 == -CUDART_INF_F ? 0.f : mn0;
      const float base1 = mn1 == -CUDART_INF_F ? 0.f : mn1;
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        s[nt][0] = ex2(s[nt][0] - base0);
        s[nt][1] = ex2(s[nt][1] - base0);
        s[nt][2] = ex2(s[nt][2] - base1);
        s[nt][3] = ex2(s[nt][3] - base1);
        rs0 += s[nt][0] + s[nt][1];
        rs1 += s[nt][2] + s[nt][3];
      }
      l0 = l0 * c0 + rs0;
      l1 = l1 * c1 + rs1;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        acc[nt][0] *= c0;
        acc[nt][1] *= c0;
        acc[nt][2] *= c1;
        acc[nt][3] *= c1;
      }

      // O += P V: p (bf16) from the accumulators as the A operand, V as B
      // through transposed ldmatrix
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        uint32_t pa[4];
        pack_a(pa, s[2 * kk], s[2 * kk + 1]);
        const int row = kk * 16 + bk_row(lane);
#pragma unroll
        for (int db = 0; db < D / 16; ++db) {
          uint32_t vb[4];
          ldsm_x4_t(vb, tile_addr<D>(sV, row, db * 16 + bk_col(lane)));
          mma_16816(acc[2 * db], pa, vb[0], vb[1]);
          mma_16816(acc[2 * db + 1], pa, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // this stage's readers are done before it is refilled
  }
  cp_async_wait<0>();

  l0 = fmaxf(quad_sum(l0), 1e-30f);
  l1 = fmaxf(quad_sum(l1), 1e-30f);
  if (t4 == 0) {
    const long long lrow = static_cast<long long>(bh) * Tq;
    if (r0 < Tq) lse[lrow + r0] = m0 * kLn2 + logf(l0);
    if (r1 < Tq) lse[lrow + r1] = m1 * kLn2 + logf(l1);
  }

  // out = acc / l in bf16, staged in this warp's own 16 rows of the Q tile
  // (no other warp reads them), then stored as 16-byte chunks of whole rows
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const uint32_t at = tile_addr<D>(sQ, warp * 16 + g, nt * 8) + 4 * t4;
    st_shared_u32(at, pack_bf16(acc[nt][0] / l0, acc[nt][1] / l0));
    st_shared_u32(at + 8 * D * 2, pack_bf16(acc[nt][2] / l1, acc[nt][3] / l1));
  }
  __syncwarp();
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int row = i / kChunks, ch = i % kChunks;
    const int t = w0 + row;
    if (t < Tq) {
      const uint4 x = ld_shared_u128(tile_addr<D>(sQ, warp * 16 + row, ch * 8));
      *reinterpret_cast<uint4*>(out + ((static_cast<long long>(b) * Tq + t) * H + h) * D +
                                ch * 8) = x;
    }
  }
}

// ---------------------------------------------------------------- launch
template <int D>
int launch_fma(const void* q, const void* k, const void* v, void* out, void* lse,
               int B, int H, int Tq, int Tk, const long long* st, float scale, int causal,
               cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<float, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Tq + kBlockM - 1) / kBlockM, B * H);
  flash_fwd_kernel<float, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), static_cast<float*>(lse),
      H, Tq, Tk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* out, void* lse,
              int B, int H, int Tq, int Tk, const long long* st, float scale, int causal,
              cudaStream_t stream) {
  using C = TcTile<D>;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_tc_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_q = (Tq + C::kBM - 1) / C::kBM;
  if (n_q > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(B * H, n_q);
  using bf = __nv_bfloat16;
  flash_fwd_tc_kernel<D><<<grid, C::kThreads, C::kSmem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<bf*>(out), static_cast<float*>(lse), H, Tq, Tk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// The static dispatch: bf16 runs the tensor-core body, float32 the FMA body.
int launch_d(int dtype, int D, const void* q, const void* k, const void* v, void* out,
             void* lse, int B, int H, int Tq, int Tk, const long long* st, float scale,
             int causal, cudaStream_t s) {
  if (dtype == 0) {
    switch (D) {
      case 64:
        return launch_fma<64>(q, k, v, out, lse, B, H, Tq, Tk, st, scale, causal, s);
      case 128:
        return launch_fma<128>(q, k, v, out, lse, B, H, Tq, Tk, st, scale, causal, s);
      case 256:
        return launch_fma<256>(q, k, v, out, lse, B, H, Tq, Tk, st, scale, causal, s);
    }
  } else if (dtype == 1) {
    switch (D) {
      case 64:
        return launch_tc<64>(q, k, v, out, lse, B, H, Tq, Tk, st, scale, causal, s);
      case 128:
        return launch_tc<128>(q, k, v, out, lse, B, H, Tq, Tk, st, scale, causal, s);
      case 256:
        return launch_tc<256>(q, k, v, out, lse, B, H, Tq, Tk, st, scale, causal, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, (batch,
// sequence, head) for q, k and v in that order; for bfloat16 every row must
// start 16-byte aligned (else cudaErrorInvalidValue, and nothing runs).
// Returns the launch's cudaError_t (0 on success); the kernel runs on
// `stream`.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                        int B, int H, int Tq, int Tk, int D, int dtype,
                        long long q_sb, long long q_st, long long q_sh,
                        long long k_sb, long long k_st, long long k_sh,
                        long long v_sb, long long v_st, long long v_sh,
                        float scale, int causal, void* stream) {
  using flash_tc::rows_aligned16;
  if (dtype == 1 && !(rows_aligned16(q, q_sb, q_st, q_sh) &&
                      rows_aligned16(k, k_sb, k_st, k_sh) &&
                      rows_aligned16(v, v_sb, v_st, v_sh)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[9] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh};
  return launch_d(dtype, D, q, k, v, out, lse, B, H, Tq, Tk, st, scale, causal,
                  static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory of the kernel that (D, dtype) launches, in bytes;
// -1 for a pair the kernel does not take.
int flash_attention_fwd_smem_bytes(int D, int dtype) {
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
