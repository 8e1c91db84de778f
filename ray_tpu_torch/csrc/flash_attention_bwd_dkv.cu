// Flash-attention backward, dk and dv, for Hopper (sm_90a), plain C interface
// for ctypes.
//
// Replaces the Pallas TPU kernel ray_tpu/ops/flash_attention.py
// `_bwd_dkv_kernel` (lines 191-244, launched by `_flash_backward` at line
// 273): for each key, recompute p = exp(s * scale - lse) over the query rows
// (s scaled before the subtraction; masked entries zeroed after the exp,
// causal top-left row >= col also when T != Tk), dp = dO.v and
// ds = p * (dp - delta) * scale, then dv = sum_q p * dO and
// dk = sum_q ds * q, all in float32. lse and delta come in as [B*H, T]
// float32.
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
// 3.35 TB/s. So the kernel is bound by operations.
//
// What this design does about that bound: it is the simple first version.
// One block owns one tile of keys of one (batch, head), keeps K and V in
// shared memory in float32, and loops over 32-row query tiles from the
// first one that holds a row >= the tile's first key (top-left causal) to
// the end. It writes dk and dv once, so no atomics are needed. The float32
// dk and dv accumulators live in registers: each of the 256 threads owns
// BN/16 keys x D/16 columns of each. Two such accumulators of BN x D would
// not fit the registers at D = 256 with 64 keys, so the key tile is 64 for
// D <= 128 and 32 for D = 256. The products are float32 FMA loops on the
// CUDA cores, not the tensor cores: the float32 path must not round through
// TF32 (the reference bound is 5e-5 + 5e-4 |d|). Tensor-core tiles are the
// work that closes the gap.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
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

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dk, void* dv,
             int B, int H, int Tq, int Tk, const long long* st, float scale, int causal,
             cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, dout, lse, delta, dk, dv, B, H, Tq, Tk, st, scale,
                           causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, dout, lse, delta, dk, dv, B, H, Tq, Tk, st, scale,
                            causal, stream);
    case 256:
      return launch<T, 256>(q, k, v, dout, lse, delta, dk, dv, B, H, Tq, Tk, st, scale,
                            causal, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, (batch,
// sequence, head) for q, k, v and dout in that order. Returns the launch's
// cudaError_t (0 on success); the kernel runs on `stream`.
int flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dk, void* dv,
                            int B, int H, int Tq, int Tk, int D, int dtype,
                            long long q_sb, long long q_st, long long q_sh,
                            long long k_sb, long long k_st, long long k_sh,
                            long long v_sb, long long v_st, long long v_sh,
                            long long o_sb, long long o_st, long long o_sh,
                            float scale, int causal, void* stream) {
  const long long st[12] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh,
                            v_sb, v_st, v_sh, o_sb, o_st, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(D, q, k, v, dout, lse, delta, dk, dv, B, H, Tq, Tk, st, scale,
                           causal, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, k, v, dout, lse, delta, dk, dv, B, H, Tq, Tk, st,
                                   scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* rt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
