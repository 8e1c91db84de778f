// Flash-attention backward, dq, for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel ray_tpu/ops/flash_attention.py
// `_bwd_dq_kernel` (lines 144-188, launched by `_flash_backward` at line
// 258): for each query row, recompute p = exp(s * scale - lse) over the keys
// (s = q.k, scaled before the subtraction; masked entries zeroed after the
// exp, causal top-left row >= col also when T != Tk), dp = dO.v,
// ds = p * (dp - delta) * scale and dq = sum_k ds * k, all in float32.
// delta = rowsum(dO * O) comes in precomputed, [B*H, T] float32, as lse does.
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
// kernel is bound by operations.
//
// What this design does about that bound: it is the simple first version,
// the forward kernel's shape. One block owns 64 query rows of one
// (batch, head) and loops over 32-key tiles up to the causal limit; it
// writes dq once, so no atomics are needed (the reason JAX split the
// backward in two). q and dO stay in shared memory in float32 for the whole
// pass, K/V tiles are staged one at a time, and each of the 256 threads
// owns 4 rows x D/16 columns of the float32 dq accumulator in registers.
// The products are float32 FMA loops on the CUDA cores, not the tensor
// cores: the float32 path must not round through TF32 (the reference bound
// is 5e-5 + 5e-4 |dq|). Tensor-core tiles are the work that closes the gap.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;    // query rows per block
constexpr int kBlockN = 32;    // keys per staged tile
constexpr int kThreads = 256;  // 16 row groups x 16 column lanes

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
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

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dq, int B, int H, int Tq, int Tk,
             const long long* st, float scale, int causal, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, dout, lse, delta, dq, B, H, Tq, Tk, st, scale, causal,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, dout, lse, delta, dq, B, H, Tq, Tk, st, scale, causal,
                            stream);
    case 256:
      return launch<T, 256>(q, k, v, dout, lse, delta, dq, B, H, Tq, Tk, st, scale, causal,
                            stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, (batch,
// sequence, head) for q, k, v and dout in that order. Returns the launch's
// cudaError_t (0 on success); the kernel runs on `stream`.
int flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dq,
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
    return launch_d<float>(D, q, k, v, dout, lse, delta, dq, B, H, Tq, Tk, st, scale,
                           causal, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, k, v, dout, lse, delta, dq, B, H, Tq, Tk, st,
                                   scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* rt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
