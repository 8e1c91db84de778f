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
// 3.35 TB/s. So the kernel is bound by operations.
//
// What this design does about that bound: it is the simple first version.
// Each block owns 64 query rows of one (batch, head); Q stays in shared
// memory in float32 for the whole pass, and 32-key K/V tiles are staged
// there one at a time, so each input byte is read from device memory once
// per query tile and the [T, Tk] score matrix never leaves the block.  The
// running max, denominator and the float32 accumulator live in registers
// (each of the 256 threads owns 4 rows x D/16 output columns).  The two
// products per tile are float32 FMA loops on the CUDA cores, not the tensor
// cores: the float32 path must not round through TF32 (the reference bound
// is 2e-5), and moving the bf16 path onto mma/wgmma with TMA-fed tiles is
// the work that closes the gap to the operation bound.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;    // query rows per block
constexpr int kBlockN = 32;    // keys per staged tile
constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr float kNegBig = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int B, int H, int Tq, int Tk,
           long long q_sb, long long q_st, long long q_sh,
           long long k_sb, long long k_st, long long k_sh,
           long long v_sb, long long v_st, long long v_sh,
           float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Tq + kBlockM - 1) / kBlockM, B * H);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), H, Tq, Tk,
      q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* out, void* lse,
             int B, int H, int Tq, int Tk,
             long long q_sb, long long q_st, long long q_sh,
             long long k_sb, long long k_st, long long k_sh,
             long long v_sb, long long v_st, long long v_sh,
             float scale, int causal, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, out, lse, B, H, Tq, Tk, q_sb, q_st, q_sh, k_sb, k_st,
                           k_sh, v_sb, v_st, v_sh, scale, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, lse, B, H, Tq, Tk, q_sb, q_st, q_sh, k_sb, k_st,
                            k_sh, v_sb, v_st, v_sh, scale, causal, stream);
    case 256:
      return launch<T, 256>(q, k, v, out, lse, B, H, Tq, Tk, q_sb, q_st, q_sh, k_sb, k_st,
                            k_sh, v_sb, v_st, v_sh, scale, causal, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. Returns the
// launch's cudaError_t (0 on success); the kernel runs on `stream`.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                        int B, int H, int Tq, int Tk, int D, int dtype,
                        long long q_sb, long long q_st, long long q_sh,
                        long long k_sb, long long k_st, long long k_sh,
                        long long v_sb, long long v_st, long long v_sh,
                        float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(D, q, k, v, out, lse, B, H, Tq, Tk, q_sb, q_st, q_sh, k_sb, k_st,
                           k_sh, v_sb, v_st, v_sh, scale, causal, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, k, v, out, lse, B, H, Tq, Tk, q_sb, q_st, q_sh,
                                   k_sb, k_st, k_sh, v_sb, v_st, v_sh, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* rt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
