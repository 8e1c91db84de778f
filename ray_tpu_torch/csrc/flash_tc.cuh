// Tensor-core building blocks for the flash-attention kernels on Hopper
// (sm_90a), written as inline PTX: 16-byte cp.async copies into XOR-swizzled
// bf16 tiles, ldmatrix (plain and transposed) out of them, and the warp-level
// bf16 product mma.sync.aligned.m16n8k16 with float32 accumulators.
//
// Fragment layouts of m16n8k16 (lane = 4 * g + t, g = lane / 4, t = lane % 4):
//   A (16 x 16, row major), 4 registers of 2 bf16: a0 (g, 2t..2t+1),
//     a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..);
//   B (16 x 8, k x n), 2 registers: b0 (2t..2t+1, g), b1 (2t+8.., g);
//   C/D (16 x 8, float32), 4 registers: c0, c1 (g, 2t..2t+1), c2, c3 (g+8, ..).
// So the accumulators of two neighbouring 8-column tiles are, packed to bf16,
// the A operand of the next product over those 16 columns (pack_a), which is
// how p and ds go from one product to the next without leaving registers,
// and a row's values are spread over the four lanes of its quad (quad_max,
// quad_sum).
//
// Tiles hold R rows of D bf16 (D / 8 chunks of 16 bytes). Chunk c of row r is
// stored at chunk c ^ (r % 8): the eight rows that one ldmatrix phase reads at
// one logical chunk land in eight different 16-byte bank groups, and the
// eight chunks that eight neighbouring threads copy of one row do too.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace flash_tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Shared address of element (row, col) of a swizzled tile of rows of D bf16;
// col is a multiple of 8 (the start of a 16-byte chunk).
template <int D>
__device__ __forceinline__ uint32_t tile_addr(uint32_t base, int row, int col) {
  return base + static_cast<uint32_t>(row * (D * 2) + ((((col >> 3) ^ (row & 7))) << 4));
}

// 16-byte global -> shared copy; with pred false the 16 bytes are zero-filled
// and nothing is read.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(pred ? 16 : 0) : "memory");
}

// 4-byte global -> shared copy, zero-filled when pred is false.
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(pred ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Rows [t0, t0 + R) of a [T, D] bf16 matrix whose rows are `ld` elements
// apart (D contiguous) into the swizzled R x D tile at `dst`, one 16-byte
// cp.async per chunk; rows >= T are zero-filled.
template <int D, int R, int kThreads>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src, long long ld,
                                          int t0, int T, int tid) {
  constexpr int kChunks = D / 8;
  static_assert((R * kChunks) % kThreads == 0, "tile chunks must split evenly over threads");
#pragma unroll
  for (int i = 0; i < R * kChunks / kThreads; ++i) {
    const int idx = tid + i * kThreads;
    const int row = idx / kChunks, ch = idx % kChunks;
    const int t = t0 + row;
    const bool in = t < T;
    const __nv_bfloat16* p = src + (in ? static_cast<long long>(t) * ld : 0LL) + ch * 8;
    cp_async_16(tile_addr<D>(dst, row, ch * 8), p, in);
  }
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// and register i of each lane holds its (lane / 4, 2 (lane % 4) ..) pair.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// The same, each matrix transposed: register i holds the (2 (lane % 4) ..,
// lane / 4) pair of matrix i.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d += a b on the tensor cores: bf16 operands, float32 accumulators.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The accumulators of 8-column tiles 2kk and 2kk+1 as the A operand of a
// product whose depth runs over those 16 columns.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// Lane offsets into a 16 x 16 block for ldmatrix.x4 (row, col):
// A operand stored [m][k]                      -> a0..a3;
__device__ __forceinline__ int a_row(int lane) { return lane & 15; }
__device__ __forceinline__ int a_col(int lane) { return (lane >> 4) << 3; }
// B operand of two n8 tiles stored [n][k] (plain) -> b0, b1 of tile 0, then of tile 1;
__device__ __forceinline__ int bn_row(int lane) { return (lane & 7) + ((lane >> 4) << 3); }
__device__ __forceinline__ int bn_col(int lane) { return ((lane >> 3) & 1) << 3; }
// B operand of two n8 tiles stored [k][n] (transposed) -> b0, b1 of tile 0, then of tile 1.
__device__ __forceinline__ int bk_row(int lane) { return (lane & 7) + (((lane >> 3) & 1) << 3); }
__device__ __forceinline__ int bk_col(int lane) { return (lane >> 4) << 3; }

// Store two floats as bf16x2 (4 bytes, aligned: col is even, D is a multiple of 8).
__device__ __forceinline__ void store_bf16x2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Shared-memory store of 4 bytes and load of 16 bytes at a shared address.
__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t x) {
  asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(addr), "r"(x) : "memory");
}
__device__ __forceinline__ uint4 ld_shared_u128(uint32_t addr) {
  uint4 r;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "r"(addr) : "memory");
  return r;
}

// 2^x by the special-function unit alone (ex2.approx, flushing subnormal
// results to zero); 2^-inf is +0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Max and sum over the four lanes of an m16n8k16 quad (the lanes 4g..4g+3
// that hold one accumulator row).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Whether every row of a bf16 [B, T, H, D] tensor read through these
// (batch, sequence, head) strides, in elements, starts 16-byte aligned, as
// the 16-byte cp.async copies need. The launchers refuse anything else.
inline bool rows_aligned16(const void* p, long long sb, long long st, long long sh) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 8 == 0 && st % 8 == 0 &&
         sh % 8 == 0;
}

}  // namespace flash_tc
