// Device helpers shared by the port's CUDA kernels (sm_90a): dtype
// conversion, cp.async copies, ldmatrix loads and the tensor-core products
// (m16n8k16 bf16, m16n8k32 int8), with the register layouts they imply.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace aaclip {

using bf16 = __nv_bfloat16;

__host__ __device__ constexpr size_t round_up(size_t n, size_t m) {
  return (n + m - 1) / m * m;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) { return __float2bfloat16(v); }

// Two floats as one bf16x2 register: a in the low half (lower column).
__device__ __forceinline__ unsigned pack_bf16x2(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; with src_bytes = 0 it writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 bf16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i, and register r[i] receives, per lane l, row l / 4,
// columns 2(l % 4) and 2(l % 4) + 1 of matrix i (transposed: row and column
// swapped).
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* lane_row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(lane_row)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* lane_row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(lane_row)));
}

// The lane's row address for a 16x16 tile at `tile` (row stride ld) such
// that ldsm_x4 yields an m16n8k16 A operand of a row-major tile, and
// ldsm_x4_t yields two B operands of a row-major [k][n] tile: {r0, r1} for
// columns 0-7 and {r2, r3} for columns 8-15.
__device__ __forceinline__ const bf16* tile_lane_row(const bf16* tile, int ld) {
  const int lane = threadIdx.x % 32;
  return tile + (lane % 16) * ld + (lane / 16) * 8;
}

// c += a . b for one m16n8k16 tile, bf16 in, fp32 accumulate. With
// g = lane / 4 and t = lane % 4: a holds rows g, g+8 x columns 2t.., 2t+8..
// as {a[g][2t], a[g+8][2t], a[g][2t+8], a[g+8][2t+8]} (pairs); b holds
// column g x rows 2t.. and 2t+8..; c[0], c[1] are row g, columns 2t, 2t+1,
// and c[2], c[3] row g + 8.
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8-row x 16-byte matrices of int8 from shared memory (ldmatrix moves
// 16-bit units, so one of its 8x8 b16 matrices is 8 rows of 16 int8). Lanes
// 8i..8i+7 give the row addresses of matrix i; register r[i] receives, per
// lane l, row l / 4, bytes 4(l % 4) .. 4(l % 4) + 3 of matrix i.
__device__ __forceinline__ void ldsm_x4_b8(unsigned (&r)[4], const void* lane_row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(lane_row)));
}

// c += a . b for one m16n8k32 tile, int8 in, int32 accumulate. With
// g = lane / 4 and t = lane % 4: a holds rows g, g+8 x k-bytes 4t..4t+3 and
// 16+4t..16+4t+3 as {a[g][4t..], a[g+8][4t..], a[g][16+4t..], a[g+8][16+4t..]}
// (four int8 per register); b holds column g x k 4t..4t+3 and 16+4t..; c as
// in mma16816.
__device__ __forceinline__ void mma16832_s8(int (&c)[4], const unsigned (&a)[4],
                                            unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace aaclip
