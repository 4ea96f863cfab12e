// Warp-level tile helpers for the bf16 attention kernels on Hopper (sm_90a).
//
// The flash-attention kernels of this directory build their bf16 products
// from these pieces:
//
//   cp_async_16 / cp_async_4   asynchronous copies global -> shared memory
//                              (cp.async), zero-filled when the source row
//                              lies past the end of the sequence;
//   ldmatrix_x4(_trans)        8x8 bf16 matrices from shared memory into
//                              mma.sync operand fragments;
//   mma_bf16_16816             D += A B on the tensor cores, m16n8k16, bf16
//                              operands, float32 accumulator;
//   frag_row / frag_col        which (row, column) of a 16 x 8 accumulator
//                              tile each of a thread's four floats holds;
//   *_ldsm_offset              the element each lane points ldmatrix at, for
//                              the A operand (row-major [m][k] tile) and the
//                              B operand from a [n][k] tile (K for Q K^T) or,
//                              transposed, from a [k][n] tile (V for P V);
//   split_bf16                 a float32 pair as two bf16 terms hi + lo, so
//                              that a float32 probability tile can be a
//                              bf16 mma.sync operand to about 2^-16 relative.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16" with
// .bf16): lane = 4 g + t (g = lane / 4, t = lane % 4).
//   A, 16 x 16, four 32-bit registers of two bf16 each:
//     a0 (row g,   cols 2t, 2t+1)   a1 (row g+8, cols 2t, 2t+1)
//     a2 (row g,   cols 2t+8, +9)   a3 (row g+8, cols 2t+8, +9)
//   B, 16 x 8 (k x n), two registers:
//     b0 (rows 2t, 2t+1, col g)     b1 (rows 2t+8, 2t+9, col g)
//   C/D, 16 x 8 float32, four floats:
//     c0, c1 (row g, cols 2t, 2t+1) c2, c3 (row g+8, cols 2t, 2t+1)
// The accumulator of two neighbouring 8-column tiles is, element for
// element, the A fragment of a 16-column step: a product's output feeds the
// next product from registers (FlashAttention-2's reuse of P).
//
// Shared-memory tiles are row-major bf16 with a row stride of D + 8
// elements: a row then starts 16 bytes further along the 32 banks than the
// one before, so the eight 16-byte rows an ldmatrix reads fall on distinct
// banks, and every row start stays 16-byte aligned for cp.async.

#pragma once

#include <cuda_bf16.h>
#include <cstdint>

namespace tdl {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- cp.async

// 16 bytes from global to shared memory, bypassing L1; when !valid nothing
// is read and the 16 bytes are zero (src-size 0). Both addresses must be
// 16-byte aligned, and gmem must be a mapped address even when !valid.
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes (one int32), zero when !valid.
__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(valid ? 4 : 0)
               : "memory");
}

// Close the group of copies issued since the last commit (may be empty).
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N groups of this thread are still in flight. The data
// is visible to other threads only after a barrier that follows the wait.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------- ldmatrix

// Four 8x8 bf16 matrices: lanes 8i..8i+7 give the row addresses of matrix
// i, and r[i] receives this lane's fragment of matrix i (row g, cols 2t,
// 2t+1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(smem))
               : "memory");
}

// The same, each matrix transposed: r[i] receives (rows 2t, 2t+1, col g).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(smem))
               : "memory");
}

// Element offsets (row * ld + col) that a lane hands to ldmatrix_x4.
//
// A operand, the 16 x 16 block at (row r0, col k0) of a row-major [m][k]
// tile: r = {a0, a1, a2, a3}.
__device__ __forceinline__ int a_ldsm_offset(int lane, int ld, int r0, int k0) {
  return (r0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8;
}

// B operand of a product with a [n][k] row-major tile (B = tile^T, as K in
// Q K^T): the 16-deep step at column k0 of the two 8-column tiles n0 and
// n0 + 8: r = {b0(n0), b1(n0), b0(n0+8), b1(n0+8)}.
__device__ __forceinline__ int bt_ldsm_offset(int lane, int ld, int n0, int k0) {
  return (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 + ((lane >> 3) & 1) * 8;
}

// B operand from a [k][n] row-major tile (as V in P V), for
// ldmatrix_x4_trans: the 16-deep step at row k0 of the 8-column tiles n0
// and n0 + 8: r = {b0(n0), b1(n0), b0(n0+8), b1(n0+8)}.
__device__ __forceinline__ int b_ldsm_trans_offset(int lane, int ld, int k0, int n0) {
  return (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + (lane >> 4) * 8;
}

// ---------------------------------------------------------------- mma.sync

// d += a b: A 16 x 16 and B 16 x 8 bf16, d 16 x 8 float32. The products of
// two bf16 values are exact in float32.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------------------------------- fragment indices

// Row and column within the 16 x 8 accumulator tile of element e (0..3) of
// a lane's C/D fragment.
__device__ __forceinline__ int frag_row(int lane, int e) { return (lane >> 2) + (e >> 1) * 8; }
__device__ __forceinline__ int frag_col(int lane, int e) { return (lane & 3) * 2 + (e & 1); }

// ------------------------------------------------------------ bf16 packing

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) rounded to bf16, x0 in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  return as_u32(__floats2bfloat162_rn(x0, x1));
}

// (x0, x1) = hi + lo with hi = bf16(x) and lo = bf16(x - hi); x - hi is exact
// in float32, so hi + lo holds x to 2^-16 of its value (bf16 keeps 8
// significant bits). Two products, one with each term, into one float32
// accumulator give a float32 operand's product to that precision.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

}  // namespace tdl
