// Warp-level tile helpers for the attention kernels on Hopper (sm_90a).
//
// The flash-attention kernels of this directory build their tensor-core
// products from these pieces:
//
//   cp_async_16 / cp_async_4   asynchronous copies global -> shared memory
//                              (cp.async), zero-filled when the source row
//                              lies past the end of the sequence;
//   cp_async_tile / _rows      a tile of rows of a [T, D] slab (bf16 or
//                              float32) by 16-byte cp.async copies;
//   ldmatrix_x4(_trans)        8x8 bf16 matrices from shared memory into
//                              mma.sync operand fragments;
//   mma_bf16_16816             D += A B on the tensor cores, m16n8k16, bf16
//                              operands, float32 accumulator;
//   split_tf32 /               float32 operands on the TF32 tensor cores,
//   mma_tf32_1688              split in two terms (3xTF32, see below);
//   mma_a_bt / mma_split_a_b   a 16-row strip of products: A from registers
//                              times a shared-memory tile (transposed, as K
//                              in Q K^T, or not, as V in P V);
//   frag_row / frag_col        which (row, column) of a 16 x 8 accumulator
//                              tile each of a thread's four floats holds;
//   *_ldsm_offset              the element each lane points ldmatrix at, for
//                              the A operand (row-major [m][k] tile) and the
//                              B operand from a [n][k] tile (K for Q K^T) or,
//                              transposed, from a [k][n] tile (V for P V);
//   split_bf16 / split_a_frag  a float32 pair, or the A fragment made of two
//                              accumulator tiles, as two bf16 terms hi + lo,
//                              so that a float32 tile (P, dS) can be a bf16
//                              mma.sync operand to about 2^-16 relative;
//   allow_smem                 the dynamic shared-memory attribute, set once
//                              per kernel and device.
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
#include <cuda_runtime.h>

#include <atomic>
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

// Rows [t0, t0 + kRows) of a [T, D] slab of Elem with row stride `stride_t`
// (elements) into a kRows x LD tile, 16 bytes per copy, spread over the
// kThreads threads of the block; rows at or past T are zero-filled.
template <typename Elem, int D, int LD, int kRows, int kThreads>
__device__ __forceinline__ void cp_async_tile(Elem* tile, const Elem* src, long long stride_t,
                                              int t0, int T) {
  constexpr int kPer = 16 / sizeof(Elem);  // elements per copy
  constexpr int kChunks = D / kPer;        // copies per row
  for (int c = threadIdx.x; c < kRows * kChunks; c += kThreads) {
    const int r = c / kChunks, ch = c % kChunks;
    const int t = t0 + r;
    const bool valid = t < T;
    cp_async_16(tile + r * LD + ch * kPer, src + (valid ? t : 0) * stride_t + ch * kPer, valid);
  }
}

// The bf16 tiles of the kernels: row stride D + 8 (see above).
template <int D, int kRows, int kThreads>
__device__ __forceinline__ void cp_async_rows(__nv_bfloat16* tile, const __nv_bfloat16* src,
                                              long long stride_t, int t0, int T) {
  cp_async_tile<__nv_bfloat16, D, D + 8, kRows, kThreads>(tile, src, stride_t, t0, T);
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

// acc[j] += A B_j for j < kN: A is a 16 x 16 fragment (the 16-deep step at
// column k0 of a 16-row strip), and B_j the transpose of rows n0 + 8j ..
// n0 + 8j + 7, columns k0 .. k0 + 15, of a row-major [n][k] tile with row
// stride ld (K in Q K^T: acc becomes a 16 x 8 kN strip of scores).
template <int kN>
__device__ __forceinline__ void mma_a_bt(float (&acc)[kN][4], const uint32_t (&a)[4],
                                         const __nv_bfloat16* tile, int ld, int lane, int n0,
                                         int k0) {
  static_assert(kN % 2 == 0, "pairs of 8-column tiles");
#pragma unroll
  for (int j = 0; j < kN; j += 2) {
    uint32_t b[4];
    ldmatrix_x4(b, tile + bt_ldsm_offset(lane, ld, n0 + j * 8, k0));
    mma_bf16_16816(acc[j], a, b[0], b[1]);
    mma_bf16_16816(acc[j + 1], a, b[2], b[3]);
  }
}

// acc[n] += (A_hi + A_lo) B_n for n < kN: A the 16 x 16 fragment of a
// float32 operand split in two bf16 terms (split_a_frag), and B_n rows k0 ..
// k0 + 15, columns 8n .. 8n + 7, of a row-major [k][n] tile with row stride
// ld (V in P V), read by ldmatrix.trans. Both terms go into one float32
// accumulator.
template <int kN>
__device__ __forceinline__ void mma_split_a_b(float (&acc)[kN][4], const uint32_t (&hi)[4],
                                              const uint32_t (&lo)[4],
                                              const __nv_bfloat16* tile, int ld, int lane,
                                              int k0) {
  static_assert(kN % 2 == 0, "pairs of 8-column tiles");
#pragma unroll
  for (int n = 0; n < kN; n += 2) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, tile + b_ldsm_trans_offset(lane, ld, k0, n * 8));
    mma_bf16_16816(acc[n], hi, b[0], b[1]);
    mma_bf16_16816(acc[n], lo, b[0], b[1]);
    mma_bf16_16816(acc[n + 1], hi, b[2], b[3]);
    mma_bf16_16816(acc[n + 1], lo, b[2], b[3]);
  }
}

// ------------------------------------------------ mma.sync, split TF32
//
// The float32 kernels multiply on the tensor cores in TF32 (10 mantissa
// bits), each operand split as x = hi + lo with hi = tf32(x) and lo the
// rest (split_tf32). Three products, lo*hi + hi*lo + hi*hi, go into float32
// accumulators (3xTF32); the dropped lo*lo and the truncation of lo are
// about 2^-21 of |x y|, so a product keeps nearly float32's precision where
// one TF32 product (hi*hi alone) is off by up to 2^-10 of it.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k8" with .tf32):
// lane = 4 g + t.
//   A, 16 x 8, four registers:  a0 (row g, col t)    a1 (row g+8, col t)
//                               a2 (row g, col t+4)  a3 (row g+8, col t+4)
//   B, 8 x 8 (k x n), two:      b0 (row t, col g)    b1 (row t+4, col g)
//   C/D, 16 x 8 float32: as for m16n8k16 above.
// An accumulator tile {c0, c1, c2, c3} is the A fragment {c0, c2, c1, c3} of
// a product over its 8 columns taken in the order 0, 2, 4, 6, 1, 3, 5, 7 (A's
// column t is the tile's column 2t, column t+4 is 2t+1), provided B's rows
// are taken in the same order: P V with P from registers.

// x = hi + lo for the TF32 tensor cores, which read only the top 19 bits
// (sign, exponent, 10 mantissa bits) of an operand register. hi is x
// rounded to TF32 (to nearest, ties away from zero: add half of the 13
// dropped bits to the magnitude, then clear them); lo = x - hi is exact in
// float32 and goes in as it is, so the tensor core truncates it to 10 bits
// (an error below 2^-10 |lo| <= 2^-21 |x|). Three integer and float
// operations, where cvt.rna.tf32.f32 compiles to eight or nine on sm_90
// (with checks for infinities and NaN, which these kernels never pass).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b: A 16 x 8 and B 8 x 8 TF32, d 16 x 8 float32.
__device__ __forceinline__ void mma_tf32_1688(float (&d)[4], const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
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

// The A fragment of a 16-deep step whose columns 0-7 are the accumulator
// tile c0 and columns 8-15 the tile c1 (the accumulator-to-A reuse above),
// each value split hi + lo.
__device__ __forceinline__ void split_a_frag(const float (&c0)[4], const float (&c1)[4],
                                             uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_bf16(c0[0], c0[1], hi[0], lo[0]);
  split_bf16(c0[2], c0[3], hi[1], lo[1]);
  split_bf16(c1[0], c1[1], hi[2], lo[2]);
  split_bf16(c1[2], c1[3], hi[3], lo[3]);
}

// ------------------------------------------------------------------- host

// cudaFuncSetAttribute(MaxDynamicSharedMemorySize) once per kernel and
// device (the attribute belongs to the device's context), not per launch;
// `done` holds one bit per device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit != 0 && (done.load(std::memory_order_acquire) & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

}  // namespace tdl
