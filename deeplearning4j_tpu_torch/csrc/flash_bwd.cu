// Flash-attention backward for Hopper (sm_90a): two kernels with a plain C
// interface.
//
// Replaces the TPU kernels of deeplearning4j_tpu/kernels/attention.py that
// `_flash_bwd` (attention.py:297) launches:
//
//   tdl_flash_bwd_dkv  <-  `_flash_bwd_dkv_kernel` (attention.py:213)
//   tdl_flash_bwd_dq   <-  `_flash_bwd_dq_kernel`  (attention.py:258)
//
// For q, dO [B,H,Tq,D], k, v [B,H,Tk,D] and the forward's out [B,H,Tq,D]
// and float32 lse, both recompute per tile
//
//   P  = exp(S - lse),  S = (q k^T) * scale masked to -1e30
//        (causal: q_offset + i < j; segments: qseg[i] != kseg[j])
//   dS = P * (dO v^T - delta) * scale,   delta = rowsum(dO * out)
//
// and accumulate dV = P^T dO, dK = dS^T q (dkv) and dQ = dS k (dq), with the
// TPU kernels' numerics: float32 products and sums from bf16 or float32
// inputs, gradients written in the inputs' dtype. The dq kernel also
// computes delta (float32 [B,H,Tq]) from out and dO and writes it for the
// dkv kernel, so it runs first; on the TPU, XLA computes delta before both
// kernels (attention.py:312). Under `causal`, tile pairs that lie wholly
// above the diagonal are skipped, as `_block_live` (attention.py:207) does.
// Keys past Tk (the ragged edge of the last tile) and query rows past Tq are
// left out of every sum.
//
// Rows with no live key. The forward gives such a row the mean of v over the
// Tk keys and lse = -1e30 + log Tk, which is -1e30 in float32 (any live row
// has a finite lse). Its gradient is that of the dense reference: dQ = 0,
// nothing to dK, and dO / Tk added to dV on every key. The TPU kernels
// recompute P = exp(-1e30 - (-1e30)) = 1 there and are right only because
// their wrapper's pad shim zeroes dO of such rows; this port has no shim, so
// both kernels detect the row by lse <= -1e29: its P is 0, and the dkv
// kernel adds the sum of dO over such rows, divided by Tk, to each key's dV.
// A call with no mask at all has no such row.
//
// Grid. On the TPU the last grid axis runs in order and the dK/dV (or dQ)
// accumulators stay in VMEM scratch across it. Blocks of a CUDA grid run in
// no order, so each kernel loops inside the block instead:
//   dkv: one block owns one (batch*head, 64-key tile); K and V are staged
//        once, and the block sweeps the 64-row q-tiles with dK and dV in
//        registers;
//   dq:  one block owns one (batch*head, 64-row q-tile); Q and dO are staged
//        once, and the block sweeps the 64-key tiles with dQ in registers.
// Keeping two kernels, as the TPU does, means no block ever adds into
// another block's output: there are no atomics, and the gradients are the
// same bits from run to run.
//
// bfloat16 inputs: flash_bwd_dkv_bf16_kernel and flash_bwd_dq_bf16_kernel,
// on the tensor cores, with the forward's design (flash_fwd.cu) and its
// helpers (attention_tiles.cuh). A block is four warps; each owns 16 rows of
// the block's tile (keys in dkv, query rows in dq).
//   - Staging: bf16 tiles with row stride D+8 by 16-byte cp.async copies,
//     rows past Tq or Tk zero-filled by the copy (src-size 0). The swept
//     tiles go through a two-stage ring (dkv: Q, dO and each q-tile's lse,
//     delta and query segment ids; dq: K, V and the key segment ids): the
//     copy of tile i+1 is in flight while the warps compute on tile i, with
//     one barrier per tile. The wrapper checks that q, k, v, dO (and out)
//     are 16-byte aligned in every row.
//   - dkv computes S^T = K Q^T and dP^T = V dO^T, dq S = Q K^T and dP =
//     dO V^T, as mma.sync m16n8k16 (bf16 x bf16 -> float32, each product
//     exact): the block's own rows (K and V, or Q and dO) are the A operand,
//     held in registers for the whole sweep up to D=64 (at D=128 they would
//     spill beside the accumulators and are read from shared memory by
//     ldmatrix at each step), and the swept tile is the B operand, taken in
//     sub-steps of 16-64 columns so that S and dP fit beside the
//     accumulators (DkvTiling, DqTiling).
//   - P and dS are formed on the accumulator fragments: scale, masks and
//     exp2 (exp(x) = exp2(x log2 e), a few float32 ulps), with lse and delta
//     per query: per column from shared memory in dkv, per row in registers
//     in dq.
//   - dV += P^T dO, dK += dS^T Q (dkv) and dQ += dS K (dq): the accumulator
//     of S^T (or S) is the A operand of the next mma.sync, so P and dS never
//     touch shared memory; dO, Q and K fragments come from ldmatrix.trans.
//     The TPU kernels multiply float32 P and dS by bf16 dO, Q and K; rounding
//     P and dS to bf16 once misses chip_smoke.py's bound 6-22x on its cases
//     (tests/test_torch_flash_bwd_numerics.py), so each is split in two bf16
//     terms, X = X_hi + X_lo with X_lo = bf16(X - X_hi), and two mma.sync
//     go into one float32 accumulator (X kept to about 2^-16 of its value).
//   - delta (dq kernel): rowsum(dO * out) for the block's 64 rows, from dO
//     in shared memory and out read by 16-byte loads while the first copies
//     are in flight: bf16 products (exact in float32), float32 sums over the
//     four lanes of a row.
//   - The gradients are rounded to bf16 once, staged through the warp's own
//     rows of the K/V (or Q) tiles and written with 16-byte stores.
//   - A call with no causal mask, no segment ids and Tq, Tk multiples of 64
//     takes instantiations without mask tests (and no dead-row scan: with no
//     mask no row is dead), the training batch's case.
// Shared memory per block: dkv K, V and two stages of Q and dO, 6 x 64 x
// (D+8) bf16, plus two stages of lse, delta and query ids: 56,832 B at D=64,
// 105,984 B at D=128; dq Q, dO and two stages of K and V, plus two stages of
// key ids: 55,808 B at D=64, 104,960 B at D=128.
//
// float32 inputs: flash_bwd_dkv_f32_kernel and flash_bwd_dq_f32_kernel, the
// same two TPU kernels on the TF32 tensor cores with split operands (3xTF32,
// as the float32 forward in flash_fwd.cu). A block is four warps.
//   - Products: every operand x of S^T = K Q^T, dP^T = V dO^T, dV += P^T dO
//     and dK += dS^T Q (dkv), and of S = Q K^T, dP = dO V^T and dQ += dS K
//     (dq), is split x = hi + lo (hi = x rounded to TF32, lo = x - hi, which
//     the tensor core truncates), and mma.sync m16n8k8 adds lo*hi, hi*lo and
//     hi*hi in float32: each product to about 2^-21 of |x y|. One TF32
//     product misses phase 2's float32 bound (the CPU model in
//     tests/test_torch_flash_bwd_f32_numerics.py pins it per product). A
//     warp issues in order and a product's sum is ready some 30 cycles
//     later, so the products are issued term by term over 8 accumulators
//     (S and dP tiles side by side; dV and dK, or dQ, tiles in groups): a
//     tile's next term starts 8 instructions after its last (fewer at
//     D <= 32).
//   - P and dS never touch shared memory. Each warp owns 16 rows (keys in
//     dkv, query rows in dq); P and dS are formed on the accumulator
//     fragments (scale, masks, exp2 with lse and delta per column in dkv,
//     per row in dq) and feed the next product from registers as A
//     fragments, split in the same way: accumulator {c0, c1, c2, c3} is A
//     {c0, c2, c1, c3} with B's rows (dO and Q in dkv, K in dq) read in the
//     order 0, 2, 4, 6, 1, 3, 5, 7 (attention_tiles.cuh).
//   - Staging: float32 tiles with a row stride of D+4 floats (kLdF), by
//     16-byte cp.async copies, rows past Tq or Tk zero-filled by the copy.
//     Fragments of a [n][k] tile (the own rows as A, the swept rows as B of
//     S and dP) are read by ldmatrix.x4: an 8 x 8 b16 matrix is an 8 x 4
//     float block, and a lane receives the word (row g, column t), the
//     m16n8k8 .tf32 layout; the permuted rows 2t, 2t+1 of a [k][n] tile (B
//     of dV, dK and dQ) by scalar loads. At that stride both hit 32
//     distinct banks at D = 16..128: rows 16 bytes apart along the banks
//     for ldmatrix, (8t + g) for the scalar loads. The swept tiles (dkv:
//     Q, dO, lse, delta and query ids; dq: K, V and key ids) go through a
//     two-stage ring with one barrier per tile; the wrapper checks that q,
//     k, v, dO (and out) are 16-byte aligned in every row.
//   - Filling the card: the block owns 64 rows, and its four warps own 16
//     rows each and take every swept tile whole. At B=16 H=12 T=128 that is
//     384 blocks, two per SM.
//   - Registers: the block's own rows (K and V, or Q and dO) are read from
//     shared memory at each use, or held raw in registers where ptxas shows
//     room (DkvF32Tiling, DqF32Tiling); the S and dP accumulators are taken
//     in sub-steps of 16 or 32 swept rows beside the gradient accumulators. No
//     instantiation spills (chip_smoke.py phase 1 checks all of them).
//   - delta (dq kernel): rowsum(dO * out) in float32 FMA, dO from shared
//     memory and out read by 16-byte loads while the first copies are in
//     flight, two threads per row.
//   - Gradients are written as float32 pairs straight from the fragments.
//   - Masked and unmasked instantiations as for bf16, and the same dead-row
//     rule.
// Shared memory per block at D=64: dkv 6 x 64 rows of 68 floats plus two
// stages of lse, delta and query ids: 105,984 B; dq the same rows plus the
// key ids and the block's delta: 105,216 B. Two blocks fit on an SM.
//
// Bound on the H100 at the BERT-base training shape (B=16, H=12, T=128,
// D=64). bf16: dkv reads q, dO, k, v (4 x 3.15 MB), lse and delta (2 x
// 98 KB) and writes dk, dv (2 x 3.15 MB): 19.07 MB, 5.7 us at 3.35 TB/s,
// against 8 T^2 D B H = 1.61 GFLOP, 1.6 us at the bf16 tensor-core peak
// (2.8 us with the split's extra products); dq reads q, k, v, out, dO and
// lse and writes dq and delta: also 19.07 MB (5.7 us), for 1.21 GFLOP.
// float32: twice the bytes, 37.9 MB or 11.3 us each, against 1.61 GFLOP
// (9.8 us) and 1.21 GFLOP (7.3 us) at 494.7 / 3 TFLOP/s (3xTF32). All four
// are bound by bytes, and at T=128 a block sweeps only two tiles, so the
// fixed latency of a block (the first copies, two dependent tile steps, the
// epilogue) is what the design has to hide: mma.sync tiles and a two-stage
// cp.async ring suffice, and wgmma and TMA are left out (they pay off where
// the tensor-core rate binds, at long sequences). PERF.md records the
// measured times beside the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

#include "attention_tiles.cuh"

namespace {

constexpr int kBlock = 64;               // rows of a q-tile and of a k-tile
constexpr float kNegInf = -1e30f;        // finite mask, as on the TPU
constexpr float kDeadLse = -1e29f;       // lse of a row with no live key
constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = exp2(x log2 e)

// -inf: exp2f of it is 0, the P of a query with no live key
__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }

struct Strides {
  long long b, h, t;  // element strides; the last axis must be contiguous
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* out;     // the forward's output (dq kernel)
  const void* dout;
  const float* lse;    // [B, H, Tq], contiguous
  float* delta;        // [B, H, Tq], contiguous: written by dq, read by dkv
  const int* qseg;     // [B, Tq] or null
  const int* kseg;     // [B, Tk] or null
  void* dq;            // [B, H, Tq, D], contiguous (dq kernel)
  void* dk;            // [B, H, Tk, D], contiguous (dkv kernel)
  void* dv;            // [B, H, Tk, D], contiguous (dkv kernel)
  int B, H, Tq, Tk;
  Strides sq, sk, sv, so, sdo;
  int causal;
  float scale;
  int q_offset;        // Tk - Tq: aligns causal rows to the end of the keys
};

template <typename T>
__device__ __forceinline__ const T* head(const void* base, const Strides& s, int b, int h) {
  return static_cast<const T*>(base) + b * s.b + h * s.h;
}

// The 64-row q-tiles a key tile at k0 meets: all of them, or under `causal`
// those from the first that holds a row at or after the tile's first key.
__device__ __forceinline__ int first_live_q_tile(const Params& p, int k0) {
  if (!p.causal) return 0;
  const int x = k0 - p.q_offset - (kBlock - 1);  // the first q0 that is live
  return x > 0 ? (x + kBlock - 1) / kBlock : 0;
}

// The k-tiles a 64-row q-tile at q0 meets: all of them, or under `causal`
// those up to the last that holds a key at or below its last row.
__device__ __forceinline__ int live_k_tiles(const Params& p, int q0) {
  const int num_k = (p.Tk + kBlock - 1) / kBlock;
  if (!p.causal) return num_k;
  const int last = p.q_offset + q0 + kBlock - 1;
  return last < 0 ? 0 : min(num_k, last / kBlock + 1);
}

// ------------------------------------------------------ bf16: tensor cores

using bf16 = __nv_bfloat16;
constexpr int kBf16Threads = 128;  // four warps of 16 rows

// row stride, in elements, of a bf16 tile in shared memory
template <int D>
constexpr int kLd = D + 8;
template <int D>
constexpr int kTile = kBlock * kLd<D>;

// Register budget of each bf16 kernel by head dim, chosen on the H100 from
// ptxas's counts and kernel times (PERF.md): no instantiation spills.
//   kHold  the block's own rows (K, V or Q, dO) stay in registers as A
//          fragments for the whole sweep (up to D=64), else ldmatrix reads
//          them at each step;
//   kSub   columns of the S and dP accumulators per sub-step of a 64-wide
//          tile; the dK/dV (or dQ) accumulators stay live beside them, so
//          the larger they are, the narrower the sub-step.
template <int D>
struct DkvTiling {
  static constexpr bool kHold = D <= 64;
  static constexpr int kSub = D <= 64 ? 32 : 16;
};
template <int D>
struct DqTiling {
  static constexpr bool kHold = D <= 64;
  static constexpr int kSub = D <= 32 ? 64 : 32;
};

template <int D>
constexpr size_t dkv_smem_bytes() {
  return 6 * size_t(kTile<D>) * sizeof(bf16) + 3 * 2 * kBlock * sizeof(float);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return 6 * size_t(kTile<D>) * sizeof(bf16) + 2 * kBlock * sizeof(int);
}

template <int D>
__device__ __forceinline__ void stage(bf16* tile, const bf16* src, long long stride_t, int t0,
                                      int T) {
  tdl::cp_async_rows<D, kBlock, kBf16Threads>(tile, src, stride_t, t0, T);
}

// The A fragment of the 16-deep step ks of the warp's 16 rows of `tile`:
// the held copy, or a fresh ldmatrix.
template <int D, bool kHold, int kSteps>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const uint32_t (&held)[kSteps][4],
                                       const bf16* tile, int lane, int warp, int ks) {
  if constexpr (kHold) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = held[ks][i];
  } else {
    tdl::ldmatrix_x4(a, tile + tdl::a_ldsm_offset(lane, kLd<D>, warp * 16, ks * 16));
  }
}

template <int D, bool kHold, int kSteps>
__device__ __forceinline__ void hold_a(uint32_t (&held)[kSteps][4], const bf16* tile, int lane,
                                       int warp) {
  if constexpr (kHold) {
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks)
      tdl::ldmatrix_x4(held[ks], tile + tdl::a_ldsm_offset(lane, kLd<D>, warp * 16, ks * 16));
  }
}

// A warp's 16 x D accumulator (D/8 tiles of 16 x 8) in bf16: staged in the
// warp's own 16 rows of `tile` (which no other warp reads), then written to
// rows t0 .. t0 + 15 of a contiguous [T, D] slab with 16-byte stores.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], bf16* tile, bf16* dst,
                                           int t0, int T, int lane) {
  constexpr int LD = kLd<D>;
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint32_t*>(tile + ((lane >> 2) + 8 * i) * LD + n * 8 +
                                   tdl::frag_col(lane, 0)) =
          tdl::pack_bf16(acc[n][2 * i], acc[n][2 * i + 1]);
  __syncwarp();
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int c = lane; c < 16 * kChunks; c += 32) {
    const int r = c / kChunks, ch = c % kChunks;
    if (t0 + r < T)
      *reinterpret_cast<uint4*>(dst + (long long)(t0 + r) * D + ch * 8) =
          *reinterpret_cast<const uint4*>(tile + r * LD + ch * 8);
  }
}

// kMasked: the call has a causal mask, segment ids, or Tq or Tk not a
// multiple of 64. The unmasked instantiation drops every mask test.
template <int D, bool kMasked>
__global__ void __launch_bounds__(kBf16Threads) flash_bwd_dkv_bf16_kernel(Params p) {
  using Tiling = DkvTiling<D>;
  constexpr int LD = kLd<D>;
  constexpr int kSteps = D / 16;  // 16-deep steps over the head dim
  constexpr int kDT = D / 8;      // 8-column tiles of dK and dV
  constexpr int kNT = Tiling::kSub / 8;  // 8-query tiles of a sub-step
  extern __shared__ __align__(16) unsigned char smem_dkv[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_dkv);
  bf16* Vs = Ks + kTile<D>;
  bf16* Qs = Vs + kTile<D>;        // [2][64][LD]
  bf16* dOs = Qs + 2 * kTile<D>;   // [2][64][LD]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * kTile<D>);  // [2][64]
  float* delta_s = lse_s + 2 * kBlock;                            // [2][64]
  int* qseg_s = reinterpret_cast<int*>(delta_s + 2 * kBlock);     // [2][64]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.x * kBlock;
  const bool has_seg = kMasked && p.qseg != nullptr;
  const bf16* qp = head<bf16>(p.q, p.sq, b, h);
  const bf16* dop = head<bf16>(p.dout, p.sdo, b, h);
  const float* lse_bh = p.lse + (long long)bh * p.Tq;
  const float* delta_bh = p.delta + (long long)bh * p.Tq;
  const int* qsp = has_seg ? p.qseg + (long long)b * p.Tq : nullptr;

  const int num_q = (p.Tq + kBlock - 1) / kBlock;
  const int first_q = kMasked ? first_live_q_tile(p, k0) : 0;
  auto stage_q = [&](int qb) {
    const int buf = qb & 1, q0 = qb * kBlock;
    stage<D>(Qs + buf * kTile<D>, qp, p.sq.t, q0, p.Tq);
    stage<D>(dOs + buf * kTile<D>, dop, p.sdo.t, q0, p.Tq);
    if (threadIdx.x < kBlock) {
      const int row = q0 + threadIdx.x;
      const bool in = row < p.Tq;
      const int src = in ? row : 0;
      tdl::cp_async_4(lse_s + buf * kBlock + threadIdx.x, lse_bh + src, in);
      tdl::cp_async_4(delta_s + buf * kBlock + threadIdx.x, delta_bh + src, in);
      if (has_seg) tdl::cp_async_4(qseg_s + buf * kBlock + threadIdx.x, qsp + src, in);
    }
  };

  stage<D>(Ks, head<bf16>(p.k, p.sk, b, h), p.sk.t, k0, p.Tk);
  stage<D>(Vs, head<bf16>(p.v, p.sv, b, h), p.sv.t, k0, p.Tk);
  if (first_q < num_q) stage_q(first_q);
  tdl::cp_async_commit();

  // this lane's two keys: rows g and g + 8 of the warp's 16
  int key[2], kseg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    key[i] = k0 + warp * 16 + (lane >> 2) + 8 * i;
    kseg[i] = (has_seg && key[i] < p.Tk) ? p.kseg[(long long)b * p.Tk + key[i]] : -1;
  }
  float dk[kDT][4], dv[kDT][4];
#pragma unroll
  for (int n = 0; n < kDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const float scale_log2 = p.scale * kLog2e;

  tdl::cp_async_wait<0>();
  __syncthreads();
  uint32_t kf[kSteps][4], vf[kSteps][4];
  hold_a<D, Tiling::kHold>(kf, Ks, lane, warp);
  hold_a<D, Tiling::kHold>(vf, Vs, lane, warp);

  for (int qb = first_q; qb < num_q; ++qb) {
    // the stage written here was last read in iteration qb - 1, before the
    // barrier that ended it
    if (qb + 1 < num_q) stage_q(qb + 1);
    tdl::cp_async_commit();

    const int buf = qb & 1, q0 = qb * kBlock;
    const bf16* Qt = Qs + buf * kTile<D>;
    const bf16* dOt = dOs + buf * kTile<D>;
    const float* lse_t = lse_s + buf * kBlock;
    const float* delta_t = delta_s + buf * kBlock;
    const int* qseg_t = qseg_s + buf * kBlock;
#pragma unroll 1
    for (int c0 = 0; c0 < kBlock; c0 += Tiling::kSub) {
      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x kSub queries
      float s[kNT][4], dp[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        uint32_t a[4];
        a_frag<D, Tiling::kHold>(a, kf, Ks, lane, warp, ks);
        tdl::mma_a_bt(s, a, Qt, LD, lane, c0, ks * 16);
        a_frag<D, Tiling::kHold>(a, vf, Vs, lane, warp, ks);
        tdl::mma_a_bt(dp, a, dOt, LD, lane, c0, ks * 16);
      }
      // P^T and dS^T in place: element e of tile j is key row g + 8 (e >> 1)
      // and query column c0 + 8 j + 2 t + (e & 1)
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int c = c0 + 8 * j + tdl::frag_col(lane, 0);
        const float2 lse2 = *reinterpret_cast<const float2*>(lse_t + c);
        const float2 delta2 = *reinterpret_cast<const float2*>(delta_t + c);
        const float lse[2] = {lse2.x, lse2.y}, delta[2] = {delta2.x, delta2.y};
        float neg_lse[2];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          // a query past Tq or with no live key gets P = 0
          const bool live = !kMasked || (q0 + c + x < p.Tq && lse[x] > kDeadLse);
          neg_lse[x] = live ? -lse[x] * kLog2e : neg_inf();
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, x = e & 1;
          bool live = true;
          if (kMasked) live = key[i] < p.Tk;
          if (kMasked && p.causal) live = live && p.q_offset + q0 + c + x >= key[i];
          if (has_seg) live = live && qseg_t[c + x] == kseg[i];
          const float pe = live ? exp2f(fmaf(s[j][e], scale_log2, neg_lse[x])) : 0.f;
          s[j][e] = pe;
          dp[j][e] = pe * (dp[j][e] - delta[x]) * p.scale;
        }
      }
      // dV += P^T dO and dK += dS^T Q, 16 queries per step
#pragma unroll
      for (int kk = 0; kk < kNT / 2; ++kk) {
        uint32_t hi[4], lo[4];
        tdl::split_a_frag(s[2 * kk], s[2 * kk + 1], hi, lo);
        tdl::mma_split_a_b(dv, hi, lo, dOt, LD, lane, c0 + kk * 16);
        tdl::split_a_frag(dp[2 * kk], dp[2 * kk + 1], hi, lo);
        tdl::mma_split_a_b(dk, hi, lo, Qt, LD, lane, c0 + kk * 16);
      }
    }
    // tile qb + 1 has landed, and no warp reads stage qb & 1 any more
    tdl::cp_async_wait<0>();
    __syncthreads();
  }

  if constexpr (kMasked) {
    // Rows with no live key attend uniformly to all Tk keys: each adds
    // dO / Tk to every key's dV. Such rows may lie in q-tiles the causal
    // skip passed over, so the whole of lse is scanned.
    int any_dead = 0;
    for (int i = threadIdx.x; i < p.Tq; i += kBf16Threads) any_dead |= lse_bh[i] <= kDeadLse;
    if (__syncthreads_or(any_dead)) {
      float dsum[kDT][2];
#pragma unroll
      for (int n = 0; n < kDT; ++n) dsum[n][0] = dsum[n][1] = 0.f;
      for (int r = 0; r < p.Tq; ++r) {
        if (lse_bh[r] > kDeadLse) continue;
#pragma unroll
        for (int n = 0; n < kDT; ++n) {
          const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              dop + r * p.sdo.t + n * 8 + tdl::frag_col(lane, 0)));
          dsum[n][0] += x.x;
          dsum[n][1] += x.y;
        }
      }
#pragma unroll
      for (int n = 0; n < kDT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dv[n][e] += dsum[n][e & 1] / float(p.Tk);
    }
  }

  const long long out_off = (long long)bh * p.Tk * D;
  const int t0 = k0 + warp * 16;
  store_rows<D>(dk, Ks + warp * 16 * LD, static_cast<bf16*>(p.dk) + out_off, t0, p.Tk, lane);
  store_rows<D>(dv, Vs + warp * 16 * LD, static_cast<bf16*>(p.dv) + out_off, t0, p.Tk, lane);
}

// sum over the eight products of two rows of 8 bf16 values, added to acc
__device__ __forceinline__ float dot8(const uint4& x, const uint4& y, float acc) {
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xs[i]));
    const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ys[i]));
    acc = fmaf(a.x, c.x, acc);  // a bf16 product is exact in float32
    acc = fmaf(a.y, c.y, acc);
  }
  return acc;
}

template <int D, bool kMasked>
__global__ void __launch_bounds__(kBf16Threads) flash_bwd_dq_bf16_kernel(Params p) {
  using Tiling = DqTiling<D>;
  constexpr int LD = kLd<D>;
  constexpr int kSteps = D / 16;
  constexpr int kDT = D / 8;        // 8-column tiles of dQ
  constexpr int kNT = Tiling::kSub / 8;  // 8-key tiles of a sub-step
  constexpr int kChunks = D / 8;    // 16-byte chunks of a row
  constexpr int kOC = (kChunks + 3) / 4;  // of out's, per lane, for delta
  extern __shared__ __align__(16) unsigned char smem_dq[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_dq);
  bf16* dOs = Qs + kTile<D>;
  bf16* Ks = dOs + kTile<D>;       // [2][64][LD]
  bf16* Vs = Ks + 2 * kTile<D>;    // [2][64][LD]
  int* kseg_s = reinterpret_cast<int*>(Vs + 2 * kTile<D>);  // [2][64]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * kBlock;
  const bool has_seg = kMasked && p.qseg != nullptr;
  const bf16* kp = head<bf16>(p.k, p.sk, b, h);
  const bf16* vp = head<bf16>(p.v, p.sv, b, h);
  const bf16* op = head<bf16>(p.out, p.so, b, h);
  const int* ksp = has_seg ? p.kseg + (long long)b * p.Tk : nullptr;

  const int n_tiles = kMasked ? live_k_tiles(p, q0) : p.Tk / kBlock;
  auto stage_kv = [&](int kb) {
    const int buf = kb & 1, k0 = kb * kBlock;
    stage<D>(Ks + buf * kTile<D>, kp, p.sk.t, k0, p.Tk);
    stage<D>(Vs + buf * kTile<D>, vp, p.sv.t, k0, p.Tk);
    if (has_seg && threadIdx.x < kBlock) {
      const int t = k0 + threadIdx.x;
      tdl::cp_async_4(kseg_s + buf * kBlock + threadIdx.x, ksp + (t < p.Tk ? t : 0), t < p.Tk);
    }
  };

  stage<D>(Qs, head<bf16>(p.q, p.sq, b, h), p.sq.t, q0, p.Tq);
  stage<D>(dOs, head<bf16>(p.dout, p.sdo, b, h), p.sdo.t, q0, p.Tq);
  if (n_tiles > 0) stage_kv(0);
  tdl::cp_async_commit();

  // this lane's two query rows: g and g + 8 of the warp's 16; out's chunks
  // t, t + 4, ... of each, read while the copies are in flight
  const int r0 = warp * 16 + (lane >> 2), t = lane & 3;
  uint4 oc[2][kOC];
  float neg_lse[2];
  int qseg[2], qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    const bool in = row < p.Tq;
#pragma unroll
    for (int m = 0; m < kOC; ++m) {
      const int ch = t + 4 * m;
      oc[i][m] = (ch < kChunks && in)
                     ? *reinterpret_cast<const uint4*>(op + row * p.so.t + ch * 8)
                     : make_uint4(0u, 0u, 0u, 0u);
    }
    const float lse = in ? p.lse[(long long)bh * p.Tq + row] : kNegInf;
    // a row past Tq or with no live key gets P = 0
    neg_lse[i] = (!kMasked || lse > kDeadLse) ? -lse * kLog2e : neg_inf();
    qseg[i] = (has_seg && in) ? p.qseg[(long long)b * p.Tq + row] : 0;
    qpos[i] = p.q_offset + row;
  }

  tdl::cp_async_wait<0>();
  __syncthreads();

  // delta = rowsum(dO * out): this lane's chunks, then the row's four lanes
  float delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float sum = 0.f;
#pragma unroll
    for (int m = 0; m < kOC; ++m) {
      const int ch = t + 4 * m;
      if (ch < kChunks)
        sum = dot8(*reinterpret_cast<const uint4*>(dOs + (r0 + 8 * i) * LD + ch * 8), oc[i][m],
                   sum);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    delta[i] = sum;
    const int row = q0 + r0 + 8 * i;
    if (t == 0 && row < p.Tq) p.delta[(long long)bh * p.Tq + row] = sum;
  }

  uint32_t qf[kSteps][4], of[kSteps][4];
  hold_a<D, Tiling::kHold>(qf, Qs, lane, warp);
  hold_a<D, Tiling::kHold>(of, dOs, lane, warp);
  float dq[kDT][4];
#pragma unroll
  for (int n = 0; n < kDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
  const float scale_log2 = p.scale * kLog2e;

  for (int kb = 0; kb < n_tiles; ++kb) {
    if (kb + 1 < n_tiles) stage_kv(kb + 1);
    tdl::cp_async_commit();

    const int buf = kb & 1, k0 = kb * kBlock;
    const bf16* Kt = Ks + buf * kTile<D>;
    const bf16* Vt = Vs + buf * kTile<D>;
    const int* kseg_t = kseg_s + buf * kBlock;
#pragma unroll 1
    for (int c0 = 0; c0 < kBlock; c0 += Tiling::kSub) {
      // S = Q K^T and dP = dO V^T: this warp's 16 rows x kSub keys
      float s[kNT][4], dp[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        uint32_t a[4];
        a_frag<D, Tiling::kHold>(a, qf, Qs, lane, warp, ks);
        tdl::mma_a_bt(s, a, Kt, LD, lane, c0, ks * 16);
        a_frag<D, Tiling::kHold>(a, of, dOs, lane, warp, ks);
        tdl::mma_a_bt(dp, a, Vt, LD, lane, c0, ks * 16);
      }
      // dS in place of dP: element e of tile j is row g + 8 (e >> 1) and key
      // column c0 + 8 j + 2 t + (e & 1)
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int c = c0 + 8 * j + tdl::frag_col(lane, e);
          bool live = true;
          if (kMasked) live = k0 + c < p.Tk;
          if (kMasked && p.causal) live = live && qpos[i] >= k0 + c;
          if (has_seg) live = live && qseg[i] == kseg_t[c];
          const float pe = live ? exp2f(fmaf(s[j][e], scale_log2, neg_lse[i])) : 0.f;
          dp[j][e] = pe * (dp[j][e] - delta[i]) * p.scale;
        }
      }
      // dQ += dS K, 16 keys per step
#pragma unroll
      for (int kk = 0; kk < kNT / 2; ++kk) {
        uint32_t hi[4], lo[4];
        tdl::split_a_frag(dp[2 * kk], dp[2 * kk + 1], hi, lo);
        tdl::mma_split_a_b(dq, hi, lo, Kt, LD, lane, c0 + kk * 16);
      }
    }
    // tile kb + 1 has landed, and no warp reads stage kb & 1 any more
    tdl::cp_async_wait<0>();
    __syncthreads();
  }

  store_rows<D>(dq, Qs + warp * 16 * LD,
                static_cast<bf16*>(p.dq) + (long long)bh * p.Tq * D, q0 + warp * 16, p.Tq,
                lane);
}

// ------------------------------------------- float32: split-TF32 tensor cores

constexpr int kF32Threads = 128;  // four warps

// row stride, in floats, of a float32 tile in shared memory (see the note at
// the top): conflict-free fragment loads, 16-byte rows for cp.async
template <int D>
constexpr int kLdF = D + 4;

// Register budget of each float32 kernel by head dim, from ptxas's counts
// (no instantiation spills; ptxas settles near 168 registers, three blocks
// of 128 threads, where it can, and spilled there with 64-row sub-steps in
// dq at D=16 and 32-row ones at D=128):
//   kHold  the warp's own rows (K and V, or Q and dO) stay in registers,
//          raw, for the whole sweep, else they are read from shared memory
//          at each use; either way they are split at each use;
//   kSub   swept rows per sub-step of the S and dP accumulators, which stay
//          live beside the gradient accumulators.
template <int D>
struct DkvF32Tiling {
  static constexpr bool kHold = D <= 32;
  static constexpr int kSub = D <= 64 ? 32 : 16;
};
template <int D>
struct DqF32Tiling {
  static constexpr bool kHold = D <= 64;
  static constexpr int kSub = D <= 64 ? 32 : 16;
};

// K and V, two stages of Q and dO, and two stages of lse, delta and query
// ids
template <int D>
constexpr size_t dkv_f32_smem_bytes() {
  return 6 * size_t(kBlock) * kLdF<D> * sizeof(float) +
         3 * 2 * kBlock * sizeof(float);
}

// Q and dO, two stages of K and V and of the key ids, and the block's delta
template <int D>
constexpr size_t dq_f32_smem_bytes() {
  return 6 * size_t(kBlock) * kLdF<D> * sizeof(float) + 2 * kBlock * sizeof(int) +
         kBlock * sizeof(float);
}

// The A fragments of a warp's 16 own rows of a float32 tile: element e of
// the 8-deep step ks is row g + 8 (e & 1), column 8 ks + t + 4 (e >> 1)
// (mma.m16n8k8 .tf32). One ldmatrix.x4 reads them: its four 8 x 8 b16
// matrices are the 8 x 4 float blocks (rows 0-7 | 8-15) x (columns 0-3 |
// 4-7) of the step, and a lane receives the 32-bit word (row g, column t)
// of each. They are held raw in registers or read at each use, and split
// hi + lo at each use.
template <int D, bool kHold>
struct OwnRows {
  static constexpr int LD = kLdF<D>;
  const float* lane_row;  // the row and column this lane hands to ldmatrix
  float held[kHold ? D / 8 : 1][4];

  // rows16: the warp's first own row in the tile
  __device__ __forceinline__ OwnRows(const float* rows16, int lane)
      : lane_row(rows16 + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 4 * (lane >> 4)) {
    if constexpr (kHold) {
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks) raw(ks, held[ks]);
    }
  }
  __device__ __forceinline__ void raw(int ks, float (&x)[4]) const {
    uint32_t r[4];
    tdl::ldmatrix_x4(r, lane_row + ks * 8);
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = __uint_as_float(r[e]);
  }
  __device__ __forceinline__ void frag(int ks, uint32_t (&hi)[4], uint32_t (&lo)[4]) const {
    float x[4];
    if constexpr (kHold) {
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = held[ks][e];
    } else {
      raw(ks, x);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) tdl::split_tf32(x[e], hi[e], lo[e]);
  }
};

// The row and column of a [swept][D] tile that a lane hands to ldmatrix for
// the B operands of score_products: matrix i of an x4 is 8 swept rows (8 (i
// >> 1) .. + 7 from the pair's first) by 4 columns (4 (i & 1) .. + 3), so
// that a lane receives b0 and b1 of two 8-row tiles.
template <int D>
__device__ __forceinline__ int b_lane_offset(int lane) {
  return ((lane & 7) + 8 * (lane >> 4)) * kLdF<D> + 4 * ((lane >> 3) & 1);
}

// sd[0][j] += A1 B1_j and sd[1][j] += A2 B2_j over the head dim, 3xTF32: A1
// and A2 a warp's 16 own rows; B1_j and B2_j the transposes of rows 8 j ..
// 8 j + 7 of two [swept][D] tiles, read by ldmatrix two tiles at a time (b1
// and b2 point at the sub-step's first row, plus b_lane_offset). The terms
// go in term by term over the 2 kNT accumulators.
template <int D, int kNT, bool kHold>
__device__ __forceinline__ void score_products(float (&sd)[2][kNT][4],
                                               const OwnRows<D, kHold>& a1,
                                               const OwnRows<D, kHold>& a2, const float* b1,
                                               const float* b2) {
  static_assert(kNT % 2 == 0, "pairs of 8-row tiles");
  constexpr int LD = kLdF<D>;
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
    uint32_t ah[2][4], al[2][4];
    a1.frag(ks, ah[0], al[0]);
    a2.frag(ks, ah[1], al[1]);
    uint32_t bh[2][kNT][2], bl[2][kNT][2];
#pragma unroll
    for (int j = 0; j < kNT; j += 2) {
      uint32_t r[2][4];  // b0, b1 of tile j, then of tile j + 1
      tdl::ldmatrix_x4(r[0], b1 + j * 8 * LD + ks * 8);
      tdl::ldmatrix_x4(r[1], b2 + j * 8 * LD + ks * 8);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          tdl::split_tf32(__uint_as_float(r[m][i]), bh[m][j + (i >> 1)][i & 1],
                          bl[m][j + (i >> 1)][i & 1]);
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int m = 0; m < 2; ++m) tdl::mma_tf32_1688(sd[m][j], al[m], bh[m][j][0], bh[m][j][1]);
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int m = 0; m < 2; ++m) tdl::mma_tf32_1688(sd[m][j], ah[m], bl[m][j][0], bl[m][j][1]);
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int m = 0; m < 2; ++m) tdl::mma_tf32_1688(sd[m][j], ah[m], bh[m][j][0], bh[m][j][1]);
  }
}

// acc[m][n] += X_m B_m,n for m < kM and n < D / 8, 3xTF32. X_m is the
// accumulator tile sd[m + 2 - kM][j] (16 own rows x 8 swept rows) taken as
// the A operand, its columns in the order 0, 2, 4, 6, 1, 3, 5, 7
// (attention_tiles.cuh); B_m,n is rows 0..7 of a [swept][D] tile in the same
// order, columns 8 n .. 8 n + 7 (b[m] points at row 2t, column g of the
// tile's eight rows). The output tiles go in groups of 8 / kM per operand,
// term by term.
template <int D, int kM, int kNT>
__device__ __forceinline__ void accumulate(float (&acc)[kM][D / 8][4],
                                           const float (&sd)[2][kNT][4], int j,
                                           const float* const (&b)[kM]) {
  constexpr int LD = kLdF<D>;
  constexpr int kDT = D / 8;
  constexpr int kG = kDT < 8 / kM ? kDT : 8 / kM;
  uint32_t xh[kM][4], xl[kM][4];
#pragma unroll
  for (int m = 0; m < kM; ++m) {
    const float(&x)[4] = sd[m + 2 - kM][j];
    tdl::split_tf32(x[0], xh[m][0], xl[m][0]);
    tdl::split_tf32(x[2], xh[m][1], xl[m][1]);
    tdl::split_tf32(x[1], xh[m][2], xl[m][2]);
    tdl::split_tf32(x[3], xh[m][3], xl[m][3]);
  }
#pragma unroll
  for (int n0 = 0; n0 < kDT; n0 += kG) {
    uint32_t bh[kM][kG][2], bl[kM][kG][2];
#pragma unroll
    for (int m = 0; m < kM; ++m)
#pragma unroll
      for (int i = 0; i < kG; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          tdl::split_tf32(b[m][r * LD + (n0 + i) * 8], bh[m][i][r], bl[m][i][r]);
#pragma unroll
    for (int m = 0; m < kM; ++m)
#pragma unroll
      for (int i = 0; i < kG; ++i)
        tdl::mma_tf32_1688(acc[m][n0 + i], xl[m], bh[m][i][0], bh[m][i][1]);
#pragma unroll
    for (int m = 0; m < kM; ++m)
#pragma unroll
      for (int i = 0; i < kG; ++i)
        tdl::mma_tf32_1688(acc[m][n0 + i], xh[m], bl[m][i][0], bl[m][i][1]);
#pragma unroll
    for (int m = 0; m < kM; ++m)
#pragma unroll
      for (int i = 0; i < kG; ++i)
        tdl::mma_tf32_1688(acc[m][n0 + i], xh[m], bh[m][i][0], bh[m][i][1]);
  }
}

// Rows t0 + g and t0 + g + 8 (those before T) of a warp's 16 x D
// accumulator into a contiguous [T, D] float32 slab, a column pair per
// lane and tile.
template <int kDT>
__device__ __forceinline__ void store_f32(const float (&acc)[kDT][4], float* dst, int t0, int T,
                                          int lane) {
  constexpr int D = kDT * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = t0 + (lane >> 2) + 8 * i;
    if (row >= T) continue;
#pragma unroll
    for (int n = 0; n < kDT; ++n)
      *reinterpret_cast<float2*>(dst + (long long)row * D + n * 8 + tdl::frag_col(lane, 0)) =
          make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

// The block owns 64 keys and sweeps the 64-row q-tiles; warp w owns keys
// 16 w .. 16 w + 15. kMasked as for the bf16 kernels.
template <int D, bool kMasked>
__global__ void __launch_bounds__(kF32Threads) flash_bwd_dkv_f32_kernel(Params p) {
  using Tiling = DkvF32Tiling<D>;
  constexpr int LD = kLdF<D>;
  constexpr int kSub = Tiling::kSub;
  constexpr int kNT = kSub / 8;            // 8-query tiles of a sub-step
  constexpr int kDT = D / 8;               // 8-column tiles of dK and dV
  constexpr int kTile = kBlock * LD;
  extern __shared__ __align__(16) unsigned char smem_dkv_f32[];
  float* Ks = reinterpret_cast<float*>(smem_dkv_f32);  // [64][LD]
  float* Vs = Ks + kTile;                              // [64][LD]
  float* Qs = Vs + kTile;                              // [2][64][LD]
  float* dOs = Qs + 2 * kTile;                         // [2][64][LD]
  float* lse_s = dOs + 2 * kTile;                      // [2][64]
  float* delta_s = lse_s + 2 * kBlock;                 // [2][64]
  int* qseg_s = reinterpret_cast<int*>(delta_s + 2 * kBlock);  // [2][64]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.x * kBlock;
  const bool has_seg = kMasked && p.qseg != nullptr;
  const float* qp = head<float>(p.q, p.sq, b, h);
  const float* dop = head<float>(p.dout, p.sdo, b, h);
  const float* lse_bh = p.lse + (long long)bh * p.Tq;
  const float* delta_bh = p.delta + (long long)bh * p.Tq;
  const int* qsp = has_seg ? p.qseg + (long long)b * p.Tq : nullptr;

  const int num_q = (p.Tq + kBlock - 1) / kBlock;
  const int first_q = kMasked ? first_live_q_tile(p, k0) : 0;
  auto stage_q = [&](int qb) {
    const int buf = qb & 1, q0 = qb * kBlock;
    tdl::cp_async_tile<float, D, LD, kBlock, kF32Threads>(Qs + buf * kTile, qp, p.sq.t, q0, p.Tq);
    tdl::cp_async_tile<float, D, LD, kBlock, kF32Threads>(dOs + buf * kTile, dop, p.sdo.t, q0,
                                                          p.Tq);
    if (threadIdx.x < kBlock) {
      const int row = q0 + threadIdx.x;
      const bool in = row < p.Tq;
      const int src = in ? row : 0;
      tdl::cp_async_4(lse_s + buf * kBlock + threadIdx.x, lse_bh + src, in);
      tdl::cp_async_4(delta_s + buf * kBlock + threadIdx.x, delta_bh + src, in);
      if (has_seg) tdl::cp_async_4(qseg_s + buf * kBlock + threadIdx.x, qsp + src, in);
    }
  };

  tdl::cp_async_tile<float, D, LD, kBlock, kF32Threads>(Ks, head<float>(p.k, p.sk, b, h), p.sk.t,
                                                        k0, p.Tk);
  tdl::cp_async_tile<float, D, LD, kBlock, kF32Threads>(Vs, head<float>(p.v, p.sv, b, h), p.sv.t,
                                                        k0, p.Tk);
  if (first_q < num_q) stage_q(first_q);
  tdl::cp_async_commit();

  // this lane's two keys: rows g and g + 8 of the warp's 16
  int key[2], kseg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    key[i] = k0 + warp * 16 + g + 8 * i;
    kseg[i] = (has_seg && key[i] < p.Tk) ? p.kseg[(long long)b * p.Tk + key[i]] : -1;
  }
  float acc[2][kDT][4];  // dV, dK
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < kDT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
  const float scale_log2 = p.scale * kLog2e;

  tdl::cp_async_wait<0>();
  __syncthreads();
  const OwnRows<D, Tiling::kHold> kr(Ks + warp * 16 * LD, lane), vr(Vs + warp * 16 * LD, lane);
  const int b_lane = b_lane_offset<D>(lane);

  for (int qb = first_q; qb < num_q; ++qb) {
    // the stage written here was last read in iteration qb - 1, before the
    // barrier that ended it
    if (qb + 1 < num_q) stage_q(qb + 1);
    tdl::cp_async_commit();

    const int buf = qb & 1, q0 = qb * kBlock;
    const float* Qt = Qs + buf * kTile;
    const float* dOt = dOs + buf * kTile;
    const float* lse_t = lse_s + buf * kBlock;
    const float* delta_t = delta_s + buf * kBlock;
    const int* qseg_t = qseg_s + buf * kBlock;
#pragma unroll 1
    for (int c0 = 0; c0 < kBlock; c0 += kSub) {
      // queries past Tq, or (causal) all before this warp's first key, add
      // nothing
      if (kMasked && (q0 + c0 >= p.Tq ||
                      (p.causal && p.q_offset + q0 + c0 + kSub - 1 < k0 + warp * 16)))
        continue;
      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x kSub queries
      float sd[2][kNT][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sd[m][j][e] = 0.f;
      score_products<D, kNT>(sd, kr, vr, Qt + c0 * LD + b_lane, dOt + c0 * LD + b_lane);
      // P^T and dS^T in place: element e of tile j is key row g + 8 (e >> 1)
      // and query column c0 + 8 j + 2 t + (e & 1)
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int c = c0 + 8 * j + 2 * t;
        const float2 lse2 = *reinterpret_cast<const float2*>(lse_t + c);
        const float2 delta2 = *reinterpret_cast<const float2*>(delta_t + c);
        const float lse[2] = {lse2.x, lse2.y}, delta[2] = {delta2.x, delta2.y};
        float neg_lse[2];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          // a query past Tq or with no live key gets P = 0
          const bool live = !kMasked || (q0 + c + x < p.Tq && lse[x] > kDeadLse);
          neg_lse[x] = live ? -lse[x] * kLog2e : neg_inf();
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, x = e & 1;
          bool live = true;
          if (kMasked) live = key[i] < p.Tk;
          if (kMasked && p.causal) live = live && p.q_offset + q0 + c + x >= key[i];
          if (has_seg) live = live && qseg_t[c + x] == kseg[i];
          const float pe = live ? exp2f(fmaf(sd[0][j][e], scale_log2, neg_lse[x])) : 0.f;
          sd[0][j][e] = pe;
          sd[1][j][e] = pe * (sd[1][j][e] - delta[x]) * p.scale;
        }
      }
      // dV += P^T dO and dK += dS^T Q, 8 queries per step
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int r = c0 + 8 * j + 2 * t;
        const float* const bs[2] = {dOt + r * LD + g, Qt + r * LD + g};
        accumulate<D, 2, kNT>(acc, sd, j, bs);
      }
    }
    // tile qb + 1 has landed, and no warp reads stage qb & 1 any more
    tdl::cp_async_wait<0>();
    __syncthreads();
  }

  if constexpr (kMasked) {
    // Rows with no live key: see flash_bwd_dkv_bf16_kernel.
    int any_dead = 0;
    for (int i = threadIdx.x; i < p.Tq; i += kF32Threads) any_dead |= lse_bh[i] <= kDeadLse;
    if (__syncthreads_or(any_dead)) {
      float dsum[kDT][2];
#pragma unroll
      for (int n = 0; n < kDT; ++n) dsum[n][0] = dsum[n][1] = 0.f;
      for (int r = 0; r < p.Tq; ++r) {
        if (lse_bh[r] > kDeadLse) continue;
#pragma unroll
        for (int n = 0; n < kDT; ++n) {
          const float2 x =
              *reinterpret_cast<const float2*>(dop + r * p.sdo.t + n * 8 + 2 * t);
          dsum[n][0] += x.x;
          dsum[n][1] += x.y;
        }
      }
#pragma unroll
      for (int n = 0; n < kDT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[0][n][e] += dsum[n][e & 1] / float(p.Tk);
    }
  }

  const long long out_off = (long long)bh * p.Tk * D;
  store_f32(acc[0], static_cast<float*>(p.dv) + out_off, k0 + warp * 16, p.Tk, lane);
  store_f32(acc[1], static_cast<float*>(p.dk) + out_off, k0 + warp * 16, p.Tk, lane);
}

// The block owns 64 query rows and sweeps the 64-key tiles; warp w owns
// rows 16 w .. 16 w + 15. It also computes delta for its rows.
template <int D, bool kMasked>
__global__ void __launch_bounds__(kF32Threads) flash_bwd_dq_f32_kernel(Params p) {
  using Tiling = DqF32Tiling<D>;
  constexpr int LD = kLdF<D>;
  constexpr int kSub = Tiling::kSub;
  constexpr int kNT = kSub / 8;           // 8-key tiles of a sub-step
  constexpr int kDT = D / 8;              // 8-column tiles of dQ
  constexpr int kTile = kBlock * LD;
  constexpr int kTpr = kF32Threads / kBlock;  // threads per row of delta
  constexpr int kOC = D / 4 / kTpr;           // out's 16-byte chunks per thread
  extern __shared__ __align__(16) unsigned char smem_dq_f32[];
  float* Qs = reinterpret_cast<float*>(smem_dq_f32);  // [64][LD]
  float* dOs = Qs + kTile;                            // [64][LD]
  float* Ks = dOs + kTile;                            // [2][64][LD]
  float* Vs = Ks + 2 * kTile;                         // [2][64][LD]
  int* kseg_s = reinterpret_cast<int*>(Vs + 2 * kTile);            // [2][64]
  float* delta_s = reinterpret_cast<float*>(kseg_s + 2 * kBlock);  // [64]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * kBlock;
  const bool has_seg = kMasked && p.qseg != nullptr;
  const float* kp = head<float>(p.k, p.sk, b, h);
  const float* vp = head<float>(p.v, p.sv, b, h);
  const float* op = head<float>(p.out, p.so, b, h);
  const int* ksp = has_seg ? p.kseg + (long long)b * p.Tk : nullptr;

  const int n_tiles = kMasked ? live_k_tiles(p, q0) : p.Tk / kBlock;
  auto stage_kv = [&](int kb) {
    const int buf = kb & 1, k0 = kb * kBlock;
    tdl::cp_async_tile<float, D, LD, kBlock, kF32Threads>(Ks + buf * kTile, kp, p.sk.t, k0, p.Tk);
    tdl::cp_async_tile<float, D, LD, kBlock, kF32Threads>(Vs + buf * kTile, vp, p.sv.t, k0, p.Tk);
    if (has_seg && threadIdx.x < kBlock) {
      const int tk = k0 + threadIdx.x;
      tdl::cp_async_4(kseg_s + buf * kBlock + threadIdx.x, ksp + (tk < p.Tk ? tk : 0), tk < p.Tk);
    }
  };

  tdl::cp_async_tile<float, D, LD, kBlock, kF32Threads>(Qs, head<float>(p.q, p.sq, b, h), p.sq.t,
                                                        q0, p.Tq);
  tdl::cp_async_tile<float, D, LD, kBlock, kF32Threads>(dOs, head<float>(p.dout, p.sdo, b, h),
                                                        p.sdo.t, q0, p.Tq);
  if (n_tiles > 0) stage_kv(0);
  tdl::cp_async_commit();

  // delta: kTpr neighbouring threads per row; out's chunks are read while
  // the copies are in flight
  const int dr = threadIdx.x / kTpr, dpart = threadIdx.x % kTpr;
  float4 oc[kOC];
#pragma unroll
  for (int m = 0; m < kOC; ++m)
    oc[m] = q0 + dr < p.Tq ? *reinterpret_cast<const float4*>(op + (q0 + dr) * p.so.t +
                                                               (dpart + kTpr * m) * 4)
                           : make_float4(0.f, 0.f, 0.f, 0.f);

  // this lane's two query rows: g and g + 8 of the warp's 16
  float neg_lse[2];
  int qseg[2], qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + warp * 16 + g + 8 * i;
    const bool in = row < p.Tq;
    const float lse = in ? p.lse[(long long)bh * p.Tq + row] : kNegInf;
    // a row past Tq or with no live key gets P = 0
    neg_lse[i] = (!kMasked || lse > kDeadLse) ? -lse * kLog2e : neg_inf();
    qseg[i] = (has_seg && in) ? p.qseg[(long long)b * p.Tq + row] : 0;
    qpos[i] = p.q_offset + row;
  }

  tdl::cp_async_wait<0>();
  __syncthreads();
  {
    float sum = 0.f;
#pragma unroll
    for (int m = 0; m < kOC; ++m) {
      const float4 d = *reinterpret_cast<const float4*>(dOs + dr * LD + (dpart + kTpr * m) * 4);
      sum = fmaf(d.x, oc[m].x, sum);
      sum = fmaf(d.y, oc[m].y, sum);
      sum = fmaf(d.z, oc[m].z, sum);
      sum = fmaf(d.w, oc[m].w, sum);
    }
#pragma unroll
    for (int s = 1; s < kTpr; s *= 2) sum += __shfl_xor_sync(0xffffffffu, sum, s);
    if (dpart == 0) {
      delta_s[dr] = sum;
      if (q0 + dr < p.Tq) p.delta[(long long)bh * p.Tq + q0 + dr] = sum;
    }
  }
  __syncthreads();
  const float delta[2] = {delta_s[warp * 16 + g], delta_s[warp * 16 + g + 8]};

  const OwnRows<D, Tiling::kHold> qr(Qs + warp * 16 * LD, lane), orr(dOs + warp * 16 * LD, lane);
  const int b_lane = b_lane_offset<D>(lane);
  float acc[1][kDT][4];  // dQ
#pragma unroll
  for (int n = 0; n < kDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][n][e] = 0.f;
  const float scale_log2 = p.scale * kLog2e;
  const int last_qpos = p.q_offset + q0 + warp * 16 + 15;

  for (int kb = 0; kb < n_tiles; ++kb) {
    if (kb + 1 < n_tiles) stage_kv(kb + 1);
    tdl::cp_async_commit();

    const int buf = kb & 1, k0 = kb * kBlock;
    const float* Kt = Ks + buf * kTile;
    const float* Vt = Vs + buf * kTile;
    const int* kseg_t = kseg_s + buf * kBlock;
#pragma unroll 1
    for (int c0 = 0; c0 < kBlock; c0 += kSub) {
      // keys past Tk, or (causal) all after this warp's last row, add nothing
      if (kMasked && (k0 + c0 >= p.Tk || (p.causal && k0 + c0 > last_qpos))) continue;
      // S = Q K^T and dP = dO V^T: this warp's 16 rows x kSub keys
      float sd[2][kNT][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sd[m][j][e] = 0.f;
      score_products<D, kNT>(sd, qr, orr, Kt + c0 * LD + b_lane, Vt + c0 * LD + b_lane);
      // dS in place of dP: element e of tile j is row g + 8 (e >> 1) and key
      // column c0 + 8 j + 2 t + (e & 1)
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int c = c0 + 8 * j + tdl::frag_col(lane, e);
          bool live = true;
          if (kMasked) live = k0 + c < p.Tk;
          if (kMasked && p.causal) live = live && qpos[i] >= k0 + c;
          if (has_seg) live = live && qseg[i] == kseg_t[c];
          const float pe = live ? exp2f(fmaf(sd[0][j][e], scale_log2, neg_lse[i])) : 0.f;
          sd[1][j][e] = pe * (sd[1][j][e] - delta[i]) * p.scale;
        }
      }
      // dQ += dS K, 8 keys per step
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float* const bs[1] = {Kt + (c0 + 8 * j + 2 * t) * LD + g};
        accumulate<D, 1, kNT>(acc, sd, j, bs);
      }
    }
    // tile kb + 1 has landed, and no warp reads stage kb & 1 any more
    tdl::cp_async_wait<0>();
    __syncthreads();
  }

  store_f32(acc[0], static_cast<float*>(p.dq) + (long long)bh * p.Tq * D, q0 + warp * 16, p.Tq,
            lane);
}

// ------------------------------------------------------------------ launch

// A call with a causal mask, segment ids, or Tq or Tk not a multiple of 64
// takes the masked instantiations.
bool is_masked(const Params& p) {
  return p.causal || p.qseg != nullptr || p.Tq % kBlock != 0 || p.Tk % kBlock != 0;
}

template <int D>
cudaError_t launch_bf16(const Params& p, bool dkv, cudaStream_t stream) {
  // one flag word per instantiation: [dkv][masked]
  static std::atomic<unsigned long long> attr_set[2][2];
  const bool masked = is_masked(p);
  void (*kernel)(Params) = nullptr;
  size_t smem = 0;
  if (dkv) {
    kernel = masked ? flash_bwd_dkv_bf16_kernel<D, true> : flash_bwd_dkv_bf16_kernel<D, false>;
    smem = dkv_smem_bytes<D>();
  } else {
    kernel = masked ? flash_bwd_dq_bf16_kernel<D, true> : flash_bwd_dq_bf16_kernel<D, false>;
    smem = dq_smem_bytes<D>();
  }
  const cudaError_t err = tdl::allow_smem(kernel, smem, attr_set[dkv][masked]);
  if (err != cudaSuccess) return err;
  const dim3 grid(((dkv ? p.Tk : p.Tq) + kBlock - 1) / kBlock, p.B * p.H);
  kernel<<<grid, kBf16Threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const Params& p, bool dkv, cudaStream_t stream) {
  static std::atomic<unsigned long long> attr_set[2][2];  // [dkv][masked]
  const bool masked = is_masked(p);
  void (*kernel)(Params) = nullptr;
  size_t smem = 0;
  if (dkv) {
    kernel = masked ? flash_bwd_dkv_f32_kernel<D, true> : flash_bwd_dkv_f32_kernel<D, false>;
    smem = dkv_f32_smem_bytes<D>();
  } else {
    kernel = masked ? flash_bwd_dq_f32_kernel<D, true> : flash_bwd_dq_f32_kernel<D, false>;
    smem = dq_f32_smem_bytes<D>();
  }
  const cudaError_t err = tdl::allow_smem(kernel, smem, attr_set[dkv][masked]);
  if (err != cudaSuccess) return err;
  const dim3 grid(((dkv ? p.Tk : p.Tq) + kBlock - 1) / kBlock, p.B * p.H);
  kernel<<<grid, kF32Threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Params& p, int dtype, bool dkv, cudaStream_t stream) {
  switch (dtype) {
    case 0: return launch_f32<D>(p, dkv, stream);
    case 1: return launch_bf16<D>(p, dkv, stream);
    default: return cudaErrorInvalidValue;
  }
}

int run(const Params& p, int D, int dtype, bool dkv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(p, dtype, dkv, s);
    case 32: return launch<32>(p, dtype, dkv, s);
    case 64: return launch<64>(p, dtype, dkv, s);
    case 128: return launch<128>(p, dtype, dkv, s);
    default: return cudaErrorInvalidValue;
  }
}

Params make_params(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, void* delta, const void* qseg, const void* kseg, int B,
                   int H, int Tq, int Tk, int causal, float scale, int q_offset) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.qseg = static_cast<const int*>(qseg);
  p.kseg = static_cast<const int*>(kseg);
  p.B = B;
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.causal = causal;
  p.scale = scale;
  p.q_offset = q_offset;
  return p;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are (b, h, t) of each strided
// tensor, in the order of the pointers. Every row of those tensors must be
// 16-byte aligned (the wrappers check the pointers and strides). Each
// returns the launch's cudaError_t.

// dk, dv from q, k, v, dO, lse and the delta that tdl_flash_bwd_dq wrote.
int tdl_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, const void* qseg, const void* kseg,
                      void* dk, void* dv, int B, int H, int Tq, int Tk, int D, int dtype,
                      long long q_sb, long long q_sh, long long q_st, long long k_sb,
                      long long k_sh, long long k_st, long long v_sb, long long v_sh,
                      long long v_st, long long do_sb, long long do_sh, long long do_st,
                      int causal, float scale, int q_offset, void* stream) {
  Params p = make_params(q, k, v, dout, lse, const_cast<void*>(delta), qseg, kseg, B, H, Tq, Tk,
                         causal, scale, q_offset);
  p.dk = dk;
  p.dv = dv;
  p.sq = {q_sb, q_sh, q_st};
  p.sk = {k_sb, k_sh, k_st};
  p.sv = {v_sb, v_sh, v_st};
  p.sdo = {do_sb, do_sh, do_st};
  return run(p, D, dtype, true, stream);
}

// dq and delta = rowsum(dO * out) (float32 [B, H, Tq]) from q, k, v, the
// forward's out, dO and lse.
int tdl_flash_bwd_dq(const void* q, const void* k, const void* v, const void* out,
                     const void* dout, const void* lse, void* delta, const void* qseg,
                     const void* kseg, void* dq, int B, int H, int Tq, int Tk, int D,
                     int dtype, long long q_sb, long long q_sh, long long q_st, long long k_sb,
                     long long k_sh, long long k_st, long long v_sb, long long v_sh,
                     long long v_st, long long o_sb, long long o_sh, long long o_st,
                     long long do_sb, long long do_sh, long long do_st, int causal,
                     float scale, int q_offset, void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, qseg, kseg, B, H, Tq, Tk, causal, scale,
                         q_offset);
  p.out = out;
  p.dq = dq;
  p.sq = {q_sb, q_sh, q_st};
  p.sk = {k_sb, k_sh, k_st};
  p.sv = {v_sb, v_sh, v_st};
  p.so = {o_sb, o_sh, o_st};
  p.sdo = {do_sb, do_sh, do_st};
  return run(p, D, dtype, false, stream);
}

const char* tdl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
