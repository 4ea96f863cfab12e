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
// float32 inputs: flash_bwd_dkv_fma_kernel and flash_bwd_dq_fma_kernel,
// float32 FMA on the CUDA cores (the first version of these kernels, kept for
// float32: the float32 train-step check depends on its exact float32
// products). 256 threads form a 16 x 16 grid over the 64 x 64 tile: in the
// score phase a thread computes S and dO v^T for 4 rows x 4 keys; P and dS go
// through shared memory; in the accumulation phase a thread owns 4 rows
// (keys in dkv, queries in dq) x D/16 columns. Tiles are float32 with a row
// stride of D+1 (166 KB of shared memory at D=128, 100 KB at D=64). The dq
// kernel computes delta with four threads per row.
//
// Bound on the H100 at the BERT-base training shape (B=16, H=12, T=128,
// D=64, bf16): dkv reads q, dO, k, v (4 x 3.15 MB), lse and delta (2 x
// 98 KB) and writes dk, dv (2 x 3.15 MB): 19.07 MB, 5.7 us at 3.35 TB/s,
// against 8 T^2 D B H = 1.61 GFLOP, 1.6 us at the bf16 tensor-core peak
// (2.8 us with the split's extra products); dq reads q, k, v, out, dO and
// lse and writes dq and delta: also 19.07 MB (5.7 us), for 1.21 GFLOP. Both
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

// The q-tiles a 64-key tile at k0 meets: all of them, or under `causal`
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

// --------------------------------------------------- float32: CUDA cores

constexpr int kThreads = 256;
constexpr int kGroups = 16;             // a 16 x 16 thread grid over a tile
constexpr int kPer = kBlock / kGroups;  // rows (and columns) per thread: 4
constexpr int kLdt = kBlock + 1;        // row stride of the P and dS tiles

// Q, dO, K, V tiles of 64 x (D+1) floats, P and dS of 64 x 65, then lse,
// delta, qseg and kseg of the current tiles.
template <int D>
constexpr size_t fma_smem_bytes() {
  return (4 * size_t(kBlock) * (D + 1) + 2 * size_t(kBlock) * kLdt + 2 * kBlock) *
             sizeof(float) +
         2 * kBlock * sizeof(int);
}

template <int D>
struct Smem {
  float *Qs, *dOs, *Ks, *Vs, *Ps, *dSs, *lse, *delta;
  int *qseg, *kseg;

  __device__ explicit Smem(float* base) {
    constexpr int LD = D + 1;
    Qs = base;
    dOs = Qs + kBlock * LD;
    Ks = dOs + kBlock * LD;
    Vs = Ks + kBlock * LD;
    Ps = Vs + kBlock * LD;
    dSs = Ps + kBlock * kLdt;
    lse = dSs + kBlock * kLdt;
    delta = lse + kBlock;
    qseg = reinterpret_cast<int*>(delta + kBlock);
    kseg = qseg + kBlock;
  }
};

// rows t0 .. t0+63 of a [T, D] slab (row stride stride_t); rows past T_len
// are zero
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, long long stride_t,
                                           int t0, int T_len) {
  constexpr int LD = D + 1;
  for (int i = threadIdx.x; i < kBlock * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int t = t0 + r;
    dst[r * LD + d] = t < T_len ? src[t * stride_t + d] : 0.f;
  }
}

// lse, qseg and (dkv) delta of the q-tile at q0; rows past Tq get lse =
// -1e30, so that they count as rows with no live key (P = 0)
template <int D>
__device__ __forceinline__ void stage_row_stats(const Smem<D>& sm, const Params& p, int b,
                                                int bh, int q0, bool with_delta) {
  for (int i = threadIdx.x; i < kBlock; i += kThreads) {
    const int row = q0 + i;
    const bool in = row < p.Tq;
    sm.lse[i] = in ? p.lse[(long long)bh * p.Tq + row] : kNegInf;
    if (with_delta) sm.delta[i] = in ? p.delta[(long long)bh * p.Tq + row] : 0.f;
    sm.qseg[i] = (in && p.qseg != nullptr) ? p.qseg[(long long)b * p.Tq + row] : 0;
  }
}

template <int D>
__device__ __forceinline__ void stage_kseg(const Smem<D>& sm, const Params& p, int b, int k0) {
  if (p.kseg == nullptr) return;
  for (int i = threadIdx.x; i < kBlock; i += kThreads)
    sm.kseg[i] = k0 + i < p.Tk ? p.kseg[(long long)b * p.Tk + k0 + i] : -1;
}

// P (if kWriteP) and dS of the (q-tile q0, k-tile k0) pair into shared
// memory, [query row][key]. Thread (tr, tc) computes rows tr + 16 i and keys
// tc + 16 j.
template <int D, bool kWriteP>
__device__ __forceinline__ void tile_p_ds(const Smem<D>& sm, const Params& p, int q0, int k0) {
  constexpr int LD = D + 1;
  const int tr = threadIdx.x / kGroups, tc = threadIdx.x % kGroups;
  float s[kPer][kPer], dp[kPer][kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float qv[kPer], ov[kPer], kv[kPer], vv[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      qv[i] = sm.Qs[(tr + kGroups * i) * LD + d];
      ov[i] = sm.dOs[(tr + kGroups * i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      kv[j] = sm.Ks[(tc + kGroups * j) * LD + d];
      vv[j] = sm.Vs[(tc + kGroups * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
  const bool has_seg = p.qseg != nullptr;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = tr + kGroups * i;
    const float lse = sm.lse[r];
    const bool row_live = lse > kDeadLse;
    const int qpos = p.q_offset + q0 + r;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = tc + kGroups * j;
      bool live = row_live && k0 + c < p.Tk;
      if (p.causal) live = live && qpos >= k0 + c;
      if (has_seg) live = live && sm.qseg[r] == sm.kseg[c];
      const float pij = live ? expf(s[i][j] * p.scale - lse) : 0.f;
      if (kWriteP) sm.Ps[r * kLdt + c] = pij;
      sm.dSs[r * kLdt + c] = pij * (dp[i][j] - sm.delta[r]) * p.scale;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_fma_kernel(Params p) {
  constexpr int LD = D + 1;
  constexpr int CPT = D / kGroups;  // output columns per thread
  extern __shared__ float smem[];
  const Smem<D> sm(smem);

  const int tr = threadIdx.x / kGroups, tc = threadIdx.x % kGroups;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.x * kBlock;
  const float* qp = head<float>(p.q, p.sq, b, h);
  const float* dop = head<float>(p.dout, p.sdo, b, h);

  stage_rows<D>(sm.Ks, head<float>(p.k, p.sk, b, h), p.sk.t, k0, p.Tk);
  stage_rows<D>(sm.Vs, head<float>(p.v, p.sv, b, h), p.sv.t, k0, p.Tk);
  stage_kseg<D>(sm, p, b, k0);

  float dk[kPer][CPT], dv[kPer][CPT];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dk[i][c] = dv[i][c] = 0.f;

  const int num_q = (p.Tq + kBlock - 1) / kBlock;
  for (int qb = first_live_q_tile(p, k0); qb < num_q; ++qb) {
    const int q0 = qb * kBlock;
    __syncthreads();  // the previous q-tile's Q, dO, P and dS are no longer read
    stage_rows<D>(sm.Qs, qp, p.sq.t, q0, p.Tq);
    stage_rows<D>(sm.dOs, dop, p.sdo.t, q0, p.Tq);
    stage_row_stats<D>(sm, p, b, bh, q0, true);
    __syncthreads();
    tile_p_ds<D, true>(sm, p, q0, k0);
    __syncthreads();
    // dV += P^T dO and dK += dS^T Q: this thread's keys tr + 16 i, columns
    // tc + 16 c
    const int q_len = min(kBlock, p.Tq - q0);
    for (int r = 0; r < q_len; ++r) {
      float pv[kPer], sv[kPer], ov[CPT], qv[CPT];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        pv[i] = sm.Ps[r * kLdt + tr + kGroups * i];
        sv[i] = sm.dSs[r * kLdt + tr + kGroups * i];
      }
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        ov[c] = sm.dOs[r * LD + tc + kGroups * c];
        qv[c] = sm.Qs[r * LD + tc + kGroups * c];
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          dv[i][c] = fmaf(pv[i], ov[c], dv[i][c]);
          dk[i][c] = fmaf(sv[i], qv[c], dk[i][c]);
        }
    }
  }

  // Rows with no live key: see flash_bwd_dkv_bf16_kernel.
  const float* lse_bh = p.lse + (long long)bh * p.Tq;
  int any_dead = 0;
  for (int i = threadIdx.x; i < p.Tq; i += kThreads) any_dead |= lse_bh[i] <= kDeadLse;
  if (__syncthreads_or(any_dead)) {
    float dsum[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) dsum[c] = 0.f;
    for (int r = 0; r < p.Tq; ++r) {
      if (lse_bh[r] > kDeadLse) continue;
#pragma unroll
      for (int c = 0; c < CPT; ++c) dsum[c] += dop[r * p.sdo.t + tc + kGroups * c];
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) dv[i][c] += dsum[c] / float(p.Tk);
  }

  float* dkp = static_cast<float*>(p.dk) + (long long)bh * p.Tk * D;
  float* dvp = static_cast<float*>(p.dv) + (long long)bh * p.Tk * D;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int key = k0 + tr + kGroups * i;
    if (key >= p.Tk) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const long long off = (long long)key * D + tc + kGroups * c;
      dkp[off] = dk[i][c];
      dvp[off] = dv[i][c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_fma_kernel(Params p) {
  constexpr int LD = D + 1;
  constexpr int CPT = D / kGroups;
  extern __shared__ float smem[];
  const Smem<D> sm(smem);

  const int tr = threadIdx.x / kGroups, tc = threadIdx.x % kGroups;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * kBlock;
  const float* kp = head<float>(p.k, p.sk, b, h);
  const float* vp = head<float>(p.v, p.sv, b, h);

  stage_rows<D>(sm.Qs, head<float>(p.q, p.sq, b, h), p.sq.t, q0, p.Tq);
  stage_rows<D>(sm.dOs, head<float>(p.dout, p.sdo, b, h), p.sdo.t, q0, p.Tq);
  stage_row_stats<D>(sm, p, b, bh, q0, false);
  __syncthreads();

  // delta = rowsum(dO * out): four threads per row, 64 rows
  {
    const int r = threadIdx.x / 4, part = threadIdx.x % 4;
    const int row = q0 + r;
    const float* op = head<float>(p.out, p.so, b, h) + row * p.so.t;
    float sum = 0.f;
    if (row < p.Tq)
      for (int d = part; d < D; d += 4) sum = fmaf(sm.dOs[r * LD + d], op[d], sum);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (part == 0) {
      sm.delta[r] = sum;
      if (row < p.Tq) p.delta[(long long)bh * p.Tq + row] = sum;
    }
  }

  float dq[kPer][CPT];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dq[i][c] = 0.f;

  const int n_tiles = live_k_tiles(p, q0);
  for (int kb = 0; kb < n_tiles; ++kb) {
    const int k0 = kb * kBlock;
    __syncthreads();  // delta, or the previous k-tile's K, V and dS, are done
    stage_rows<D>(sm.Ks, kp, p.sk.t, k0, p.Tk);
    stage_rows<D>(sm.Vs, vp, p.sv.t, k0, p.Tk);
    stage_kseg<D>(sm, p, b, k0);
    __syncthreads();
    tile_p_ds<D, false>(sm, p, q0, k0);
    __syncthreads();
    // dQ += dS K: this thread's rows tr + 16 i, columns tc + 16 c
    const int k_len = min(kBlock, p.Tk - k0);
    for (int j = 0; j < k_len; ++j) {
      float sv[kPer], kv[CPT];
#pragma unroll
      for (int i = 0; i < kPer; ++i) sv[i] = sm.dSs[(tr + kGroups * i) * kLdt + j];
#pragma unroll
      for (int c = 0; c < CPT; ++c) kv[c] = sm.Ks[j * LD + tc + kGroups * c];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) dq[i][c] = fmaf(sv[i], kv[c], dq[i][c]);
    }
  }

  float* dqp = static_cast<float*>(p.dq) + (long long)bh * p.Tq * D;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int row = q0 + tr + kGroups * i;
    if (row >= p.Tq) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c) dqp[(long long)row * D + tc + kGroups * c] = dq[i][c];
  }
}

// ------------------------------------------------------------------ launch

template <int D>
cudaError_t launch_bf16(const Params& p, bool dkv, const dim3& grid, cudaStream_t stream) {
  // one flag word per instantiation: [dkv][masked]
  static std::atomic<unsigned long long> attr_set[2][2];
  const bool masked = p.causal || p.qseg != nullptr || p.Tq % kBlock != 0 || p.Tk % kBlock != 0;
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
  kernel<<<grid, kBf16Threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fma(const Params& p, bool dkv, const dim3& grid, cudaStream_t stream) {
  static std::atomic<unsigned long long> attr_set[2];
  void (*kernel)(Params) = dkv ? flash_bwd_dkv_fma_kernel<D> : flash_bwd_dq_fma_kernel<D>;
  constexpr size_t smem = fma_smem_bytes<D>();
  const cudaError_t err = tdl::allow_smem(kernel, smem, attr_set[dkv]);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Params& p, int dtype, bool dkv, cudaStream_t stream) {
  const int tiles = ((dkv ? p.Tk : p.Tq) + kBlock - 1) / kBlock;
  const dim3 grid(tiles, p.B * p.H);
  switch (dtype) {
    case 0: return launch_fma<D>(p, dkv, grid, stream);
    case 1: return launch_bf16<D>(p, dkv, grid, stream);
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
// tensor, in the order of the pointers. For bfloat16, every row of those
// tensors must be 16-byte aligned (the wrappers check the pointers and
// strides). Each returns the launch's cudaError_t.

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
