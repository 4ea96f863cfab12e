// Flash-attention forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernel `_flash_kernel` in
// deeplearning4j_tpu/kernels/attention.py:70 (launched by `_flash_forward`,
// attention.py:132). It computes, for q [B,H,Tq,D] and k, v [B,H,Tk,D]:
//
//   s    = (q k^T) * scale, in float32, masked to -1e30 where
//          causal: q_offset + i < j   or   segments: qseg[i] != kseg[j]
//   out  = softmax(s) v                 (in the inputs' dtype)
//   lse  = m + log(l)                   (float32, per query row)
//
// with the TPU kernel's numerics: float32 scores and accumulators, the
// finite -1e30 mask, online rescaling by exp(s - m_new), and out = acc / l.
// Keys past Tk (the ragged edge of the last tile) are left out of the sum.
// A row with no live key at all gets the uniform softmax over the Tk keys,
// as the dense reference gives it: the mean of v, with lse = -1e30 + log Tk.
//
// Grid. The TPU grid walks the k-blocks of one q-block in order and keeps
// the running max / sum / accumulator in VMEM scratch between grid steps.
// Blocks of a CUDA grid run in no order, so here a thread block owns one
// (batch*head, q-tile) and loops over the 64-key tiles itself; m, l and acc
// stay in registers for the whole sweep. The q-tile height is chosen at
// launch (`block_q`, from the wrapper's autotune table, kernels/autotune.py):
// 32, 64 or 128 rows for bf16, 16 or 32 for float32; 0 takes the kernel's
// default, 64 rows for bf16 and f32_row_groups's rule for float32. At the
// BERT-base shape (B=8, H=12, T=128) 64-row tiles make 192 blocks on the
// H100's 132 SMs, all resident at once. The heights were measured, not
// carried over (PERF.md §6): 64 rows are the fastest or within 3% of it at
// the serving, training and causal 512-token prefill shapes; 128 rows (8
// warps) lose at the training shape and at the prefill (48 blocks), 32 rows
// (K and V read twice as often) at the training shape. Under `causal`,
// k-tiles that lie wholly above the diagonal for every row of the q-tile are
// skipped, as `_block_live` does on the TPU.
//
// Two kernels share that scheme.
//
// bfloat16 inputs: flash_fwd_bf16_kernel<D, rows, masked>, on the tensor
// cores. Each warp owns 16 query rows (two, four or eight warps). A call
// with no causal mask, no segment ids and Tk a multiple of 64 takes an
// instantiation without mask tests.
//   - Q, K and V are staged in shared memory as bf16 (row stride D+8, see
//     attention_tiles.cuh) by 16-byte cp.async copies; rows past Tq or Tk
//     are zero-filled by the copy itself. K, V and the key segment ids go
//     through a two-stage ring: the copy of tile kb+1 is in flight while the
//     warps compute on tile kb, with one barrier per tile. The wrapper
//     checks that q, k and v are 16-byte aligned in every row.
//   - Q is moved once into mma.sync A fragments that stay in registers for
//     the whole sweep.
//   - S = Q K^T is mma.sync m16n8k16 (bf16 x bf16 -> float32) with K
//     fragments from ldmatrix: a bf16 product is exact in float32, so the
//     scores are the TPU kernel's float32 scores, summed in another order.
//   - The masks, the row max and the online softmax run on the accumulator
//     fragments in registers; a row's max is a shuffle over the four lanes
//     that hold it, and its sum stays per lane until the end. exp(x) is
//     computed as exp2(x log2 e): a few float32 ulps, far below what the
//     split of P below leaves.
//   - P V: the accumulator of S is the A operand of the next mma.sync, so P
//     never goes to shared memory; V fragments come from ldmatrix.trans. The
//     TPU kernel multiplies a float32 P by V. Rounding P to bf16 once would
//     cost about 2^-9 |v| ||p||_2 / l, above one bf16 ulp of an output near
//     zero; so P = P_hi + P_lo (two bf16 terms, P_lo = bf16(P - P_hi)) and
//     two mma.sync go into the same float32 accumulator, which keeps P to
//     about 2^-16 of its value.
//   - out = acc / l is rounded to bf16 once, staged through shared memory
//     and written with 16-byte stores.
// Shared memory: Q and two stages of K and V, (rows + 4 x 64) x (D+8) bf16,
// plus the key segment ids: 46.6 KB at D=64 with 64 rows, 104.9 KB at
// D=128 with 128 rows.
//
// float32 inputs: flash_fwd_f32_kernel<D, kRowGroups>, on the TF32 tensor
// cores with split operands (3xTF32). Generation's prefill (B=1, causal,
// 32..512-token buckets) and the float32 train-step check run it; their
// token identity and gradient checks need float32 products, and one TF32
// product (10 mantissa bits) would miss phase 2's 2e-5 by far.
//   - Products: every operand x of Q K^T and P V is split x = hi + lo (hi
//     = x rounded to TF32, lo = x - hi, which the tensor core truncates),
//     and mma.sync m16n8k8 adds lo*hi, hi*lo and hi*hi in float32: each
//     product to about 2^-21 of |x y| (attention_tiles.cuh). The split is
//     three integer and float operations; cvt.rna.tf32.f32 would be eight
//     or nine. A warp runs its instructions in order and a product's sum
//     is ready some 30 cycles after it starts, so consecutive mma.sync
//     write different accumulators: S's three terms go to three
//     accumulators (and two copies by k-step parity at 16 keys), O's tiles
//     are taken eight at a time, term by term. Bound: three TF32 products
//     per float32 product, 495 / 3 = 165 TFLOP/s, above the CUDA cores' 67
//     TFLOP/s.
//   - Staging: Q, and K and V through a two-stage ring of 64-key tiles, go
//     to shared memory as float32 (row stride D+4: conflict-free fragment
//     loads, 16-byte rows) by cp.async, one barrier per tile; the wrapper
//     checks that q, k and v are 16-byte aligned in every row. Q's A
//     fragments are then held in registers, split, for the whole sweep
//     (16-row q-tiles at D <= 64) or read and split at each use (32-row
//     q-tiles, D = 128). B fragments are scalar shared-memory loads.
//   - P stays in registers: the S accumulator is the A operand of P V with
//     the keys of each 8-key tile taken in the order 0, 2, 4, 6, 1, 3, 5, 7
//     and V's rows read in that order (attention_tiles.cuh).
//   - Filling the card at batch 1. The q-tile is 16 or 32 rows (one or two
//     row groups of 16) and the block's four warps split every k-tile
//     between the row groups' key groups: at 16 rows each warp takes 16
//     keys of each tile, with its own (m, l, acc), and the epilogue combines
//     the four parts of a row in shared memory in a fixed order (no
//     atomics: the same bits from run to run). A launch that names no height
//     takes 32-row q-tiles where they still give every SM two blocks
//     (f32_row_groups): a causal 512-token prefill of 12 heads runs 384
//     blocks of 16 rows, the B=16 training shape 768 blocks of 32 rows.
//   - Causal imbalance: q-tiles are numbered from the last, so the blocks
//     that walk the most k-tiles are scheduled first; a warp whose keys of a
//     tile lie above the diagonal for all its rows skips the tile's
//     products.
// Shared memory: two stages of K and V, 4 x 64 x (D+4) float32, the key
// segment ids, and Q where it is read at each use: 70.1 KB (16 rows) and
// 78.8 KB (32 rows) at D=64, 144.1 and 152.6 KB at D=128.
//
// Bound on the H100 at the BERT-base shape (B=8, H=12, T=128, D=64, bf16):
// the call must read q, k, v and write out (4 x 1.57 MB) and lse (49 KB),
// 6.34 MB, or 1.9 us at 3.35 TB/s; its two products are 0.40 GFLOP, 0.4 us at
// the bf16 tensor-core peak (three products with the split of P: 0.6 us). So
// the bound is the bytes, and mma.sync tiles suffice: wgmma and TMA pay off
// where the tensor-core rate becomes the limit (long prefill), not here.
// float32 at a causal 512-token prefill (B=1, H=12, D=64): 0.40 GFLOP of
// live products, 2.4 us at 165 TFLOP/s (3xTF32), above the 6.3 MB of bytes
// (1.9 us): the products bound it.
// PERF.md records the measured times beside the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

#include "attention_tiles.cuh"

namespace {

constexpr int kBlockK = 64;    // keys per k-tile, both kernels
constexpr float kNegInf = -1e30f;  // finite mask, as on the TPU

struct Strides {
  long long b, h, t;  // element strides; the last axis must be contiguous
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* qseg;  // [B, Tq] or null
  const int* kseg;  // [B, Tk] or null
  void* out;        // [B, H, Tq, D], contiguous
  float* lse;       // [B, H, Tq], contiguous
  int B, H, Tq, Tk;
  Strides sq, sk, sv;
  int causal;
  float scale;
  int q_offset;     // Tk - Tq: aligns causal rows to the end of the keys
};

// k-tiles a q-tile of `block_q` rows at q0 sweeps: all of them, or under
// `causal` those up to the last one that holds a key at or below its last row.
__device__ __forceinline__ int live_k_tiles(const Params& p, int q0, int block_q) {
  const int num_k = (p.Tk + kBlockK - 1) / kBlockK;
  if (!p.causal) return num_k;
  const int last = p.q_offset + q0 + block_q - 1;  // last row's last live key
  return last < 0 ? 0 : min(num_k, last / kBlockK + 1);
}

// ------------------------------------------------------ bf16: tensor cores

// Query rows of a block (the q-tile height): 32, 64 or 128, one warp per 16
// rows; 64 unless the launch asks for another.
constexpr int kBf16DefaultRows = 64;
template <int kRows>
constexpr int kBf16Threads = 2 * kRows;  // one warp per 16 query rows
constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = exp2(x log2 e)

// row stride, in elements, of a bf16 tile in shared memory
template <int D>
constexpr int kLd = D + 8;

template <int D, int kRows>
constexpr size_t bf16_smem_bytes() {
  return size_t(kRows + 4 * kBlockK) * kLd<D> * sizeof(__nv_bfloat16) +
         2 * kBlockK * sizeof(int);
}

// rows [t0, t0 + kTileRows) of a [T, D] bf16 slab into a kTileRows x (D+8)
// tile, by the kThreads threads of the block
template <int D, int kTileRows, int kThreads>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* tile, const __nv_bfloat16* src,
                                           long long stride_t, int t0, int T) {
  tdl::cp_async_rows<D, kTileRows, kThreads>(tile, src, stride_t, t0, T);
}

// kMasked: the call has a causal mask, segment ids, or a ragged last k-tile
// (Tk not a multiple of 64). The unmasked instantiation drops every mask
// test from the softmax, the main path's case (BERT-base serving and
// training at T=128).
template <int D, int kRows, bool kMasked>
__global__ void __launch_bounds__(2 * kRows) flash_fwd_bf16_kernel(Params p) {
  constexpr int kThreads = kBf16Threads<kRows>;
  static_assert(kRows % 16 == 0 && kThreads >= kBlockK, "q-tile of whole warps");
  constexpr int LD = kLd<D>;
  constexpr int kSteps = D / 16;       // 16-deep steps of Q K^T
  constexpr int kNT = kBlockK / 8;     // 8-key accumulator tiles of S
  constexpr int kDT = D / 8;           // 8-column accumulator tiles of O
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_bf16);
  __nv_bfloat16* Ks = Qs + kRows * LD;         // [2][64][LD]
  __nv_bfloat16* Vs = Ks + 2 * kBlockK * LD;   // [2][64][LD]
  int* kseg_s = reinterpret_cast<int*>(Vs + 2 * kBlockK * LD);  // [2][64]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * kRows;
  const bool has_seg = p.qseg != nullptr;

  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(p.q) + b * p.sq.b + h * p.sq.h;
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(p.k) + b * p.sk.b + h * p.sk.h;
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(p.v) + b * p.sv.b + h * p.sv.h;
  const int* ksp = has_seg ? p.kseg + (long long)b * p.Tk : nullptr;

  const int n_tiles = live_k_tiles(p, q0, kRows);
  auto stage_kv = [&](int kb) {
    const int buf = kb & 1, k0 = kb * kBlockK;
    stage_bf16<D, kBlockK, kThreads>(Ks + buf * kBlockK * LD, kp, p.sk.t, k0, p.Tk);
    stage_bf16<D, kBlockK, kThreads>(Vs + buf * kBlockK * LD, vp, p.sv.t, k0, p.Tk);
    if (has_seg && threadIdx.x < kBlockK) {
      const int t = k0 + threadIdx.x;
      tdl::cp_async_4(kseg_s + buf * kBlockK + threadIdx.x, ksp + (t < p.Tk ? t : 0),
                      t < p.Tk);
    }
  };

  stage_bf16<D, kRows, kThreads>(Qs, qp, p.sq.t, q0, p.Tq);
  if (n_tiles > 0) stage_kv(0);
  tdl::cp_async_commit();

  // this lane's two query rows: g and g + 8 of the warp's 16
  const int row0 = warp * 16 + (lane >> 2);
  int qseg[2], qpos[2];
  float m[2], l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + row0 + 8 * i;
    qseg[i] = (has_seg && row < p.Tq) ? p.qseg[(long long)b * p.Tq + row] : 0;
    qpos[i] = p.q_offset + row;
    m[i] = kNegInf;
    l[i] = 0.f;  // this lane's share of the row sum
  }
  float acc[kDT][4];
#pragma unroll
  for (int n = 0; n < kDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  tdl::cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[kSteps][4];
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks)
    tdl::ldmatrix_x4(qf[ks], Qs + tdl::a_ldsm_offset(lane, LD, warp * 16, ks * 16));

  for (int kb = 0; kb < n_tiles; ++kb) {
    // the stage written here was last read in iteration kb - 1, before the
    // barrier that ended it
    if (kb + 1 < n_tiles) stage_kv(kb + 1);
    tdl::cp_async_commit();

    const int buf = kb & 1, k0 = kb * kBlockK;
    const __nv_bfloat16* Kt = Ks + buf * kBlockK * LD;
    const __nv_bfloat16* Vt = Vs + buf * kBlockK * LD;
    const int* kseg_t = kseg_s + buf * kBlockK;

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) tdl::mma_a_bt(s, qf[ks], Kt, LD, lane, 0, ks * 16);

    // scale and masks; the row max over the keys before Tk
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int c = j * 8 + tdl::frag_col(lane, e);
        bool live = true;
        if (kMasked && p.causal) live = qpos[i] >= k0 + c;
        if (kMasked && has_seg) live = live && qseg[i] == kseg_t[c];
        s[j][e] = live ? s[j][e] * p.scale : kNegInf;
        if (!kMasked || k0 + c < p.Tk) mx[i] = fmaxf(mx[i], s[j][e]);
      }
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = exp2f((m[i] - m_new) * kLog2e);
      m[i] = m_new;
      l[i] *= corr[i];
    }
    // s becomes p = exp(s - m), 0 past Tk
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int c = j * 8 + tdl::frag_col(lane, e);
        const float pj = !kMasked || k0 + c < p.Tk ? exp2f((s[j][e] - m[i]) * kLog2e) : 0.f;
        s[j][e] = pj;
        l[i] += pj;
      }
    }
#pragma unroll
    for (int n = 0; n < kDT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];

    // O += P V, P = P_hi + P_lo from registers, 16 keys per step
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      tdl::split_a_frag(s[2 * kk], s[2 * kk + 1], ph, pl);
      tdl::mma_split_a_b(acc, ph, pl, Vt, LD, lane, kk * 16);
    }

    // tile kb + 1 has landed, and no warp reads stage kb & 1 any more
    tdl::cp_async_wait<0>();
    __syncthreads();
  }

  // the row sums over the four lanes that share a row
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }

  // Rows with no live key: uniform softmax over the Tk original keys. The
  // sweep above may have skipped tiles, so the mean of v is taken anew.
  bool dead[2];
  int any_dead = 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    dead[i] = q0 + row0 + 8 * i < p.Tq && m[i] == kNegInf;
    any_dead |= dead[i];
  }
  if (__syncthreads_or(any_dead)) {
    float vsum[kDT][2];
#pragma unroll
    for (int n = 0; n < kDT; ++n) vsum[n][0] = vsum[n][1] = 0.f;
    const int num_k = (p.Tk + kBlockK - 1) / kBlockK;
    for (int kb = 0; kb < num_k; ++kb) {
      __syncthreads();  // the previous tile is no longer read
      stage_bf16<D, kBlockK, kThreads>(Vs, vp, p.sv.t, kb * kBlockK, p.Tk);
      tdl::cp_async_commit();
      tdl::cp_async_wait<0>();
      __syncthreads();
      for (int j = 0; j < kBlockK; ++j) {  // rows past Tk are zero
#pragma unroll
        for (int n = 0; n < kDT; ++n) {
          const float2 v2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              Vs + j * LD + n * 8 + tdl::frag_col(lane, 0)));
          vsum[n][0] += v2.x;
          vsum[n][1] += v2.y;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!dead[i]) continue;
      l[i] = float(p.Tk);
#pragma unroll
      for (int n = 0; n < kDT; ++n) {
        acc[n][2 * i] = vsum[n][0];
        acc[n][2 * i + 1] = vsum[n][1];
      }
    }
  }

  // out = acc / l in bf16: each warp stages its 16 rows in its own rows of
  // the Q tile (read only by this warp, long since), then writes them back
  // with 16-byte stores
  __nv_bfloat16* Os = Qs + warp * 16 * LD;
  const float inv_l[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
  for (int n = 0; n < kDT; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint32_t*>(Os + ((lane >> 2) + 8 * i) * LD + n * 8 +
                                   tdl::frag_col(lane, 0)) =
          tdl::pack_bf16(acc[n][2 * i] * inv_l[i], acc[n][2 * i + 1] * inv_l[i]);
  __syncwarp();
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(p.out) + (long long)bh * p.Tq * D;
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int c = lane; c < 16 * kChunks; c += 32) {
    const int r = c / kChunks, ch = c % kChunks;
    const int row = q0 + warp * 16 + r;
    if (row < p.Tq)
      *reinterpret_cast<uint4*>(op + (long long)row * D + ch * 8) =
          *reinterpret_cast<const uint4*>(Os + r * LD + ch * 8);
  }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + row0 + 8 * i;
      if (row < p.Tq) p.lse[(long long)bh * p.Tq + row] = m[i] + logf(l[i]);
    }
  }
}

// ------------------------------------------- float32: split-TF32 tensor cores

// A block is four warps. Its q-tile is kRowGroups x 16 rows, and its four
// warps are kRowGroups row groups times kSplits key groups: the warp (r, s)
// owns rows 16 r .. 16 r + 15 of the q-tile and keys s KW .. s KW + KW - 1 of
// every 64-key tile (KW = 64 / kSplits). Each warp keeps its own (m, l, acc)
// over its keys; the epilogue combines the kSplits partial results of a row
// in shared memory, in float32 and in a fixed order (no atomics).
constexpr int kF32Threads = 128;
constexpr int kF32Warps = kF32Threads / 32;

// row stride, in floats, of a float32 tile in shared memory: D + 4 puts the
// eight rows a fragment load touches on eight distinct groups of 4 banks
// (conflict-free scalar loads of the B operands of both products) and keeps
// every row 16-byte aligned for cp.async
template <int D>
constexpr int kLdF = D + 4;

// Q's A fragments stay in registers, split, for the whole sweep only where
// that fits beside the rest: 16-row q-tiles at D <= 64 (each warp's S is
// then 16 x 16). Elsewhere Q is staged in shared memory and its fragments
// are loaded and split at each use.
template <int D, int kRowGroups>
constexpr bool kQInRegisters = D <= 64 && kRowGroups == 1;

template <int D, int kRowGroups>
constexpr size_t f32_smem_bytes() {
  return (size_t(4 * kBlockK) + (kQInRegisters<D, kRowGroups> ? 0 : 16 * kRowGroups)) *
             kLdF<D> * sizeof(float) +
         2 * kBlockK * sizeof(int);
}

template <int D, int kRowGroups>
__global__ void __launch_bounds__(kF32Threads) flash_fwd_f32_kernel(Params p) {
  constexpr int kSplits = kF32Warps / kRowGroups;
  constexpr int kBlockRows = 16 * kRowGroups;
  constexpr int LD = kLdF<D>;
  constexpr int KW = kBlockK / kSplits;  // keys of a tile per warp
  constexpr int kNT = KW / 8;            // 8-key accumulator tiles of S
  constexpr int kSteps = D / 8;          // 8-deep steps of Q K^T
  constexpr int kDT = D / 8;             // 8-column accumulator tiles of O
  constexpr bool kQRegs = kQInRegisters<D, kRowGroups>;
  extern __shared__ __align__(16) unsigned char smem_f32[];
  float* Ks = reinterpret_cast<float*>(smem_f32);  // [2][64][LD]
  float* Vs = Ks + 2 * kBlockK * LD;               // [2][64][LD]
  int* kseg_s = reinterpret_cast<int*>(Vs + 2 * kBlockK * LD);  // [2][64]
  float* Qs = reinterpret_cast<float*>(kseg_s + 2 * kBlockK);   // [kBlockRows][LD]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wr = warp / kSplits, ws = warp % kSplits;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  // the q-tiles in reverse: under `causal` the last q-tiles walk the most
  // k-tiles, and blockIdx.y = 0 is scheduled first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockRows;
  const bool has_seg = p.qseg != nullptr;

  const float* qp = static_cast<const float*>(p.q) + b * p.sq.b + h * p.sq.h;
  const float* kp = static_cast<const float*>(p.k) + b * p.sk.b + h * p.sk.h;
  const float* vp = static_cast<const float*>(p.v) + b * p.sv.b + h * p.sv.h;
  const int* ksp = has_seg ? p.kseg + (long long)b * p.Tk : nullptr;

  const int n_tiles = live_k_tiles(p, q0, kBlockRows);
  auto stage_kv = [&](int kb) {
    const int buf = kb & 1, k0 = kb * kBlockK;
    tdl::cp_async_tile<float, D, LD, kBlockK, kF32Threads>(Ks + buf * kBlockK * LD, kp,
                                                            p.sk.t, k0, p.Tk);
    tdl::cp_async_tile<float, D, LD, kBlockK, kF32Threads>(Vs + buf * kBlockK * LD, vp,
                                                            p.sv.t, k0, p.Tk);
    if (has_seg && threadIdx.x < kBlockK) {
      const int tk = k0 + threadIdx.x;
      tdl::cp_async_4(kseg_s + buf * kBlockK + threadIdx.x, ksp + (tk < p.Tk ? tk : 0),
                      tk < p.Tk);
    }
  };
  // Q goes to its own tile, or, where its fragments stay in registers, to
  // stage 1 of the K ring until they are read
  tdl::cp_async_tile<float, D, LD, kBlockRows, kF32Threads>(kQRegs ? Ks + kBlockK * LD : Qs, qp,
                                                            p.sq.t, q0, p.Tq);
  if (n_tiles > 0) stage_kv(0);
  tdl::cp_async_commit();

  // this lane's two query rows: g and g + 8 of the warp's 16
  const int row0 = q0 + wr * 16 + g;
  int qseg[2], qpos[2];
  float m[2], l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    qseg[i] = (has_seg && row < p.Tq) ? p.qseg[(long long)b * p.Tq + row] : 0;
    qpos[i] = p.q_offset + row;
    m[i] = kNegInf;
    l[i] = 0.f;  // this lane's share of the row sum
  }
  // this lane's Q in shared memory: element e of the A fragment of step ks
  // is Qw[8 (e & 1) LD + 8 ks + 4 (e >> 1)] (row g + 8 (e & 1), column
  // 8 ks + t + 4 (e >> 1) of the warp's 16 rows)
  const float* Qw = (kQRegs ? Ks + kBlockK * LD : Qs) + (wr * 16 + g) * LD + t;
  uint32_t qhi[kQRegs ? kSteps : 1][4], qlo[kQRegs ? kSteps : 1][4];
  float acc[kDT][4];
#pragma unroll
  for (int n = 0; n < kDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // the last row of this warp, and its first key in a tile
  const int last_qpos = p.q_offset + q0 + wr * 16 + 15;
  const int kc = ws * KW;

  tdl::cp_async_wait<0>();
  __syncthreads();
  if constexpr (kQRegs) {
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        tdl::split_tf32(Qw[8 * (e & 1) * LD + ks * 8 + 4 * (e >> 1)], qhi[ks][e], qlo[ks][e]);
    __syncthreads();  // stage 1 is the ring's again
  }
  for (int kb = 0; kb < n_tiles; ++kb) {
    // the stage written here was last read in iteration kb - 1, before the
    // barrier that ended it
    if (kb + 1 < n_tiles) stage_kv(kb + 1);
    tdl::cp_async_commit();

    const int buf = kb & 1, k0 = kb * kBlockK;
    const float* Kt = Ks + buf * kBlockK * LD + kc * LD;
    const float* Vt = Vs + buf * kBlockK * LD + kc * LD;
    const int* kseg_t = kseg_s + buf * kBlockK + kc;
    // this warp's keys of the tile: all past Tk, or (causal) all above the
    // diagonal for each of its rows, add nothing (a masked key's weight is
    // exp(-1e30 - m) = 0 once any key of the row is live, and a row with no
    // live key is rebuilt below)
    const bool idle = k0 + kc >= p.Tk || (p.causal && k0 + kc > last_qpos);
    if (!idle) {
      // S = Q K^T for this warp's 16 rows x KW keys. A warp runs its
      // instructions in order and an mma.sync's sum is ready some 30 cycles
      // later, so the three terms go to three accumulators (hi*hi, lo*hi,
      // hi*lo), and at 16 keys to two copies of each by the parity of the
      // k-step: each k-step starts 3 kNT products in 3 kNT accumulators.
      constexpr int kC = kNT == 2 ? 2 : 1;
      float shh[kC][kNT][4], slh[kC][kNT][4], shl[kC][kNT][4];
#pragma unroll
      for (int c = 0; c < kC; ++c)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) shh[c][j][e] = slh[c][j][e] = shl[c][j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        const int c = ks % kC;
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (kQRegs) {
            ah[e] = qhi[ks][e];
            al[e] = qlo[ks][e];
          } else {
            tdl::split_tf32(Qw[8 * (e & 1) * LD + ks * 8 + 4 * (e >> 1)], ah[e], al[e]);
          }
        }
        uint32_t bh[kNT][2], bl[kNT][2];
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const float* kr = Kt + (j * 8 + g) * LD + ks * 8 + t;
          tdl::split_tf32(kr[0], bh[j][0], bl[j][0]);
          tdl::split_tf32(kr[4], bh[j][1], bl[j][1]);
        }
#pragma unroll
        for (int j = 0; j < kNT; ++j) tdl::mma_tf32_1688(shh[c][j], ah, bh[j][0], bh[j][1]);
#pragma unroll
        for (int j = 0; j < kNT; ++j) tdl::mma_tf32_1688(slh[c][j], al, bh[j][0], bh[j][1]);
#pragma unroll
        for (int j = 0; j < kNT; ++j) tdl::mma_tf32_1688(shl[c][j], ah, bl[j][0], bl[j][1]);
      }
      // the small terms first, then hi*hi
      float s[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float small = 0.f, big = 0.f;
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            small += slh[c][j][e] + shl[c][j][e];
            big += shh[c][j][e];
          }
          s[j][e] = small + big;
        }

      // scale and masks; the row max over the keys before Tk
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int c = j * 8 + tdl::frag_col(lane, e);  // key k0 + kc + c
          bool live = true;
          if (p.causal) live = qpos[i] >= k0 + kc + c;
          if (has_seg) live = live && qseg[i] == kseg_t[c];
          s[j][e] = live ? s[j][e] * p.scale : kNegInf;
          if (k0 + kc + c < p.Tk) mx[i] = fmaxf(mx[i], s[j][e]);
        }
      }
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        corr[i] = exp2f((m[i] - m_new) * kLog2e);
        m[i] = m_new;
        l[i] *= corr[i];
      }
      // s becomes p = exp(s - m), 0 past Tk
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int c = j * 8 + tdl::frag_col(lane, e);
          const float pj = k0 + kc + c < p.Tk ? exp2f((s[j][e] - m[i]) * kLog2e) : 0.f;
          s[j][e] = pj;
          l[i] += pj;
        }
      }
#pragma unroll
      for (int n = 0; n < kDT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];

      // O += P V: P from registers, 8 keys per step, in the key order
      // 0, 2, 4, 6, 1, 3, 5, 7 of its accumulator tile (attention_tiles.cuh);
      // the output tiles in groups of kG, each term over the group before
      // the next, so that a tile's products are kG instructions apart
      constexpr int kG = kDT < 8 ? kDT : 8;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        uint32_t ph[4], pl[4];
        tdl::split_tf32(s[j][0], ph[0], pl[0]);
        tdl::split_tf32(s[j][2], ph[1], pl[1]);
        tdl::split_tf32(s[j][1], ph[2], pl[2]);
        tdl::split_tf32(s[j][3], ph[3], pl[3]);
        const float* vr = Vt + (j * 8 + 2 * t) * LD + g;
#pragma unroll
        for (int n0 = 0; n0 < kDT; n0 += kG) {
          uint32_t vh[kG][2], vl[kG][2];
#pragma unroll
          for (int i = 0; i < kG; ++i) {
            tdl::split_tf32(vr[(n0 + i) * 8], vh[i][0], vl[i][0]);
            tdl::split_tf32(vr[LD + (n0 + i) * 8], vh[i][1], vl[i][1]);
          }
#pragma unroll
          for (int i = 0; i < kG; ++i) tdl::mma_tf32_1688(acc[n0 + i], pl, vh[i][0], vh[i][1]);
#pragma unroll
          for (int i = 0; i < kG; ++i) tdl::mma_tf32_1688(acc[n0 + i], ph, vl[i][0], vl[i][1]);
#pragma unroll
          for (int i = 0; i < kG; ++i) tdl::mma_tf32_1688(acc[n0 + i], ph, vh[i][0], vh[i][1]);
        }
      }
    }

    // tile kb + 1 has landed, and no warp reads stage kb & 1 any more
    tdl::cp_async_wait<0>();
    __syncthreads();
  }

  // the row sums over the four lanes that share a row
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }

  // Epilogue. Each warp leaves its (m, l) and unnormalised acc in shared
  // memory (the ring, no longer read). One thread per row combines the
  // kSplits parts of its row in key order, m = max m_s, l = sum l_s e_s
  // with e_s = exp(m_s - m), writes lse = m + log l and each part's weight
  // e_s / l; then out = sum acc_s e_s / l, four columns per thread and
  // 16-byte stores. With one key group this is out = acc / l.
  float* part = reinterpret_cast<float*>(smem_f32);  // [warp][16][LD]
  float* ml = part + kF32Warps * 16 * LD;            // [warp][16][2]
  float* wts = ml + kF32Warps * 16 * 2;              // [kBlockRows][kSplits]
  float* vmean = wts + kBlockRows * kSplits;         // [D]
#pragma unroll
  for (int n = 0; n < kDT; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float2*>(part + (warp * 16 + g + 8 * i) * LD + n * 8 + 2 * t) =
          make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      ml[(warp * 16 + g + 8 * i) * 2] = m[i];
      ml[(warp * 16 + g + 8 * i) * 2 + 1] = l[i];
    }
  }
  __syncthreads();

  int dead = 0;
  if (threadIdx.x < kBlockRows) {
    const int row = threadIdx.x;
    const float* mlr = ml + ((row / 16) * kSplits * 16 + row % 16) * 2;  // part 0 of the row
    float m_tot = kNegInf, l_tot = 0.f, e[kSplits];
#pragma unroll
    for (int sp = 0; sp < kSplits; ++sp) m_tot = fmaxf(m_tot, mlr[sp * 32]);
#pragma unroll
    for (int sp = 0; sp < kSplits; ++sp) {
      e[sp] = exp2f((mlr[sp * 32] - m_tot) * kLog2e);
      l_tot += mlr[sp * 32 + 1] * e[sp];
    }
    // a row with no live key: the mean of v, with l = Tk, below
    dead = q0 + row < p.Tq && m_tot == kNegInf;
#pragma unroll
    for (int sp = 0; sp < kSplits; ++sp) wts[row * kSplits + sp] = dead ? 0.f : e[sp] / l_tot;
    if (q0 + row < p.Tq)
      p.lse[(long long)bh * p.Tq + q0 + row] = m_tot + logf(dead ? float(p.Tk) : l_tot);
  }
  const int any_dead = __syncthreads_or(dead);

  constexpr int kQuads = D / 4;
  float* op = static_cast<float*>(p.out) + (long long)bh * p.Tq * D;
#pragma unroll
  for (int idx = threadIdx.x; idx < kBlockRows * kQuads; idx += kF32Threads) {
    const int row = idx / kQuads, c4 = (idx % kQuads) * 4;
    if (q0 + row >= p.Tq) continue;
    const float* pr = part + ((row / 16) * kSplits * 16 + row % 16) * LD + c4;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int sp = 0; sp < kSplits; ++sp) {
      const float4 x = *reinterpret_cast<const float4*>(pr + sp * 16 * LD);
      const float w = wts[row * kSplits + sp];
      o.x += x.x * w;
      o.y += x.y * w;
      o.z += x.z * w;
      o.w += x.w * w;
    }
    *reinterpret_cast<float4*>(op + (long long)(q0 + row) * D + c4) = o;
  }

  // Rows with no live key: uniform softmax over the Tk original keys, the
  // mean of v (the sweep above may have skipped tiles, so it is taken anew).
  if (any_dead) {
    if (threadIdx.x < D) {
      float vsum = 0.f;
      for (int j = 0; j < p.Tk; ++j) vsum += vp[(long long)j * p.sv.t + threadIdx.x];
      vmean[threadIdx.x] = vsum / float(p.Tk);
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < kBlockRows * D; idx += kF32Threads) {
      const int row = idx / D, col = idx % D;
      const float* mlr = ml + ((row / 16) * kSplits * 16 + row % 16) * 2;
      bool live = false;
#pragma unroll
      for (int sp = 0; sp < kSplits; ++sp) live = live || mlr[sp * 32] != kNegInf;
      if (q0 + row < p.Tq && !live) op[(long long)(q0 + row) * D + col] = vmean[col];
    }
  }
}

// ------------------------------------------------------------------ launch

template <int D, int kRowGroups>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  static std::atomic<unsigned long long> attr_set{0};
  constexpr size_t smem = f32_smem_bytes<D, kRowGroups>();
  auto kernel = flash_fwd_f32_kernel<D, kRowGroups>;
  const cudaError_t err = tdl::allow_smem(kernel, smem, attr_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H, (p.Tq + 16 * kRowGroups - 1) / (16 * kRowGroups));
  kernel<<<grid, kF32Threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The number of row groups of the float32 kernel's q-tile when the launch
// names none: two (32-row q-tiles, each K/V tile read by twice as many rows)
// where that still gives every SM two blocks, else one (16-row q-tiles, each
// warp on a quarter of every k-tile: a 512-token prefill of 12 heads runs
// 384 blocks). kernels/autotune.py's static table keeps the same rule.
int f32_row_groups(const Params& p, int sms) {
  return (long long)((p.Tq + 31) / 32) * p.B * p.H >= 2 * sms ? 2 : 1;
}

template <int D, int kRows>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  static std::atomic<unsigned long long> attr_set{0}, masked_attr_set{0};
  constexpr size_t smem = bf16_smem_bytes<D, kRows>();
  const dim3 grid((p.Tq + kRows - 1) / kRows, p.B * p.H);
  const bool masked = p.causal || p.qseg != nullptr || p.Tk % kBlockK != 0;
  auto kernel = masked ? flash_fwd_bf16_kernel<D, kRows, true>
                       : flash_fwd_bf16_kernel<D, kRows, false>;
  const cudaError_t err = tdl::allow_smem(kernel, smem, masked ? masked_attr_set : attr_set);
  if (err != cudaSuccess) return err;
  constexpr int threads = kBf16Threads<kRows>;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// block_q: the q-tile's rows, or 0 for the default; a height with no
// instantiation is cudaErrorInvalidValue (the wrapper names the heights)
template <typename T, int D>
cudaError_t launch(const Params& p, int block_q, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    switch (block_q) {
      case 0:
      case kBf16DefaultRows: return launch_bf16<D, kBf16DefaultRows>(p, stream);
      case 32: return launch_bf16<D, 32>(p, stream);
      case 128: return launch_bf16<D, 128>(p, stream);
      default: return cudaErrorInvalidValue;
    }
  } else {
    if (block_q == 0) {
      int dev = 0, sms = 0;
      cudaError_t err = cudaGetDevice(&dev);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err != cudaSuccess) return err;
      block_q = 16 * f32_row_groups(p, sms);
    }
    switch (block_q) {
      case 16: return launch_f32<D, 1>(p, stream);
      case 32: return launch_f32<D, 2>(p, stream);
      default: return cudaErrorInvalidValue;
    }
  }
}

template <typename T>
cudaError_t dispatch_d(const Params& p, int D, int block_q, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(p, block_q, stream);
    case 32: return launch<T, 32>(p, block_q, stream);
    case 64: return launch<T, 64>(p, block_q, stream);
    case 128: return launch<T, 128>(p, block_q, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. block_q: the q-tile's rows (bfloat16:
// 32, 64 or 128; float32: 16 or 32), or 0 for the kernel's default.
// Returns the launch's cudaError_t (cudaErrorInvalidValue for a block_q
// with no instantiation). q, k and v must be 16-byte aligned in every row
// (the wrapper checks the pointers and the b/h/t strides).
int tdl_flash_fwd(const void* q, const void* k, const void* v, const void* qseg,
                  const void* kseg, void* out, void* lse, int B, int H, int Tq,
                  int Tk, int D, int dtype, long long q_sb, long long q_sh,
                  long long q_st, long long k_sb, long long k_sh, long long k_st,
                  long long v_sb, long long v_sh, long long v_st, int causal,
                  float scale, int q_offset, int block_q, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.qseg = static_cast<const int*>(qseg);
  p.kseg = static_cast<const int*>(kseg);
  p.out = out;
  p.lse = static_cast<float*>(lse);
  p.B = B;
  p.H = H;
  p.Tq = Tq;
  p.Tk = Tk;
  p.sq = {q_sb, q_sh, q_st};
  p.sk = {k_sb, k_sh, k_st};
  p.sv = {v_sb, v_sh, v_st};
  p.causal = causal;
  p.scale = scale;
  p.q_offset = q_offset;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_d<float>(p, D, block_q, s);
    case 1: return dispatch_d<__nv_bfloat16>(p, D, block_q, s);
    default: return cudaErrorInvalidValue;
  }
}

// Rows of the float32 kernel's q-tile for a call of this shape on the
// current device when the launch names none (f32_row_groups): 16 or 32, or
// -1 if the device cannot be queried.
int tdl_flash_fwd_f32_q_rows(int B, int H, int Tq) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  Params p{};
  p.B = B;
  p.H = H;
  p.Tq = Tq;
  return 16 * f32_row_groups(p, sms);
}

// Dynamic shared memory a block may opt in to on the current device
// (cudaDevAttrMaxSharedMemoryPerBlockOptin), or -1 if it cannot be queried.
int tdl_smem_optin_bytes() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    return -1;
  return bytes;
}

const char* tdl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
