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
// Blocks of a CUDA grid run in no order, so here one thread block of 128
// threads owns one (batch*head, 64-row q-tile) and loops over the 64-key
// tiles itself; m, l and acc stay in registers for the whole sweep. At the
// BERT-base shape (B=8, H=12, T=128) that is 192 blocks on the H100's 132
// SMs, all resident at once. The bf16 kernel's tile height was measured,
// not carried over (chip_smoke.py builds it with 32 and 128 rows too): 128
// rows tie with 64 at the serving shape and lose at the training shape (192
// blocks of 8 warps) and at a 512-token causal prefill (48 blocks); 32 rows
// lose everywhere (K and V read twice as often). Under `causal`, k-tiles
// that lie wholly above the diagonal for every row of the q-tile are
// skipped, as `_block_live` does on the TPU.
//
// Two kernels share that grid.
//
// bfloat16 inputs: flash_fwd_bf16_kernel, on the tensor cores. Each of the
// four warps owns 16 query rows. A call with no causal mask, no segment ids
// and Tk a multiple of 64 takes an instantiation without mask tests.
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
// Shared memory: Q and two stages of K and V, 5 x 64 x (D+8) bf16, plus the
// key segment ids: 46.6 KB at D=64, 87.6 KB at D=128.
//
// float32 inputs: flash_fwd_fma_kernel, exact float32 FMA on the CUDA cores
// (the first version of this kernel, kept for float32: the token identity
// of generation and the float32 train-step check depend on it). 128 threads
// form a 16 x 8 grid over the 64 x 64 score tile: a thread owns 4 query rows
// and 8 key columns of s, and 4 query rows and D/8 output columns of acc.
// Tiles are staged as float32 with row stride D+1; the probability tile goes
// through shared memory to the P V product.
//
// Bound on the H100 at the BERT-base shape (B=8, H=12, T=128, D=64, bf16):
// the call must read q, k, v and write out (4 x 1.57 MB) and lse (49 KB),
// 6.34 MB, or 1.9 us at 3.35 TB/s; its two products are 0.40 GFLOP, 0.4 us at
// the bf16 tensor-core peak (three products with the split of P: 0.6 us). So
// the bound is the bytes, and mma.sync tiles suffice: wgmma and TMA pay off
// where the tensor-core rate becomes the limit (long prefill), not here.
// PERF.md records the measured times beside the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

#include "attention_tiles.cuh"

namespace {

constexpr int kBlockK = 64;    // keys per k-tile, both kernels
constexpr int kBlockQ = 64;    // query rows per block of the float32 kernel
constexpr int kThreads = 128;  // threads per block of the float32 kernel
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

// Query rows of a block: 64, four warps of 16 rows. Building with
// -DTDL_FWD_BLOCK_Q=32 or 128 gives two or eight warps instead; chip_smoke.py
// times those builds to show that 64 rows is the right tile on the H100.
#ifndef TDL_FWD_BLOCK_Q
#define TDL_FWD_BLOCK_Q 64
#endif
constexpr int kBf16BlockQ = TDL_FWD_BLOCK_Q;
constexpr int kBf16Threads = 2 * kBf16BlockQ;  // one warp per 16 query rows
static_assert(kBf16BlockQ % 16 == 0 && kBf16Threads >= kBlockK, "q-tile of whole warps");
constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = exp2(x log2 e)

// row stride, in elements, of a bf16 tile in shared memory
template <int D>
constexpr int kLd = D + 8;

template <int D>
constexpr size_t bf16_smem_bytes() {
  return size_t(kBf16BlockQ + 4 * kBlockK) * kLd<D> * sizeof(__nv_bfloat16) +
         2 * kBlockK * sizeof(int);
}

// rows [t0, t0 + kRows) of a [T, D] bf16 slab with row stride `stride_t` into
// a kRows x (D+8) tile, 16 bytes per copy; rows at or past T are zero-filled.
template <int D, int kRows>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* tile, const __nv_bfloat16* src,
                                           long long stride_t, int t0, int T) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < kRows * kChunks; c += kBf16Threads) {
    const int r = c / kChunks, ch = c % kChunks;
    const int t = t0 + r;
    const bool valid = t < T;
    tdl::cp_async_16(tile + r * kLd<D> + ch * 8,
                     src + (valid ? t : 0) * stride_t + ch * 8, valid);
  }
}

// kMasked: the call has a causal mask, segment ids, or a ragged last k-tile
// (Tk not a multiple of 64). The unmasked instantiation drops every mask
// test from the softmax, the main path's case (BERT-base serving and
// training at T=128).
template <int D, bool kMasked>
__global__ void __launch_bounds__(kBf16Threads) flash_fwd_bf16_kernel(Params p) {
  constexpr int LD = kLd<D>;
  constexpr int kSteps = D / 16;       // 16-deep steps of Q K^T
  constexpr int kNT = kBlockK / 8;     // 8-key accumulator tiles of S
  constexpr int kDT = D / 8;           // 8-column accumulator tiles of O
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_bf16);
  __nv_bfloat16* Ks = Qs + kBf16BlockQ * LD;   // [2][64][LD]
  __nv_bfloat16* Vs = Ks + 2 * kBlockK * LD;   // [2][64][LD]
  int* kseg_s = reinterpret_cast<int*>(Vs + 2 * kBlockK * LD);  // [2][64]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * kBf16BlockQ;
  const bool has_seg = p.qseg != nullptr;

  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(p.q) + b * p.sq.b + h * p.sq.h;
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(p.k) + b * p.sk.b + h * p.sk.h;
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(p.v) + b * p.sv.b + h * p.sv.h;
  const int* ksp = has_seg ? p.kseg + (long long)b * p.Tk : nullptr;

  const int n_tiles = live_k_tiles(p, q0, kBf16BlockQ);
  auto stage_kv = [&](int kb) {
    const int buf = kb & 1, k0 = kb * kBlockK;
    stage_bf16<D, kBlockK>(Ks + buf * kBlockK * LD, kp, p.sk.t, k0, p.Tk);
    stage_bf16<D, kBlockK>(Vs + buf * kBlockK * LD, vp, p.sv.t, k0, p.Tk);
    if (has_seg && threadIdx.x < kBlockK) {
      const int t = k0 + threadIdx.x;
      tdl::cp_async_4(kseg_s + buf * kBlockK + threadIdx.x, ksp + (t < p.Tk ? t : 0),
                      t < p.Tk);
    }
  };

  stage_bf16<D, kBf16BlockQ>(Qs, qp, p.sq.t, q0, p.Tq);
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
    for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
      for (int j = 0; j < kNT; j += 2) {
        uint32_t kf[4];
        tdl::ldmatrix_x4(kf, Kt + tdl::bt_ldsm_offset(lane, LD, j * 8, ks * 16));
        tdl::mma_bf16_16816(s[j], qf[ks], kf[0], kf[1]);
        tdl::mma_bf16_16816(s[j + 1], qf[ks], kf[2], kf[3]);
      }
    }

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
      tdl::split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      tdl::split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      tdl::split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      tdl::split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int n = 0; n < kDT; n += 2) {
        uint32_t vf[4];
        tdl::ldmatrix_x4_trans(vf, Vt + tdl::b_ldsm_trans_offset(lane, LD, kk * 16, n * 8));
        tdl::mma_bf16_16816(acc[n], ph, vf[0], vf[1]);
        tdl::mma_bf16_16816(acc[n], pl, vf[0], vf[1]);
        tdl::mma_bf16_16816(acc[n + 1], ph, vf[2], vf[3]);
        tdl::mma_bf16_16816(acc[n + 1], pl, vf[2], vf[3]);
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
      stage_bf16<D, kBlockK>(Vs, vp, p.sv.t, kb * kBlockK, p.Tk);
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

// --------------------------------------------------- float32: CUDA cores

constexpr int kColGroups = 8;                       // threads across a score row
constexpr int kRowGroups = kThreads / kColGroups;   // 16
constexpr int kRows = kBlockQ / kRowGroups;         // query rows per thread: 4
constexpr int kCols = kBlockK / kColGroups;         // key columns per thread: 8

template <int D>
constexpr size_t fma_smem_bytes() {
  return (size_t(kBlockQ) * (D + 1) + 2 * size_t(kBlockK) * (D + 1) +
          size_t(kBlockQ) * (kBlockK + 1)) * sizeof(float) +
         kBlockK * sizeof(int);
}

// Sum over the 8 lanes that share a score row (consecutive lanes).
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  return x;
}

__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  return x;
}

template <int D>
__device__ __forceinline__ void stage_f32(float* dst, const float* src, long long stride_t,
                                          int t0, int T_len) {
  constexpr int LD = D + 1;
  for (int i = threadIdx.x; i < kBlockK * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int t = t0 + r;
    dst[r * LD + d] = t < T_len ? src[t * stride_t + d] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_fma_kernel(Params p) {
  constexpr int LD = D + 1;
  constexpr int LDP = kBlockK + 1;
  constexpr int DPT = D / kColGroups;  // output columns per thread
  extern __shared__ float smem_f32[];
  float* Qs = smem_f32;
  float* Ks = Qs + kBlockQ * LD;
  float* Vs = Ks + kBlockK * LD;
  float* Ps = Vs + kBlockK * LD;
  int* kseg_s = reinterpret_cast<int*>(Ps + kBlockQ * LDP);

  const int tr = threadIdx.x / kColGroups;
  const int tc = threadIdx.x % kColGroups;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * kBlockQ;
  const bool has_seg = p.qseg != nullptr;

  const float* qp = static_cast<const float*>(p.q) + b * p.sq.b + h * p.sq.h;
  const float* kp = static_cast<const float*>(p.k) + b * p.sk.b + h * p.sk.h;
  const float* vp = static_cast<const float*>(p.v) + b * p.sv.b + h * p.sv.h;

  for (int i = threadIdx.x; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int t = q0 + r;
    Qs[r * LD + d] = t < p.Tq ? qp[t * p.sq.t + d] : 0.f;
  }

  int qseg[kRows];
  float m[kRows], l[kRows], acc[kRows][DPT];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + tr + kRowGroups * i;
    qseg[i] = (has_seg && row < p.Tq) ? p.qseg[(long long)b * p.Tq + row] : 0;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }

  const int num_k = (p.Tk + kBlockK - 1) / kBlockK;
  const int n_tiles = live_k_tiles(p, q0, kBlockQ);
  for (int kb = 0; kb < n_tiles; ++kb) {
    const int k0 = kb * kBlockK;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    stage_f32<D>(Ks, kp, p.sk.t, k0, p.Tk);
    stage_f32<D>(Vs, vp, p.sv.t, k0, p.Tk);
    if (has_seg) {
      for (int i = threadIdx.x; i < kBlockK; i += kThreads)
        kseg_s[i] = k0 + i < p.Tk ? p.kseg[(long long)b * p.Tk + k0 + i] : -1;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[(tr + kRowGroups * i) * LD + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = Ks[(tc + kColGroups * j) * LD + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = tr + kRowGroups * i;
      const int qpos = p.q_offset + q0 + r;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tc + kColGroups * j;
        bool live = true;
        if (p.causal) live = qpos >= k0 + c;
        if (has_seg) live = live && qseg[i] == kseg_s[c];
        s[i][j] = live ? s[i][j] * p.scale : kNegInf;
        if (k0 + c < p.Tk) mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = tc + kColGroups * j;
        const float pj = k0 + c < p.Tk ? expf(s[i][j] - m_new) : 0.f;
        Ps[r * LDP + c] = pj;
        psum += pj;
      }
      l[i] = l[i] * corr + row_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] *= corr;
    }
    // a score row is written and read by the 8 lanes of one warp
    __syncwarp();

    const int k_len = min(kBlockK, p.Tk - k0);
    for (int j = 0; j < k_len; ++j) {
      float pv[kRows], vv[DPT];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = Ps[(tr + kRowGroups * i) * LDP + j];
#pragma unroll
      for (int c = 0; c < DPT; ++c) vv[c] = Vs[j * LD + tc + kColGroups * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  // Rows with no live key: uniform softmax over the Tk original keys. The
  // sweep above may have skipped tiles, so the mean of v is taken anew.
  bool dead[kRows];
  int any_dead = 0;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    dead[i] = q0 + tr + kRowGroups * i < p.Tq && m[i] == kNegInf;
    any_dead |= dead[i];
  }
  if (__syncthreads_or(any_dead)) {
    float vsum[DPT];
#pragma unroll
    for (int c = 0; c < DPT; ++c) vsum[c] = 0.f;
    for (int kb = 0; kb < num_k; ++kb) {
      const int k0 = kb * kBlockK;
      __syncthreads();
      stage_f32<D>(Vs, vp, p.sv.t, k0, p.Tk);
      __syncthreads();
      const int k_len = min(kBlockK, p.Tk - k0);
      for (int j = 0; j < k_len; ++j)
#pragma unroll
        for (int c = 0; c < DPT; ++c) vsum[c] += Vs[j * LD + tc + kColGroups * c];
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (!dead[i]) continue;
      l[i] = float(p.Tk);
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] = vsum[c];
    }
  }

  float* op = static_cast<float*>(p.out) + (long long)bh * p.Tq * D;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + tr + kRowGroups * i;
    if (row >= p.Tq) continue;
#pragma unroll
    for (int c = 0; c < DPT; ++c) op[(long long)row * D + tc + kColGroups * c] = acc[i][c] / l[i];
    if (tc == 0) p.lse[(long long)bh * p.Tq + row] = m[i] + logf(l[i]);
  }
}

// ------------------------------------------------------------------ launch

// cudaFuncSetAttribute(MaxDynamicSharedMemorySize) once per kernel and
// device (the attribute belongs to the device's context), not per launch.
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

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  static std::atomic<unsigned long long> attr_set{0};
  if constexpr (sizeof(T) == 2) {
    static std::atomic<unsigned long long> masked_attr_set{0};
    constexpr size_t smem = bf16_smem_bytes<D>();
    const dim3 grid((p.Tq + kBf16BlockQ - 1) / kBf16BlockQ, p.B * p.H);
    const bool masked = p.causal || p.qseg != nullptr || p.Tk % kBlockK != 0;
    auto kernel = masked ? flash_fwd_bf16_kernel<D, true> : flash_fwd_bf16_kernel<D, false>;
    const cudaError_t err = allow_smem(kernel, smem, masked ? masked_attr_set : attr_set);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kBf16Threads, smem, stream>>>(p);
  } else {
    constexpr size_t smem = fma_smem_bytes<D>();
    const cudaError_t err = allow_smem(flash_fwd_fma_kernel<D>, smem, attr_set);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.Tq + kBlockQ - 1) / kBlockQ, p.B * p.H);
    flash_fwd_fma_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Params& p, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t. For
// bfloat16, q, k and v must be 16-byte aligned in every row (the wrapper
// checks the pointers and the b/h/t strides).
int tdl_flash_fwd(const void* q, const void* k, const void* v, const void* qseg,
                  const void* kseg, void* out, void* lse, int B, int H, int Tq,
                  int Tk, int D, int dtype, long long q_sb, long long q_sh,
                  long long q_st, long long k_sb, long long k_sh, long long k_st,
                  long long v_sb, long long v_sh, long long v_st, int causal,
                  float scale, int q_offset, void* stream) {
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
    case 0: return dispatch_d<float>(p, D, s);
    case 1: return dispatch_d<__nv_bfloat16>(p, D, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* tdl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
