// Flash-attention backward for Hopper (sm_90a): two kernels with a plain C
// interface.
//
// Replaces the TPU kernels of deeplearning4j_tpu/kernels/attention.py that
// `_flash_bwd` (attention.py:297) launches:
//
//   tdl_flash_bwd_dkv  <-  `_flash_bwd_dkv_kernel` (attention.py:213)
//   tdl_flash_bwd_dq   <-  `_flash_bwd_dq_kernel`  (attention.py:258)
//
// For q, dO [B,H,Tq,D], k, v [B,H,Tk,D] and the forward's float32 lse, with
// delta = rowsum(dO * O) computed before the launch (as on the TPU, where
// XLA computes it outside the kernels), both recompute per tile
//
//   P  = exp(S - lse),  S = (q k^T) * scale masked to -1e30
//        (causal: q_offset + i < j; segments: qseg[i] != kseg[j])
//   dS = P * (dO v^T - delta) * scale
//
// and accumulate dV = P^T dO, dK = dS^T q (dkv) and dQ = dS k (dq), with the
// TPU kernels' numerics: float32 products and sums from bf16 or float32
// inputs, gradients written in the inputs' dtype. Under `causal`, tile pairs
// that lie wholly above the diagonal are skipped, as `_block_live`
// (attention.py:207) does. Keys past Tk (the ragged edge of the last tile)
// and query rows past Tq are left out of every sum.
//
// Rows with no live key. The forward gives such a row the mean of v over the
// Tk keys and lse = -1e30 + log Tk, which is -1e30 in float32 (any live row
// has a finite lse). Its gradient is that of the dense reference: dQ = 0,
// nothing to dK, and dO / Tk added to dV on every key. The TPU kernels
// recompute P = exp(-1e30 - (-1e30)) = 1 there and are right only because
// their wrapper's pad shim zeroes dO of such rows; this port has no shim, so
// both kernels detect the row by lse <= -1e29: its P is 0, and the dkv
// kernel adds the sum of dO over such rows, divided by Tk, to each key's dV.
//
// Design. On the TPU the last grid axis runs in order and the dK/dV (or dQ)
// accumulators stay in VMEM scratch across it. Blocks of a CUDA grid run in
// no order, so each kernel loops inside the block instead:
//   dkv: one block owns one (batch*head, 64-key tile); K and V are staged
//        once, and the block sweeps the 64-row q-tiles with dK and dV in
//        registers;
//   dq:  one block owns one (batch*head, 64-row q-tile); Q and dO are staged
//        once, and the block sweeps the k-tiles with dQ in registers.
// Keeping two kernels, as the TPU does, means no block ever adds into
// another block's output: there are no atomics, and the gradients are the
// same bits from run to run. 256 threads form a 16 x 16 grid over the
// 64 x 64 tile: in the score phase a thread computes S and dO v^T for 4 rows
// x 4 keys (no row reduction is needed: lse is known); P and dS go through
// shared memory; in the accumulation phase a thread owns 4 rows (keys in
// dkv, queries in dq) x D/16 columns. Tiles are staged as float32 with a row
// stride of D+1 so that column reads do not collide on a bank. For D=128 that
// is 166 KB of shared memory (Q, dO, K, V, P, dS), for D=64 100 KB, both
// above the 48 KB a static allocation may take: dynamic shared memory, after
// cudaFuncSetAttribute(MaxDynamicSharedMemorySize), whose return is checked.
//
// Bound on the H100 at the BERT-base training shape (B=16, H=12, T=128,
// D=64, bf16): dkv reads q, dO, k, v (4 x 3.15 MB), lse and delta (2 x
// 98 KB) and writes dk, dv (2 x 3.15 MB): 19.07 MB, 5.7 us at 3.35 TB/s,
// against 8 T^2 D B H = 1.61 GFLOP, 1.6 us at the bf16 tensor-core peak;
// dq moves 15.93 MB (4.8 us) for 1.21 GFLOP (1.2 us). Both are bound by
// bytes. This first version runs every product as float32 FMA on the CUDA
// cores (67 TFLOP/s: ~24 us and ~18 us of products alone) and stages tiles
// with plain loads, so it is held by instruction issue, not memory;
// mma.sync/wgmma for bf16 and TMA staging are the next steps (PERF.md keeps
// the measured times beside the bound).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kGroups = 16;              // a 16 x 16 thread grid over a tile
constexpr int kPer = kBlockQ / kGroups;  // rows (and columns) per thread: 4
constexpr int kLdt = kBlockK + 1;        // row stride of the P and dS tiles
constexpr float kNegInf = -1e30f;        // finite mask, as on the TPU
constexpr float kDeadLse = -1e29f;       // lse of a row with no live key

static_assert(kBlockQ == kBlockK, "the thread grid assumes square tiles");

struct Strides {
  long long b, h, t;  // element strides; the last axis must be contiguous
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, H, Tq], contiguous
  const float* delta;  // [B, H, Tq], contiguous
  const int* qseg;     // [B, Tq] or null
  const int* kseg;     // [B, Tk] or null
  void* dq;            // [B, H, Tq, D], contiguous (dq kernel)
  void* dk;            // [B, H, Tk, D], contiguous (dkv kernel)
  void* dv;            // [B, H, Tk, D], contiguous (dkv kernel)
  int B, H, Tq, Tk;
  Strides sq, sk, sv, sdo;
  int causal;
  float scale;
  int q_offset;        // Tk - Tq: aligns causal rows to the end of the keys
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Q, dO, K, V tiles of 64 x (D+1) floats, P and dS of 64 x 65, then lse,
// delta, qseg and kseg of the current tiles.
template <int D>
constexpr size_t smem_bytes() {
  return (4 * size_t(kBlockQ) * (D + 1) + 2 * size_t(kBlockQ) * kLdt + 2 * kBlockQ) *
             sizeof(float) +
         (kBlockQ + kBlockK) * sizeof(int);
}

template <int D>
struct Smem {
  float *Qs, *dOs, *Ks, *Vs, *Ps, *dSs, *lse, *delta;
  int *qseg, *kseg;

  __device__ explicit Smem(float* base) {
    constexpr int LD = D + 1;
    Qs = base;
    dOs = Qs + kBlockQ * LD;
    Ks = dOs + kBlockQ * LD;
    Vs = Ks + kBlockK * LD;
    Ps = Vs + kBlockK * LD;
    dSs = Ps + kBlockQ * kLdt;
    lse = dSs + kBlockQ * kLdt;
    delta = lse + kBlockQ;
    qseg = reinterpret_cast<int*>(delta + kBlockQ);
    kseg = qseg + kBlockQ;
  }
};

// rows t0 .. t0+63 of a [T, D] slab (row stride stride_t) as float32; rows
// past T_len are zero
template <typename T, int D>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, long long stride_t,
                                           int t0, int T_len) {
  constexpr int LD = D + 1;
  for (int i = threadIdx.x; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int t = t0 + r;
    dst[r * LD + d] = t < T_len ? to_float(src[t * stride_t + d]) : 0.f;
  }
}

// lse, delta and qseg of the q-tile at q0; rows past Tq get lse = -1e30, so
// that they count as rows with no live key (P = 0)
template <int D>
__device__ __forceinline__ void stage_row_stats(const Smem<D>& sm, const Params& p, int b,
                                                int bh, int q0) {
  for (int i = threadIdx.x; i < kBlockQ; i += kThreads) {
    const int row = q0 + i;
    const bool in = row < p.Tq;
    sm.lse[i] = in ? p.lse[(long long)bh * p.Tq + row] : kNegInf;
    sm.delta[i] = in ? p.delta[(long long)bh * p.Tq + row] : 0.f;
    sm.qseg[i] = (in && p.qseg != nullptr) ? p.qseg[(long long)b * p.Tq + row] : 0;
  }
}

template <int D>
__device__ __forceinline__ void stage_kseg(const Smem<D>& sm, const Params& p, int b, int k0) {
  if (p.kseg == nullptr) return;
  for (int i = threadIdx.x; i < kBlockK; i += kThreads)
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(Params p) {
  constexpr int LD = D + 1;
  constexpr int CPT = D / kGroups;  // output columns per thread
  extern __shared__ float smem[];
  const Smem<D> sm(smem);

  const int tr = threadIdx.x / kGroups, tc = threadIdx.x % kGroups;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.x * kBlockK;
  const T* qp = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* kp = static_cast<const T*>(p.k) + b * p.sk.b + h * p.sk.h;
  const T* vp = static_cast<const T*>(p.v) + b * p.sv.b + h * p.sv.h;
  const T* dop = static_cast<const T*>(p.dout) + b * p.sdo.b + h * p.sdo.h;

  stage_rows<T, D>(sm.Ks, kp, p.sk.t, k0, p.Tk);
  stage_rows<T, D>(sm.Vs, vp, p.sv.t, k0, p.Tk);
  stage_kseg<D>(sm, p, b, k0);

  float dk[kPer][CPT], dv[kPer][CPT];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dk[i][c] = dv[i][c] = 0.f;

  const int num_q = (p.Tq + kBlockQ - 1) / kBlockQ;
  for (int qb = 0; qb < num_q; ++qb) {
    const int q0 = qb * kBlockQ;
    // the whole pair lies above the diagonal (the same for every thread)
    if (p.causal && p.q_offset + q0 + kBlockQ - 1 < k0) continue;
    __syncthreads();  // the previous q-tile's Q, dO, P and dS are no longer read
    stage_rows<T, D>(sm.Qs, qp, p.sq.t, q0, p.Tq);
    stage_rows<T, D>(sm.dOs, dop, p.sdo.t, q0, p.Tq);
    stage_row_stats<D>(sm, p, b, bh, q0);
    __syncthreads();
    tile_p_ds<D, true>(sm, p, q0, k0);
    __syncthreads();
    // dV += P^T dO and dK += dS^T Q: this thread's keys tr + 16 i, columns
    // tc + 16 c
    const int q_len = min(kBlockQ, p.Tq - q0);
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

  // Rows with no live key attend uniformly to all Tk keys: each adds
  // dO / Tk to every key's dV. Such rows may lie in q-tiles the causal skip
  // passed over, so the whole of lse is scanned.
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
      for (int c = 0; c < CPT; ++c) dsum[c] += to_float(dop[r * p.sdo.t + tc + kGroups * c]);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) dv[i][c] += dsum[c] / float(p.Tk);
  }

  T* dkp = static_cast<T*>(p.dk) + (long long)bh * p.Tk * D;
  T* dvp = static_cast<T*>(p.dv) + (long long)bh * p.Tk * D;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int key = k0 + tr + kGroups * i;
    if (key >= p.Tk) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const long long off = (long long)key * D + tc + kGroups * c;
      store(dkp + off, dk[i][c]);
      store(dvp + off, dv[i][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Params p) {
  constexpr int LD = D + 1;
  constexpr int CPT = D / kGroups;
  extern __shared__ float smem[];
  const Smem<D> sm(smem);

  const int tr = threadIdx.x / kGroups, tc = threadIdx.x % kGroups;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * kBlockQ;
  const T* qp = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* kp = static_cast<const T*>(p.k) + b * p.sk.b + h * p.sk.h;
  const T* vp = static_cast<const T*>(p.v) + b * p.sv.b + h * p.sv.h;
  const T* dop = static_cast<const T*>(p.dout) + b * p.sdo.b + h * p.sdo.h;

  stage_rows<T, D>(sm.Qs, qp, p.sq.t, q0, p.Tq);
  stage_rows<T, D>(sm.dOs, dop, p.sdo.t, q0, p.Tq);
  stage_row_stats<D>(sm, p, b, bh, q0);

  float dq[kPer][CPT];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dq[i][c] = 0.f;

  const int num_k = (p.Tk + kBlockK - 1) / kBlockK;
  for (int kb = 0; kb < num_k; ++kb) {
    const int k0 = kb * kBlockK;
    // this tile and every later one lie above the diagonal for all rows
    if (p.causal && p.q_offset + q0 + kBlockQ - 1 < k0) break;
    __syncthreads();  // the previous k-tile's K, V and dS are no longer read
    stage_rows<T, D>(sm.Ks, kp, p.sk.t, k0, p.Tk);
    stage_rows<T, D>(sm.Vs, vp, p.sv.t, k0, p.Tk);
    stage_kseg<D>(sm, p, b, k0);
    __syncthreads();
    tile_p_ds<D, false>(sm, p, q0, k0);
    __syncthreads();
    // dQ += dS K: this thread's rows tr + 16 i, columns tc + 16 c
    const int k_len = min(kBlockK, p.Tk - k0);
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

  T* dqp = static_cast<T*>(p.dq) + (long long)bh * p.Tq * D;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int row = q0 + tr + kGroups * i;
    if (row >= p.Tq) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      store(dqp + (long long)row * D + tc + kGroups * c, dq[i][c]);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, bool dkv, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  void (*kernel)(Params) = flash_bwd_dq_kernel<T, D>;
  if (dkv) kernel = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = dkv ? (p.Tk + kBlockK - 1) / kBlockK : (p.Tq + kBlockQ - 1) / kBlockQ;
  kernel<<<dim3(tiles, p.B * p.H), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Params& p, int D, bool dkv, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(p, dkv, stream);
    case 32: return launch<T, 32>(p, dkv, stream);
    case 64: return launch<T, 64>(p, dkv, stream);
    case 128: return launch<T, 128>(p, dkv, stream);
    default: return cudaErrorInvalidValue;
  }
}

int run(Params& p, int D, int dtype, bool dkv, long long q_sb, long long q_sh,
        long long q_st, long long k_sb, long long k_sh, long long k_st, long long v_sb,
        long long v_sh, long long v_st, long long do_sb, long long do_sh, long long do_st,
        void* stream) {
  p.sq = {q_sb, q_sh, q_st};
  p.sk = {k_sb, k_sh, k_st};
  p.sv = {v_sb, v_sh, v_st};
  p.sdo = {do_sb, do_sh, do_st};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_d<float>(p, D, dkv, s);
    case 1: return dispatch_d<__nv_bfloat16>(p, D, dkv, s);
    default: return cudaErrorInvalidValue;
  }
}

Params make_params(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, const void* qseg, const void* kseg,
                   int B, int H, int Tq, int Tk, int causal, float scale, int q_offset) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
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

// dtype: 0 = float32, 1 = bfloat16. Strides are (b, h, t) of q, k, v, dO.
// Each returns the launch's cudaError_t.
int tdl_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, const void* qseg, const void* kseg,
                      void* dk, void* dv, int B, int H, int Tq, int Tk, int D, int dtype,
                      long long q_sb, long long q_sh, long long q_st, long long k_sb,
                      long long k_sh, long long k_st, long long v_sb, long long v_sh,
                      long long v_st, long long do_sb, long long do_sh, long long do_st,
                      int causal, float scale, int q_offset, void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, qseg, kseg, B, H, Tq, Tk, causal, scale,
                         q_offset);
  p.dk = dk;
  p.dv = dv;
  return run(p, D, dtype, true, q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st, do_sb,
             do_sh, do_st, stream);
}

int tdl_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, const void* qseg, const void* kseg,
                     void* dq, int B, int H, int Tq, int Tk, int D, int dtype, long long q_sb,
                     long long q_sh, long long q_st, long long k_sb, long long k_sh,
                     long long k_st, long long v_sb, long long v_sh, long long v_st,
                     long long do_sb, long long do_sh, long long do_st, int causal,
                     float scale, int q_offset, void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, qseg, kseg, B, H, Tq, Tk, causal, scale,
                         q_offset);
  p.dq = dq;
  return run(p, D, dtype, false, q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st, do_sb,
             do_sh, do_st, stream);
}

const char* tdl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
