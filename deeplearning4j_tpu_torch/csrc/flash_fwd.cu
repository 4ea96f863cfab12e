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
// Design. The TPU grid walks the k-blocks of one q-block in order and keeps
// the running max / sum / accumulator in VMEM scratch between grid steps.
// Blocks of a CUDA grid run in no order, so here one thread block owns one
// (batch*head, 64-row q-tile) and loops over the k-tiles itself; the running
// m, l and acc stay in registers for the whole sweep. The 64 x 64 tiles keep
// a block at 66 KB of shared memory for D=64 (three blocks per SM on the
// H100's 227 KB) and give 192 blocks at the BERT-base shape, more than the
// 132 SMs; larger q-tiles would leave SMs idle there. Each k-tile of K and V
// is staged in shared memory as float32 (row stride D+1 so that the column
// reads of the score loop do not collide on a bank). 128 threads form a
// 16 x 8 grid over the 64 x 64 score tile: a thread owns 4 query rows and
// 8 key columns of s, and 4 query rows and D/8 output columns of acc. The
// softmax row reductions are 8-lane shuffles inside a warp; the probability
// tile goes through shared memory to the P.V product. Both products are
// float32 FMA on the CUDA cores, which keeps float32 inputs exact and bf16
// inputs at the TPU kernel's float32 accuracy. Under `causal`, k-tiles that
// lie wholly above the diagonal for every row of the q-tile are skipped, as
// `_block_live` does on the TPU.
//
// Bound on the H100 at the BERT-base shape (B=8, H=12, T=128, D=64, bf16):
// the call must read q, k, v and write out (4 x 1.57 MB) and lse (49 KB),
// 6.34 MB, or 1.9 us at 3.35 TB/s; its two products are 0.40 GFLOP, 0.4 us at
// the bf16 tensor-core peak. So the bound is the bytes. This first version
// runs its products on the CUDA cores (67 TFLOP/s float32, about 6 us for
// the products alone) and stages tiles without asynchronous copies, so it
// is held by instruction issue, not by memory; wgmma/mma.sync and TMA are
// the next steps (PERF.md records the measured time beside the bound).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;
constexpr int kColGroups = 8;                       // threads across a score row
constexpr int kRowGroups = kThreads / kColGroups;   // 16
constexpr int kRows = kBlockQ / kRowGroups;         // query rows per thread: 4
constexpr int kCols = kBlockK / kColGroups;         // key columns per thread: 8
constexpr float kNegInf = -1e30f;                   // finite mask, as on the TPU

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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <int D>
constexpr size_t smem_bytes() {
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

template <typename T, int D>
__device__ __forceinline__ void stage_tile(float* dst, const T* src, long long stride_t,
                                           int t0, int T_len) {
  constexpr int LD = D + 1;
  for (int i = threadIdx.x; i < kBlockK * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int t = t0 + r;
    dst[r * LD + d] = t < T_len ? to_float(src[t * stride_t + d]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  constexpr int LD = D + 1;
  constexpr int LDP = kBlockK + 1;
  constexpr int DPT = D / kColGroups;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
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

  const T* qp = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* kp = static_cast<const T*>(p.k) + b * p.sk.b + h * p.sk.h;
  const T* vp = static_cast<const T*>(p.v) + b * p.sv.b + h * p.sv.h;

  for (int i = threadIdx.x; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int t = q0 + r;
    Qs[r * LD + d] = t < p.Tq ? to_float(qp[t * p.sq.t + d]) : 0.f;
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
  for (int kb = 0; kb < num_k; ++kb) {
    const int k0 = kb * kBlockK;
    // this tile and every later one lie above the diagonal for all rows
    if (p.causal && p.q_offset + q0 + kBlockQ - 1 < k0) break;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    stage_tile<T, D>(Ks, kp, p.sk.t, k0, p.Tk);
    stage_tile<T, D>(Vs, vp, p.sv.t, k0, p.Tk);
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
      stage_tile<T, D>(Vs, vp, p.sv.t, k0, p.Tk);
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

  T* op = static_cast<T*>(p.out) + (long long)bh * p.Tq * D;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + tr + kRowGroups * i;
    if (row >= p.Tq) continue;
#pragma unroll
    for (int c = 0; c < DPT; ++c)
      store(op + (long long)row * D + tc + kColGroups * c, acc[i][c] / l[i]);
    if (tc == 0) p.lse[(long long)bh * p.Tq + row] = m[i] + logf(l[i]);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Tq + kBlockQ - 1) / kBlockQ, p.B * p.H);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
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

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t.
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
