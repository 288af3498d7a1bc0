// Flash-attention backward, dq, for NVIDIA Hopper (sm_90a): the gradient
// of softmax(sm_scale * Q K^T, masked) V with respect to Q, over
// [B*H, T, D] tensors in f32 or bf16, with f32 math:
//   P  = exp(sm_scale * Q K^T - lse)        (rebuilt from the saved lse)
//   dS = P * (dO V^T - delta) * sm_scale    (delta = rowsum(dO * O))
//   dQ = dS K
//
// Replaces the TPU kernel `_flash_bwd_dq_kernel` in
// bigdl_tpu/ops/attention_kernel.py (launched by `flash_attention_backward`).
// `delta` is computed outside, by the caller, as the JAX package computes
// it outside its Pallas kernels.
//
// Design. One block of 128 threads per (b*h, 64-row q tile). The TPU
// kernel held a head's whole K and V in VMEM (512 KB each at T=2048 in
// bf16); a Hopper block may use 227 KB, so here the block keeps its own Q
// and dO rows (and their lse and delta) and streams 64-row K/V tiles
// through shared memory. Per tile: S and dP in registers (thread (ty, tx)
// owns rows 4*ty .. 4*ty+3 and columns tx + 8*j), dS through shared
// memory, and dQ += dS K into registers. Under causal masking the loop
// stops at the last K tile the q tile can see, and q tiles are scheduled
// last-first so that the long causal rows start early. Ragged Tq and Tk
// are masked here (no caller padding): keys >= Tk and masked pairs get
// P = 0 exactly, so a fully masked row (lse = 0 from the forward's guard)
// gives dQ = 0. Each block owns its output rows and sums in a fixed
// order, so dQ is the same bits on every run (no atomics).
//
// What bounds it. At the training shape (B*H = 64, T = 2048, D = 64,
// causal, bf16) the three products are 5.16e10 operations against 85 MB
// of traffic: the tensor cores' rate bounds it (0.052 ms at 989 TFLOP/s),
// not the memory (0.025 ms at 3.35 TB/s). This first version does the
// products as f32 FMAs on the CUDA cores out of shared memory (no tensor
// cores, no TMA, no pipelining); it aims to be right and simple, and its
// time is recorded against the bound in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;              // 16 row groups x 8 column lanes
constexpr int kRows = kBlockQ / 16;        // q rows per thread
constexpr int kCols = kBlockK / 8;         // key columns per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int DMAX>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (2 * kBlockQ * (DMAX + 1) + 2 * kBlockK * (DMAX + 1) +
          kBlockQ * (kBlockK + 1));
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dq_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const T* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              T* __restrict__ dq, int tq, int tk, int d,
                              float sm_scale, int causal, int q_offset,
                              int k_offset) {
  constexpr int QS = DMAX + 1;     // padded rows: conflict-free column reads
  constexpr int PS = kBlockK + 1;
  constexpr int OC = DMAX / 8;     // dq columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;                // [kBlockQ][QS]
  float* sdO = sQ + kBlockQ * QS;  // [kBlockQ][QS]
  float* sK = sdO + kBlockQ * QS;  // [kBlockK][QS]
  float* sV = sK + kBlockK * QS;   // [kBlockK][QS]
  float* sdS = sV + kBlockK * QS;  // [kBlockQ][PS]

  const int tid = threadIdx.x;
  const int ty = tid >> 3;
  const int tx = tid & 7;
  const int64_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const T* qb = q + bh * tq * d;
  const T* dob = dout + bh * tq * d;
  const T* kb = k + bh * tk * d;
  const T* vb = v + bh * tk * d;

  for (int idx = tid; idx < kBlockQ * DMAX; idx += kThreads) {
    const int r = idx / DMAX, c = idx % DMAX;
    float qx = 0.f, ox = 0.f;
    if (q0 + r < tq && c < d) {
      const int64_t off = (int64_t)(q0 + r) * d + c;
      qx = to_f32(qb[off]);
      ox = to_f32(dob[off]);
    }
    sQ[r * QS + c] = qx;
    sdO[r * QS + c] = ox;
  }
  float row_lse[kRows], row_delta[kRows], acc[kRows][OC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    row_lse[i] = row < tq ? lse[bh * tq + row] : 0.f;
    row_delta[i] = row < tq ? delta[bh * tq + row] : 0.f;
#pragma unroll
    for (int j = 0; j < OC; ++j) acc[i][j] = 0.f;
  }

  int n_kb = (tk + kBlockK - 1) / kBlockK;
  if (causal) {
    // key tiles wholly in this q tile's future contribute nothing
    const long long reach =
        (long long)q_offset + q0 + kBlockQ - k_offset + kBlockK - 1;
    const long long need = reach < 0 ? 0 : reach / kBlockK;
    if (need < n_kb) n_kb = (int)need;
  }

  for (int kt = 0; kt < n_kb; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile's readers are done with sK/sV/sdS
    for (int idx = tid; idx < kBlockK * DMAX; idx += kThreads) {
      const int r = idx / DMAX, c = idx % DMAX;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < tk && c < d) {
        const int64_t off = (int64_t)(k0 + r) * d + c;
        kx = to_f32(kb[off]);
        vx = to_f32(vb[off]);
      }
      sK[r * QS + c] = kx;
      sV[r * QS + c] = vx;
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this thread's 4 x 8 pairs
    float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DMAX; ++c) {
      float qv[kRows], ov[kRows], kv[kCols], vv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        qv[i] = sQ[(ty * kRows + i) * QS + c];
        ov[i] = sdO[(ty * kRows + i) * QS + c];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        kv[j] = sK[(tx + 8 * j) * QS + c];
        vv[j] = sV[(tx + 8 * j) * QS + c];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

    // dS = P * (dP - delta) * scale, P rebuilt from lse; masked pairs 0
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int gq = q_offset + q0 + ty * kRows + i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = k0 + tx + 8 * j;
        const bool masked = col >= tk || (causal && gq < k_offset + col);
        const float p =
            masked ? 0.f : expf(s[i][j] * sm_scale - row_lse[i]);
        sdS[(ty * kRows + i) * PS + tx + 8 * j] =
            p * (dp[i][j] - row_delta[i]) * sm_scale;
      }
    }
    __syncthreads();

    // dQ += dS K
#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      float dsv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) dsv[i] = sdS[(ty * kRows + i) * PS + c];
#pragma unroll
      for (int j = 0; j < OC; ++j) {
        const float kk = sK[c * QS + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(dsv[i], kk, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    if (row >= tq) continue;
    T* out = dq + (bh * tq + row) * d;
#pragma unroll
    for (int j = 0; j < OC; ++j) {
      const int col = tx + 8 * j;
      if (col < d) store(out + col, acc[i][j]);
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int bh, int tq, int tk, int d, float sm_scale,
                   int causal, int q_offset, int k_offset,
                   cudaStream_t stream) {
  auto kernel = flash_attention_bwd_dq_kernel<T, DMAX>;
  constexpr size_t smem = smem_bytes<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tq + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), tq, tk, d, sm_scale, causal, q_offset, k_offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int bh, int tq, int tk, int d, float sm_scale,
                     int causal, int q_offset, int k_offset, cudaStream_t s) {
  return d <= 64 ? launch<T, 64>(q, k, v, dout, lse, delta, dq, bh, tq, tk, d,
                                 sm_scale, causal, q_offset, k_offset, s)
                 : launch<T, 128>(q, k, v, dout, lse, delta, dq, bh, tq, tk,
                                  d, sm_scale, causal, q_offset, k_offset, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, dout and dq are [bh, tq, d], k and
// v [bh, tk, d], lse and delta [bh, tq] float32; all contiguous on one
// device. Returns the launch's cudaError_t (0 on success).
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, int bh, int tq, int tk, int d,
                                      float sm_scale, int causal,
                                      int q_offset, int k_offset, int dtype,
                                      void* stream) {
  if (bh < 1 || tq < 1 || tk < 1 || d < 1 || d > 128 ||
      (tq + kBlockQ - 1) / kBlockQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, dout, lse, delta, dq, bh, tq, tk, d,
                                sm_scale, causal, q_offset, k_offset, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, bh, tq,
                                        tk, d, sm_scale, causal, q_offset,
                                        k_offset, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_bwd_dq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
