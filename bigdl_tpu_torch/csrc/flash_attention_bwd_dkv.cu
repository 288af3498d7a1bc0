// Flash-attention backward, dk and dv, for NVIDIA Hopper (sm_90a): the
// gradients of softmax(sm_scale * Q K^T, masked) V with respect to K and
// V, over [B*H, T, D] tensors in f32 or bf16, with f32 math:
//   P  = exp(sm_scale * Q K^T - lse)        (rebuilt from the saved lse)
//   dV = P^T dO
//   dS = P * (dO V^T - delta) * sm_scale    (delta = rowsum(dO * O))
//   dK = dS^T Q
//
// Replaces the TPU kernel `_flash_bwd_dkv_kernel` in
// bigdl_tpu/ops/attention_kernel.py (launched by `flash_attention_backward`).
//
// Design. One block of 256 threads per (b*h, 64-row k tile). The TPU
// kernel held a head's whole Q and dO in VMEM (512 KB each at T=2048 in
// bf16); a Hopper block may use 227 KB, so here the block keeps its own K
// and V rows and streams 64-row Q/dO tiles (and their lse and delta)
// through shared memory. Per tile, thread (ty, tx) computes S^T and dP^T
// for key rows 2*ty, 2*ty+1 and query columns tx + 8*j in registers,
// writes P^T and dS^T to shared memory, and accumulates dV += P^T dO and
// dK += dS^T Q for its two key rows in registers. 256 threads with two
// rows each keep the two [64, D] f32 accumulators at 2 * D / 4 registers
// a thread (64 at D = 128) without spilling. Under causal masking the q
// loop starts at the diagonal (the first q tile whose last row reaches
// this k tile), and k tiles are scheduled first-first: the first k tiles
// see the most q tiles. Ragged Tq and Tk are masked here (no caller
// padding): queries >= Tq and masked pairs get P = 0 exactly. Each block
// owns its output rows and sums in a fixed order, so dK and dV are the
// same bits on every run (no atomics); that is why dq is a kernel of its
// own.
//
// What bounds it. At the training shape (B*H = 64, T = 2048, D = 64,
// causal, bf16) the four products are 6.88e10 operations against 102 MB
// of traffic: the tensor cores' rate bounds it (0.070 ms at 989 TFLOP/s),
// not the memory (0.030 ms at 3.35 TB/s). This first version does the
// products as f32 FMAs on the CUDA cores out of shared memory (no tensor
// cores, no TMA, no pipelining); it aims to be right and simple, and its
// time is recorded against the bound in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;              // 32 row groups x 8 column lanes
constexpr int kRows = kBlockK / 32;        // key rows per thread
constexpr int kCols = kBlockQ / 8;         // query columns per thread

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
         (2 * kBlockK * (DMAX + 1) + 2 * kBlockQ * (DMAX + 1) +
          2 * kBlockK * (kBlockQ + 1) + 2 * kBlockQ);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dkv_kernel(const T* __restrict__ q,
                               const T* __restrict__ k,
                               const T* __restrict__ v,
                               const T* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               T* __restrict__ dk, T* __restrict__ dv,
                               int tq, int tk, int d, float sm_scale,
                               int causal, int q_offset, int k_offset) {
  constexpr int QS = DMAX + 1;     // padded rows: conflict-free column reads
  constexpr int PS = kBlockQ + 1;
  constexpr int OC = DMAX / 8;     // dk/dv columns per thread
  extern __shared__ float smem[];
  float* sK = smem;                  // [kBlockK][QS]
  float* sV = sK + kBlockK * QS;     // [kBlockK][QS]
  float* sQ = sV + kBlockK * QS;     // [kBlockQ][QS]
  float* sdO = sQ + kBlockQ * QS;    // [kBlockQ][QS]
  float* sPt = sdO + kBlockQ * QS;   // [kBlockK][PS]: P^T
  float* sdSt = sPt + kBlockK * PS;  // [kBlockK][PS]: dS^T
  float* sLse = sdSt + kBlockK * PS; // [kBlockQ]
  float* sDelta = sLse + kBlockQ;    // [kBlockQ]

  const int tid = threadIdx.x;
  const int ty = tid >> 3;
  const int tx = tid & 7;
  const int64_t bh = blockIdx.x;
  const int k0 = blockIdx.y * kBlockK;
  const T* qb = q + bh * tq * d;
  const T* dob = dout + bh * tq * d;
  const T* kb = k + bh * tk * d;
  const T* vb = v + bh * tk * d;
  const float* lseb = lse + bh * tq;
  const float* deltab = delta + bh * tq;

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
  float acc_k[kRows][OC], acc_v[kRows][OC];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < OC; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  const int n_qb = (tq + kBlockQ - 1) / kBlockQ;
  int qt_start = 0;
  if (causal) {
    // q tiles whose last row comes before this k tile's first key see
    // none of it: start at the first one that reaches it
    const long long ahead = (long long)k_offset + k0 - q_offset;
    const long long first = ahead <= 0 ? 0 : ahead / kBlockQ;
    qt_start = first < n_qb ? (int)first : n_qb;
  }

  for (int qt = qt_start; qt < n_qb; ++qt) {
    const int q0 = qt * kBlockQ;
    __syncthreads();  // the previous tile's readers are done with the tiles
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
    if (tid < kBlockQ) {
      const bool in = q0 + tid < tq;
      sLse[tid] = in ? lseb[q0 + tid] : 0.f;
      sDelta[tid] = in ? deltab[q0 + tid] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for this thread's 2 x 8 pairs
    float st[kRows][kCols], dpt[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DMAX; ++c) {
      float kv[kRows], vv[kRows], qv[kCols], ov[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        kv[i] = sK[(ty * kRows + i) * QS + c];
        vv[i] = sV[(ty * kRows + i) * QS + c];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        qv[j] = sQ[(tx + 8 * j) * QS + c];
        ov[j] = sdO[(tx + 8 * j) * QS + c];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
          dpt[i][j] = fmaf(vv[i], ov[j], dpt[i][j]);
        }
    }

    // P^T and dS^T = P^T * (dP^T - delta) * scale; masked pairs 0
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int gk = k_offset + k0 + ty * kRows + i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = tx + 8 * j;
        const int row = q0 + col;
        const bool masked = row >= tq || (causal && q_offset + row < gk);
        const float p =
            masked ? 0.f : expf(st[i][j] * sm_scale - sLse[col]);
        sPt[(ty * kRows + i) * PS + col] = p;
        sdSt[(ty * kRows + i) * PS + col] =
            p * (dpt[i][j] - sDelta[col]) * sm_scale;
      }
    }
    __syncthreads();

    // dV += P^T dO;  dK += dS^T Q
#pragma unroll 4
    for (int c = 0; c < kBlockQ; ++c) {
      float pv[kRows], dsv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        pv[i] = sPt[(ty * kRows + i) * PS + c];
        dsv[i] = sdSt[(ty * kRows + i) * PS + c];
      }
#pragma unroll
      for (int j = 0; j < OC; ++j) {
        const float o = sdO[c * QS + tx + 8 * j];
        const float qq = sQ[c * QS + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          acc_v[i][j] = fmaf(pv[i], o, acc_v[i][j]);
          acc_k[i][j] = fmaf(dsv[i], qq, acc_k[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = k0 + ty * kRows + i;
    if (row >= tk) continue;
    T* out_k = dk + (bh * tk + row) * d;
    T* out_v = dv + (bh * tk + row) * d;
#pragma unroll
    for (int j = 0; j < OC; ++j) {
      const int col = tx + 8 * j;
      if (col < d) {
        store(out_k + col, acc_k[i][j]);
        store(out_v + col, acc_v[i][j]);
      }
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, int bh, int tq, int tk, int d,
                   float sm_scale, int causal, int q_offset, int k_offset,
                   cudaStream_t stream) {
  auto kernel = flash_attention_bwd_dkv_kernel<T, DMAX>;
  constexpr size_t smem = smem_bytes<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tk + kBlockK - 1) / kBlockK);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), tq, tk, d, sm_scale, causal,
      q_offset, k_offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, int bh, int tq, int tk, int d,
                     float sm_scale, int causal, int q_offset, int k_offset,
                     cudaStream_t s) {
  return d <= 64
             ? launch<T, 64>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, d,
                             sm_scale, causal, q_offset, k_offset, s)
             : launch<T, 128>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk,
                              d, sm_scale, causal, q_offset, k_offset, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q and dout are [bh, tq, d], k, v, dk
// and dv [bh, tk, d], lse and delta [bh, tq] float32; all contiguous on one
// device. Returns the launch's cudaError_t (0 on success).
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int bh, int tq,
                                       int tk, int d, float sm_scale,
                                       int causal, int q_offset, int k_offset,
                                       int dtype, void* stream) {
  if (bh < 1 || tq < 1 || tk < 1 || d < 1 || d > 128 ||
      (tk + kBlockK - 1) / kBlockK > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk,
                                d, sm_scale, causal, q_offset, k_offset, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, bh,
                                        tq, tk, d, sm_scale, causal, q_offset,
                                        k_offset, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_bwd_dkv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
