// Flash-attention forward for NVIDIA Hopper (sm_90a): O and the per-row
// logsumexp of softmax(sm_scale * Q K^T, masked) V, over [B*H, T, D]
// tensors in f32 or bf16, with f32 math and an f32 logsumexp.
//
// Replaces the TPU kernel `_flash_fwd_kernel` in
// bigdl_tpu/ops/attention_kernel.py (launched by `flash_attention_forward`,
// numerics in `_kernel_block_update`). It computes the same function,
// including the two guards that keep fully masked rows at O = 0 and
// lse = 0: a row whose running max is still NEG_INF shifts by 0, and a row
// whose normaliser is 0 divides by 1.
//
// Design. One block of 128 threads per (b*h, 64-row q tile). The TPU
// kernel held all of K and V for a head in VMEM; 2048 x 64 x 4 B x 2 does
// not fit the 227 KB a Hopper block may use, so here 64-row K/V tiles
// stream through shared memory and the online softmax (running max m,
// normaliser l, accumulator acc) lives in registers. Thread (ty, tx) owns
// rows 4*ty .. 4*ty+3 of the tile and the score / output columns
// tx + 8*j, so a row's reductions are three shuffles among 8 lanes.
// Under causal masking the loop stops at the last K tile the q tile can
// see, and q tiles are scheduled last-first so that the long causal rows
// start early. Ragged Tq and Tk are masked here (no caller padding);
// head dims up to 128 are zero-padded to the compiled width (64 or 128).
//
// What bounds it. At the prefill shapes (T up to 2048, D = 64) attention
// does about T/2 multiply-adds per byte it must move, so the card's
// arithmetic rate bounds it, not its memory. This first version does the
// arithmetic as f32 FMAs on the CUDA cores out of shared memory (no
// tensor cores, no TMA, no pipelining); it aims to be right and simple,
// and its time is recorded against the bound in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;              // 16 row groups x 8 column lanes
constexpr int kRows = kBlockQ / 16;        // rows per thread
constexpr int kCols = kBlockK / 8;         // score columns per thread
constexpr float kNegInf = -1e30f;          // NEG_INF of the JAX package
constexpr float kHalfNegInf = -0.5e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
}

__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 1);
}

template <int DMAX>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBlockQ * (DMAX + 1) + kBlockK * (DMAX + 1) +
                          kBlockK * DMAX + kBlockQ * (kBlockK + 1));
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int tq, int tk, int d,
                 float sm_scale, int causal, int q_offset, int k_offset) {
  constexpr int QS = DMAX + 1;     // padded rows: conflict-free column reads
  constexpr int PS = kBlockK + 1;
  constexpr int OC = DMAX / 8;     // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;                // [kBlockQ][QS]
  float* sK = sQ + kBlockQ * QS;   // [kBlockK][QS]
  float* sV = sK + kBlockK * QS;   // [kBlockK][DMAX]
  float* sP = sV + kBlockK * DMAX; // [kBlockQ][PS]

  const int tid = threadIdx.x;
  const int ty = tid >> 3;
  const int tx = tid & 7;
  const int64_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const T* qb = q + bh * tq * d;
  const T* kb = k + bh * tk * d;
  const T* vb = v + bh * tk * d;

  for (int idx = tid; idx < kBlockQ * DMAX; idx += kThreads) {
    const int r = idx / DMAX, c = idx % DMAX;
    float x = 0.f;
    if (q0 + r < tq && c < d) x = to_f32(qb[(int64_t)(q0 + r) * d + c]);
    sQ[r * QS + c] = x;
  }

  float m[kRows], l[kRows], acc[kRows][OC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
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
    __syncthreads();  // the previous tile's readers are done with sK/sV/sP
    for (int idx = tid; idx < kBlockK * DMAX; idx += kThreads) {
      const int r = idx / DMAX, c = idx % DMAX;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < tk && c < d) {
        const int64_t off = (int64_t)(k0 + r) * d + c;
        kx = to_f32(kb[off]);
        vx = to_f32(vb[off]);
      }
      sK[r * QS + c] = kx;
      sV[r * DMAX + c] = vx;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < DMAX; ++c) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = sQ[(ty * kRows + i) * QS + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = sK[(tx + 8 * j) * QS + c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int gq = q_offset + q0 + ty * kRows + i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = k0 + tx + 8 * j;
        float x = s[i][j] * sm_scale;
        if (col >= tk || (causal && gq < k_offset + col)) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = row_max(mx);
      // fully masked so far: shift by 0 so exp(NEG_INF - shift) is 0
      const float shift = mx <= kHalfNegInf ? 0.f : mx;
      const float scale_old = m[i] <= kHalfNegInf ? 0.f : expf(m[i] - shift);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - shift);
        s[i][j] = p;
        rs += p;
      }
      l[i] = l[i] * scale_old + row_sum(rs);
      m[i] = mx;
#pragma unroll
      for (int j = 0; j < OC; ++j) acc[i][j] *= scale_old;
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        sP[(ty * kRows + i) * PS + tx + 8 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = sP[(ty * kRows + i) * PS + c];
#pragma unroll
      for (int j = 0; j < OC; ++j) {
        const float vv = sV[c * DMAX + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    if (row >= tq) continue;
    const float den = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + (bh * tq + row) * d;
#pragma unroll
    for (int j = 0; j < OC; ++j) {
      const int col = tx + 8 * j;
      if (col < d) store(orow + col, acc[i][j] / den);
    }
    if (tx == 0) {
      const float shift = m[i] <= kHalfNegInf ? 0.f : m[i];
      lse[bh * tq + row] = shift + logf(den);
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int tq, int tk, int d, float sm_scale,
                   int causal, int q_offset, int k_offset,
                   cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, DMAX>;
  constexpr size_t smem = smem_bytes<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tq + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), tq, tk, d, sm_scale, causal, q_offset,
      k_offset);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q is [bh, tq, d], k and v [bh, tk, d],
// o like q, lse [bh, tq] float32; all contiguous on one device.
// Returns the launch's cudaError_t (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int bh,
                                   int tq, int tk, int d, float sm_scale,
                                   int causal, int q_offset, int k_offset,
                                   int dtype, void* stream) {
  if (bh < 1 || tq < 1 || tk < 1 || d < 1 || d > 128 ||
      (tq + kBlockQ - 1) / kBlockQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)(d <= 64 ? launch<float, 64>(q, k, v, o, lse, bh, tq, tk, d,
                                             sm_scale, causal, q_offset,
                                             k_offset, s)
                         : launch<float, 128>(q, k, v, o, lse, bh, tq, tk, d,
                                              sm_scale, causal, q_offset,
                                              k_offset, s));
  }
  if (dtype == 1) {
    return (int)(d <= 64
                     ? launch<__nv_bfloat16, 64>(q, k, v, o, lse, bh, tq, tk,
                                                 d, sm_scale, causal,
                                                 q_offset, k_offset, s)
                     : launch<__nv_bfloat16, 128>(q, k, v, o, lse, bh, tq, tk,
                                                  d, sm_scale, causal,
                                                  q_offset, k_offset, s));
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
