// The flash-attention tile loop of the f32 design, shared by the dense
// forward (flash_attention_fwd.cu, kernel 1) and the ring hop
// (flash_attention_carry.cu, kernel 2) for f32 inputs: one online-softmax
// update of a 64-row q tile's (acc, m, l) with every 64-row K/V tile it can
// see, as f32 FMAs on the CUDA cores. Both kernels' bf16 inputs run the
// tensor-core loop of flash_attention_tc_tile.cuh instead; f32 has no
// relative limit against the plain version, which bf16 operands (or TF32)
// do not meet.
//
// This is the port's form of the JAX package's rule that the dense and
// carry kernels share one block update (`_kernel_block_update` in
// bigdl_tpu/ops/attention_kernel.py): both kernels run `flash_tile` below,
// and differ only in where (acc, m, l) start and where they go.
//   kCarry = false: fresh (acc = 0, m = NEG_INF, l = 0); O = acc / l (l = 0
//                   divides by 1) and the logsumexp are written.
//   kCarry = true:  the carried f32 (acc, m, l) are loaded; the
//                   unnormalised (acc, m, l) are written back, no O and no
//                   logsumexp. The outputs may alias the inputs: a block
//                   owns its rows, and every load of them precedes a
//                   barrier that precedes every store.
//
// Layout. One block of 128 threads per (b*h, 64-row q tile). 64-row K/V
// tiles stream through shared memory; the online softmax lives in
// registers. Thread (ty, tx) owns rows ty * kRows + i of the tile and the
// score / output columns tx + 8 * j, so a row's reductions are three
// shuffles among 8 lanes; the carry is loaded and stored with that same
// map. Under causal masking the loop stops at the last K tile the q tile
// can see (no tile at all when the K/V lies wholly in the queries'
// future: the carry then passes through bit for bit), and q tiles are
// scheduled last-first so that the long causal rows start early. Ragged
// Tq and Tk are masked here (no caller padding); head dims up to 128 are
// zero-padded to the compiled width DMAX (64 or 128).
//
// Included by exactly one translation unit of each kernel library, hence
// the anonymous namespace.

#pragma once

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

// The arguments of both designs' tile loops (T: float here, bf16 in
// flash_attention_tc_tile.cuh). q is [bh, tq, d], k and v [bh, tk, d] in
// T; acc [bh, tq, d], m, l and lse [bh, tq] in f32; o like q. All
// contiguous. Offsets are the global positions of the first query and key
// (causal mask only).
template <typename T>
struct TileArgs {
  const T* q;
  const T* k;
  const T* v;
  T* o;                  // kCarry = false
  float* lse;            // kCarry = false
  const float* acc_in;   // kCarry = true (no __restrict__: may alias out)
  const float* m_in;
  const float* l_in;
  float* acc_out;
  float* m_out;
  float* l_out;
  int tq, tk, d;
  float sm_scale;
  int causal, q_offset, k_offset;
};

template <int DMAX, bool kCarry>
__device__ __forceinline__ void flash_tile(const TileArgs<float>& a) {
  constexpr int QS = DMAX + 1;     // padded rows: conflict-free column reads
  constexpr int PS = kBlockK + 1;
  constexpr int OC = DMAX / 8;     // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;                // [kBlockQ][QS]
  float* sK = sQ + kBlockQ * QS;   // [kBlockK][QS]
  float* sV = sK + kBlockK * QS;   // [kBlockK][DMAX]
  float* sP = sV + kBlockK * DMAX; // [kBlockQ][PS]

  const int tq = a.tq, tk = a.tk, d = a.d;
  const float sm_scale = a.sm_scale;
  const int causal = a.causal, q_offset = a.q_offset, k_offset = a.k_offset;
  const int tid = threadIdx.x;
  const int ty = tid >> 3;
  const int tx = tid & 7;
  const int64_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const float* __restrict__ qb = a.q + bh * tq * d;
  const float* __restrict__ kb = a.k + bh * tk * d;
  const float* __restrict__ vb = a.v + bh * tk * d;

  for (int idx = tid; idx < kBlockQ * DMAX; idx += kThreads) {
    const int r = idx / DMAX, c = idx % DMAX;
    float x = 0.f;
    if (q0 + r < tq && c < d) x = qb[(int64_t)(q0 + r) * d + c];
    sQ[r * QS + c] = x;
  }

  float m[kRows], l[kRows], acc[kRows][OC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    if (kCarry && row < tq) {
      const int64_t r = bh * tq + row;
      m[i] = a.m_in[r];
      l[i] = a.l_in[r];
#pragma unroll
      for (int j = 0; j < OC; ++j) {
        const int col = tx + 8 * j;
        acc[i][j] = col < d ? a.acc_in[r * d + col] : 0.f;
      }
    } else {
      m[i] = kNegInf;
      l[i] = 0.f;
#pragma unroll
      for (int j = 0; j < OC; ++j) acc[i][j] = 0.f;
    }
  }
  // the carry's outputs may alias its inputs: all loads before any store
  if (kCarry) __syncthreads();

  int n_kb = (tk + kBlockK - 1) / kBlockK;
  if (causal) {
    // key tiles wholly in this q tile's future contribute nothing. reach
    // may be negative (K/V wholly in the future); C's division truncates
    // toward zero where Python floors, so clamp before dividing
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
        kx = kb[off];
        vx = vb[off];
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
      // fully masked so far: shift by 0 so exp(NEG_INF - shift) is 0, and
      // a carried m still at NEG_INF scales the old (empty) sums by 0
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
    const int64_t r = bh * tq + row;
    if (kCarry) {
#pragma unroll
      for (int j = 0; j < OC; ++j) {
        const int col = tx + 8 * j;
        if (col < d) a.acc_out[r * d + col] = acc[i][j];
      }
      if (tx == 0) {
        a.m_out[r] = m[i];
        a.l_out[r] = l[i];
      }
    } else {
      const float den = l[i] == 0.f ? 1.f : l[i];
      float* orow = a.o + r * d;
#pragma unroll
      for (int j = 0; j < OC; ++j) {
        const int col = tx + 8 * j;
        if (col < d) orow[col] = acc[i][j] / den;
      }
      if (tx == 0) {
        const float shift = m[i] <= kHalfNegInf ? 0.f : m[i];
        a.lse[r] = shift + logf(den);
      }
    }
  }
}

// The shapes every flash tile kernel takes: the grid's y dimension holds
// the q tiles.
inline bool tile_shape_ok(int bh, int tq, int tk, int d) {
  return bh >= 1 && tq >= 1 && tk >= 1 && d >= 1 && d <= 128 &&
         (tq + kBlockQ - 1) / kBlockQ <= 65535;
}

// Launch `kernel` (a __global__ wrapper of flash_tile<DMAX, ...>) over
// the (bh, q tile) grid with its dynamic shared memory.
template <int DMAX>
cudaError_t launch_tile(void (*kernel)(const TileArgs<float>),
                        const TileArgs<float>& a, int bh, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (a.tq + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
