// Flash-attention backward, dq, for NVIDIA Hopper (sm_90a): the gradient
// of softmax(sm_scale * Q K^T, masked) V with respect to Q, over
// [B*H, T, D] tensors in bf16 or f32, with f32 accumulation:
//   P  = exp(sm_scale * Q K^T - lse)        (rebuilt from the saved lse)
//   dS = P * (dO V^T - delta) * sm_scale    (delta = rowsum(dO * O))
//   dQ = dS K
//
// Replaces the TPU kernel `_flash_bwd_dq_kernel` in
// bigdl_tpu/ops/attention_kernel.py (launched by `flash_attention_backward`).
// `delta` is computed outside, by the caller, as the JAX package computes
// it outside its Pallas kernels.
//
// What bounds it. At the training shape (B*H = 64, T = 2048, D = 64,
// causal, bf16) the three products are 5.16e10 operations against 85 MB
// of traffic: the tensor cores' rate bounds it (0.052 ms at 989 TFLOP/s),
// not the memory (0.025 ms at 3.35 TB/s). So the products belong on the
// tensor cores, with the operands fed from shared memory without stalls.
//
// bf16 design (the training path). One block of 4 warps per (b*h, 64-row
// q tile); warp w owns q rows 16w .. 16w+15. The block's Q and dO rows sit
// in shared memory as bf16 and are read as mma A fragments (ldmatrix);
// 64-row K and V tiles stream through a 2-stage cp.async ring, so the
// next tile's copy overlaps this tile's products. Rows are padded to
// D + 8 elements, which puts the 8 rows of every ldmatrix in 8 different
// bank groups. Per K/V tile, on the tensor cores (mma.sync m16n8k16, bf16
// in, f32 accumulate):
//   S = Q K^T and dP = dO V^T        (B fragments: K, V by ldmatrix)
//   P, dS in f32 registers, in the accumulator layout
//   dQ += dS K                       (dS repacked in registers into A
//                                     fragments; K by ldmatrix.trans)
// dQ stays in f32 registers and is written once, as bf16.
//
// Precision. q, k, v and dO are bf16 already, so S and dP are exact
// products summed in f32, as the f32 reference computes them. dS is f32:
// rounded once to bf16 it carries 2^-9 of relative error per term, and a
// sum over ~2048 keys whose signs cancel carries that error at the size of
// a typical term, 5-9 times the per-element limit that holds the kernel
// to its plain version (2^-7 |plain| + 1e-4 max|plain|). So dS is split
// into bf16 hi + bf16 lo and dQ += dS_hi K + dS_lo K: two MMAs, an error
// of about 2^-17, the size of the f32 reordering the old design had.
//
// Under causal masking the loop stops at the last K tile the q tile can
// see, and q tiles are scheduled last-first so that the long causal rows
// start early; tiles off the diagonal and the ragged edge skip the mask.
// Ragged Tq and Tk are masked here (no caller padding): keys >= Tk and
// masked pairs get P = 0 exactly, before the exp, so a fully masked row
// (lse = 0 from the forward's guard) gives dQ = 0. Head dims up to 128 are
// zero-filled to the compiled width (64 or 128); rows are copied 16 bytes
// at a time when D is a multiple of 8 and every pointer is 16-byte
// aligned, one element at a time otherwise. Each block owns its output
// rows and sums in a fixed order, so dQ is the same bits on every run (no
// atomics).
//
// f32 inputs keep the first design: f32 FMAs on the CUDA cores out of
// shared memory (thread (ty, tx) owns rows 4*ty .. 4*ty+3 and columns
// tx + 8*j, dS through shared memory). Its limit against the plain version
// is 1e-4 max|plain| with no relative part, which bf16 operands (even
// split in three) do not meet, and no main path trains in f32. The entry
// point picks the design by dtype; nothing retries the other design.
//
// Next step, not this one: wgmma (warpgroup MMAs from shared memory), TMA
// loads and warp specialisation (a producer warp feeding the ring).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 128;

// ------------------------------------------------------------- bf16 ---

template <int DMAX>
constexpr size_t tc_smem_bytes() {
  // Q, dO: [kBlockQ][DMAX + 8]; K, V: 2 stages of [kBlockK][DMAX + 8]
  return sizeof(__nv_bfloat16) * (DMAX + 8) * (2 * kBlockQ + 4 * kBlockK);
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                                 const __nv_bfloat16* __restrict__ k,
                                 const __nv_bfloat16* __restrict__ v,
                                 const __nv_bfloat16* __restrict__ dout,
                                 const float* __restrict__ lse,
                                 const float* __restrict__ delta,
                                 __nv_bfloat16* __restrict__ dq, int tq,
                                 int tk, int d, float sm_scale, int causal,
                                 int q_offset, int k_offset, int vec) {
  constexpr int LD = DMAX + 8;
  constexpr int NT = kBlockK / 8;   // S / dP column tiles of 8 keys
  constexpr int KD = DMAX / 16;     // 16-deep steps over the head dim
  constexpr int OT = DMAX / 8;      // dQ column tiles of 8
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  __nv_bfloat16* sdO = sQ + kBlockQ * LD;
  __nv_bfloat16* sK = sdO + kBlockQ * LD;  // [2][kBlockK][LD]
  __nv_bfloat16* sV = sK + 2 * kBlockK * LD;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const __nv_bfloat16* qb = q + bh * tq * d;
  const __nv_bfloat16* dob = dout + bh * tq * d;
  const __nv_bfloat16* kb = k + bh * tk * d;
  const __nv_bfloat16* vb = v + bh * tk * d;

  int n_kb = (tk + kBlockK - 1) / kBlockK;
  if (causal) {
    // key tiles wholly in this q tile's future contribute nothing; reach
    // may be negative, and C's division truncates: clamp first
    const long long reach =
        (long long)q_offset + q0 + kBlockQ - k_offset + kBlockK - 1;
    const long long need = reach < 0 ? 0 : reach / kBlockK;
    if (need < n_kb) n_kb = (int)need;
  }

  // this thread's two q rows (g and g + 8 of the warp's 16)
  int row[2];
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = q0 + warp * 16 + g + 8 * h;
    const bool in = row[h] < tq;
    lse2[h] = in ? lse[bh * tq + row[h]] * kLog2e : 0.f;
    dlt[h] = in ? delta[bh * tq + row[h]] : 0.f;
  }
  const float scale2 = sm_scale * kLog2e;

  float acc[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  load_rows<kBlockQ, DMAX, kThreads>(sQ, qb, q0, tq, d, vec);
  load_rows<kBlockQ, DMAX, kThreads>(sdO, dob, q0, tq, d, vec);
  if (n_kb > 0) {
    load_rows<kBlockK, DMAX, kThreads>(sK, kb, 0, tk, d, vec);
    load_rows<kBlockK, DMAX, kThreads>(sV, vb, 0, tk, d, vec);
  }
  cp_async_commit();

  // ldmatrix row addresses: A fragments (rows of Q / dO), B fragments of
  // K^T / V^T (rows of K / V, two 8-key tiles at once) and of K (rows of
  // K, .trans, two 8-column tiles at once)
  const int a_row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8;
  const int b_col = ((lane >> 3) & 1) * 8;
  const int bt_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int bt_col = (lane >> 4) * 8;

  for (int kt = 0; kt < n_kb; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < n_kb) {  // the next tile's copy overlaps this tile
      load_rows<kBlockK, DMAX, kThreads>(sK + (stage ^ 1) * kBlockK * LD, kb,
                               (kt + 1) * kBlockK, tk, d, vec);
      load_rows<kBlockK, DMAX, kThreads>(sV + (stage ^ 1) * kBlockK * LD, vb,
                               (kt + 1) * kBlockK, tk, d, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* tK = sK + stage * kBlockK * LD;
    const __nv_bfloat16* tV = sV + stage * kBlockK * LD;

    // S = Q K^T and dP = dO V^T, [16 x 64] per warp
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t aq[4], ao[4];
      ldmatrix_x4(aq, sQ + a_row * LD + kk * 16 + a_col);
      ldmatrix_x4(ao, sdO + a_row * LD + kk * 16 + a_col);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk[4], bv[4];
        ldmatrix_x4(bk, tK + (np * 16 + b_row) * LD + kk * 16 + b_col);
        ldmatrix_x4(bv, tV + (np * 16 + b_row) * LD + kk * 16 + b_col);
        mma_bf16_16816(s[2 * np], aq, bk[0], bk[1]);
        mma_bf16_16816(s[2 * np + 1], aq, bk[2], bk[3]);
        mma_bf16_16816(dp[2 * np], ao, bv[0], bv[1]);
        mma_bf16_16816(dp[2 * np + 1], ao, bv[2], bv[3]);
      }
    }

    // dS = P * (dP - delta) * scale into s; masked pairs P = 0 before exp
    const int k0 = kt * kBlockK;
    const bool edge =
        k0 + kBlockK > tk ||
        (causal && (long long)q_offset + q0 <
                       (long long)k_offset + k0 + kBlockK - 1);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        const bool masked =
            edge && (col >= tk ||
                     (causal && q_offset + row[h] < k_offset + col));
        const float p =
            masked ? 0.f : exp2f(fmaf(s[j][e], scale2, -lse2[h]));
        s[j][e] = p * (dp[j][e] - dlt[h]) * sm_scale;
      }

    // dQ += dS K: dS as A fragments (hi, lo), K as B through .trans
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t hi[4], lo[4];
      c_to_a_split(s[2 * kk], s[2 * kk + 1], hi, lo);
#pragma unroll
      for (int np = 0; np < OT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, tK + (kk * 16 + bt_row) * LD + np * 16 + bt_col);
        mma_bf16_16816(acc[2 * np], hi, b[0], b[1]);
        mma_bf16_16816(acc[2 * np], lo, b[0], b[1]);
        mma_bf16_16816(acc[2 * np + 1], hi, b[2], b[3]);
        mma_bf16_16816(acc[2 * np + 1], lo, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before refill
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= tq) continue;
    __nv_bfloat16* out = dq + (bh * tq + row[h]) * d;
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      const int col = j * 8 + 2 * t;
      const float x0 = acc[j][2 * h], x1 = acc[j][2 * h + 1];
      if (vec) {  // d % 8 == 0: col < d means col + 1 < d
        if (col < d)
          *reinterpret_cast<__nv_bfloat162*>(out + col) =
              __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < d) out[col] = __float2bfloat16(x0);
        if (col + 1 < d) out[col + 1] = __float2bfloat16(x1);
      }
    }
  }
}

template <int DMAX>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int bh, int tq, int tk, int d, float sm_scale,
                      int causal, int q_offset, int k_offset, int vec,
                      cudaStream_t stream) {
  auto kernel = flash_attention_bwd_dq_tc_kernel<DMAX>;
  constexpr size_t smem = tc_smem_bytes<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tq + kBlockQ - 1) / kBlockQ);
  using bf16 = __nv_bfloat16;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), tq, tk, d, sm_scale, causal, q_offset,
      k_offset, vec);
  return cudaGetLastError();
}

// -------------------------------------------------------------- f32 ---

constexpr int kRows = kBlockQ / 16;        // q rows per thread
constexpr int kCols = kBlockK / 8;         // key columns per thread

template <int DMAX>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (2 * kBlockQ * (DMAX + 1) + 2 * kBlockK * (DMAX + 1) +
          kBlockQ * (kBlockK + 1));
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dq_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ dq, int tq, int tk, int d,
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
  const float* qb = q + bh * tq * d;
  const float* dob = dout + bh * tq * d;
  const float* kb = k + bh * tk * d;
  const float* vb = v + bh * tk * d;

  for (int idx = tid; idx < kBlockQ * DMAX; idx += kThreads) {
    const int r = idx / DMAX, c = idx % DMAX;
    float qx = 0.f, ox = 0.f;
    if (q0 + r < tq && c < d) {
      const int64_t off = (int64_t)(q0 + r) * d + c;
      qx = qb[off];
      ox = dob[off];
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
        kx = kb[off];
        vx = vb[off];
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
    float* out = dq + (bh * tq + row) * d;
#pragma unroll
    for (int j = 0; j < OC; ++j) {
      const int col = tx + 8 * j;
      if (col < d) out[col] = acc[i][j];
    }
  }
}

template <int DMAX>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dq, int bh, int tq, int tk, int d,
                       float sm_scale, int causal, int q_offset,
                       int k_offset, cudaStream_t stream) {
  auto kernel = flash_attention_bwd_dq_kernel<DMAX>;
  constexpr size_t smem = smem_bytes<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tq + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), tq, tk, d, sm_scale, causal, q_offset,
      k_offset);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores). q, dout
// and dq are [bh, tq, d], k and v [bh, tk, d], lse and delta [bh, tq]
// float32; all contiguous on one device. Returns the launch's cudaError_t
// (0 on success).
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
    return (int)(d <= 64
                     ? launch_f32<64>(q, k, v, dout, lse, delta, dq, bh, tq,
                                      tk, d, sm_scale, causal, q_offset,
                                      k_offset, s)
                     : launch_f32<128>(q, k, v, dout, lse, delta, dq, bh, tq,
                                       tk, d, sm_scale, causal, q_offset,
                                       k_offset, s));
  if (dtype == 1) {
    const int vec = d % 8 == 0 && aligned16(q) && aligned16(k) &&
                    aligned16(v) && aligned16(dout) && aligned16(dq);
    return (int)(d <= 64
                     ? launch_tc<64>(q, k, v, dout, lse, delta, dq, bh, tq,
                                     tk, d, sm_scale, causal, q_offset,
                                     k_offset, vec, s)
                     : launch_tc<128>(q, k, v, dout, lse, delta, dq, bh, tq,
                                      tk, d, sm_scale, causal, q_offset,
                                      k_offset, vec, s));
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_bwd_dq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
