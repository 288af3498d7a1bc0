// Flash-attention backward, dk and dv, for NVIDIA Hopper (sm_90a): the
// gradients of softmax(sm_scale * Q K^T, masked) V with respect to K and
// V, over [B*H, T, D] tensors in bf16 or f32, with f32 accumulation:
//   P  = exp(sm_scale * Q K^T - lse)        (rebuilt from the saved lse)
//   dV = P^T dO
//   dS = P * (dO V^T - delta) * sm_scale    (delta = rowsum(dO * O))
//   dK = dS^T Q
//
// Replaces the TPU kernel `_flash_bwd_dkv_kernel` in
// bigdl_tpu/ops/attention_kernel.py (launched by `flash_attention_backward`).
//
// What bounds it. At the training shape (B*H = 64, T = 2048, D = 64,
// causal, bf16) the four products are 6.88e10 operations against 102 MB
// of traffic: the tensor cores' rate bounds it (0.070 ms at 989 TFLOP/s),
// not the memory (0.030 ms at 3.35 TB/s). So the products belong on the
// tensor cores, with the operands fed from shared memory without stalls.
//
// bf16 design (the training path), in the transposed form, so that no
// score tile goes through shared memory. One block of 4 warps per (b*h,
// 64-row k tile); warp w owns key rows 16w .. 16w+15. The block's K and V
// rows sit in shared memory as bf16 and are read as mma A fragments
// (ldmatrix); tiles of Q and dO rows (64 at D <= 64, 32 at D = 128, where
// the two [16, D] f32 accumulators take 128 registers a thread), with
// their lse and delta, stream through a 2-stage cp.async ring, so the next
// tile's copy overlaps this tile's products. Rows are padded to D + 8
// elements, which puts the 8 rows of every ldmatrix in 8 different bank
// groups. Per Q/dO tile, on the tensor cores (mma.sync m16n8k16, bf16 in,
// f32 accumulate):
//   S^T = K Q^T and dP^T = V dO^T    (B fragments: Q, dO by ldmatrix)
//   P^T = exp(S^T * scale - lse[col]) in f32 registers
//   dV += P^T dO                     (P^T repacked in registers into A
//                                     fragments; dO by ldmatrix.trans)
//   dS^T = P^T * (dP^T - delta[col]) * scale
//   dK += dS^T Q                     (the same, with Q)
// dK and dV stay in f32 registers and are written once, as bf16.
//
// Precision. q, k, v and dO are bf16 already, so S^T and dP^T are exact
// products summed in f32, as the f32 reference computes them. P and dS are
// f32: rounded once to bf16 they carry 2^-9 of relative error per term,
// and a sum over ~2048 queries whose signs cancel (dK) carries that error
// at the size of a typical term, 5-9 times the per-element limit that
// holds the kernel to its plain version (2^-7 |plain| + 1e-4 max|plain|).
// So P^T and dS^T are split into bf16 hi + bf16 lo, two MMAs each: an
// error of about 2^-17, the size of the f32 reordering the old design had.
//
// Under causal masking the q loop starts at the diagonal (the first q tile
// whose last row reaches this k tile), and k tiles are scheduled first-
// first: the first k tiles see the most q tiles; tiles below the diagonal
// and inside the ragged edge skip the mask. Ragged Tq and Tk are masked
// here (no caller padding): queries >= Tq and masked pairs get P = 0
// exactly, before the exp. Head dims up to 128 are zero-filled to the
// compiled width (64 or 128); rows are copied 16 bytes at a time when D is
// a multiple of 8 and every pointer is 16-byte aligned, one element at a
// time otherwise. Each block owns its output rows and sums in a fixed
// order, so dK and dV are the same bits on every run (no atomics); that is
// why dq is a kernel of its own.
//
// f32 inputs keep the first design: f32 FMAs on the CUDA cores out of
// shared memory (256 threads, thread (ty, tx) owns key rows 2*ty, 2*ty+1
// and query columns tx + 8*j; P^T and dS^T through shared memory). Its
// limit against the plain version is 1e-4 max|plain| with no relative
// part, which bf16 operands (even split in three) do not meet, and no main
// path trains in f32. The entry point picks the design by dtype; nothing
// retries the other design.
//
// Next step, not this one: wgmma (warpgroup MMAs from shared memory), TMA
// loads and warp specialisation (a producer warp feeding the ring).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kBlockK = 64;

// ------------------------------------------------------------- bf16 ---

constexpr int kTcThreads = 128;  // 4 warps x 16 key rows

// Q/dO rows a tile: 64, or 32 at D = 128 (the accumulators' registers)
template <int DMAX>
constexpr int kTcBlockQ = DMAX > 64 ? 32 : 64;

template <int DMAX>
constexpr size_t tc_smem_bytes() {
  // K, V: [kBlockK][DMAX + 8]; Q, dO: 2 stages of [BQ][DMAX + 8]; lse,
  // delta: 2 stages of [BQ] f32
  constexpr int BQ = kTcBlockQ<DMAX>;
  return sizeof(__nv_bfloat16) * (DMAX + 8) * (2 * kBlockK + 4 * BQ) +
         sizeof(float) * 4 * BQ;
}

template <int DMAX>
__global__ void __launch_bounds__(kTcThreads)
flash_attention_bwd_dkv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                                  const __nv_bfloat16* __restrict__ k,
                                  const __nv_bfloat16* __restrict__ v,
                                  const __nv_bfloat16* __restrict__ dout,
                                  const float* __restrict__ lse,
                                  const float* __restrict__ delta,
                                  __nv_bfloat16* __restrict__ dk,
                                  __nv_bfloat16* __restrict__ dv, int tq,
                                  int tk, int d, float sm_scale, int causal,
                                  int q_offset, int k_offset, int vec) {
  constexpr int BQ = kTcBlockQ<DMAX>;
  constexpr int LD = DMAX + 8;
  constexpr int NT = BQ / 8;        // S^T / dP^T column tiles of 8 queries
  constexpr int KD = DMAX / 16;     // 16-deep steps over the head dim
  constexpr int OT = DMAX / 8;      // dK / dV column tiles of 8
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  __nv_bfloat16* sV = sK + kBlockK * LD;
  __nv_bfloat16* sQ = sV + kBlockK * LD;   // [2][BQ][LD]
  __nv_bfloat16* sdO = sQ + 2 * BQ * LD;   // [2][BQ][LD]
  float* sLse = reinterpret_cast<float*>(sdO + 2 * BQ * LD);  // [2][BQ]
  float* sDelta = sLse + 2 * BQ;                              // [2][BQ]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t bh = blockIdx.x;
  const int k0 = blockIdx.y * kBlockK;
  const __nv_bfloat16* qb = q + bh * tq * d;
  const __nv_bfloat16* dob = dout + bh * tq * d;
  const __nv_bfloat16* kb = k + bh * tk * d;
  const __nv_bfloat16* vb = v + bh * tk * d;
  const float* lseb = lse + bh * tq;
  const float* deltab = delta + bh * tq;

  const int n_qb = (tq + BQ - 1) / BQ;
  int qt_start = 0;
  if (causal) {
    // q tiles whose last row comes before this k tile's first key see
    // none of it: start at the first one that reaches it
    const long long ahead = (long long)k_offset + k0 - q_offset;
    const long long first = ahead <= 0 ? 0 : ahead / BQ;
    qt_start = first < n_qb ? (int)first : n_qb;
  }

  // the Q/dO tile qt, with its lse and delta, into stage st
  auto load_q_tile = [&](int qt, int st) {
    const int q0 = qt * BQ;
    load_rows<BQ, DMAX, kTcThreads>(sQ + st * BQ * LD, qb, q0, tq, d, vec);
    load_rows<BQ, DMAX, kTcThreads>(sdO + st * BQ * LD, dob, q0, tq, d, vec);
    if (tid < 2 * BQ) {
      const int i = tid % BQ;
      const bool ok = q0 + i < tq;
      const float* src = tid < BQ ? lseb : deltab;
      float* dst = (tid < BQ ? sLse : sDelta) + st * BQ + i;
      cp_async_4(dst, ok ? src + q0 + i : src, ok);
    }
  };

  load_rows<kBlockK, DMAX, kTcThreads>(sK, kb, k0, tk, d, vec);
  load_rows<kBlockK, DMAX, kTcThreads>(sV, vb, k0, tk, d, vec);
  if (qt_start < n_qb) load_q_tile(qt_start, 0);
  cp_async_commit();

  // this thread's two key rows (g and g + 8 of the warp's 16)
  int krow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) krow[h] = k0 + warp * 16 + g + 8 * h;
  const float scale2 = sm_scale * kLog2e;

  float acc_k[OT][4], acc_v[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;

  // ldmatrix row addresses: A fragments (rows of K / V), B fragments of
  // Q^T / dO^T (rows of Q / dO, two 8-query tiles at once) and of Q / dO
  // (.trans, two 8-column tiles at once)
  const int a_row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8;
  const int b_col = ((lane >> 3) & 1) * 8;
  const int bt_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int bt_col = (lane >> 4) * 8;

  for (int qt = qt_start; qt < n_qb; ++qt) {
    const int stage = (qt - qt_start) & 1;
    if (qt + 1 < n_qb) load_q_tile(qt + 1, stage ^ 1);  // overlaps this
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* tQ = sQ + stage * BQ * LD;
    const __nv_bfloat16* tdO = sdO + stage * BQ * LD;
    const float* tLse = sLse + stage * BQ;
    const float* tDelta = sDelta + stage * BQ;

    // S^T = K Q^T and dP^T = V dO^T, [16 x BQ] per warp
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ak[4], av[4];
      ldmatrix_x4(ak, sK + a_row * LD + kk * 16 + a_col);
      ldmatrix_x4(av, sV + a_row * LD + kk * 16 + a_col);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bq[4], bo[4];
        ldmatrix_x4(bq, tQ + (np * 16 + b_row) * LD + kk * 16 + b_col);
        ldmatrix_x4(bo, tdO + (np * 16 + b_row) * LD + kk * 16 + b_col);
        mma_bf16_16816(st[2 * np], ak, bq[0], bq[1]);
        mma_bf16_16816(st[2 * np + 1], ak, bq[2], bq[3]);
        mma_bf16_16816(dpt[2 * np], av, bo[0], bo[1]);
        mma_bf16_16816(dpt[2 * np + 1], av, bo[2], bo[3]);
      }
    }

    // P^T into st; masked pairs P = 0 before exp
    const int q0 = qt * BQ;
    const bool edge =
        q0 + BQ > tq ||
        (causal && (long long)q_offset + q0 <
                       (long long)k_offset + k0 + kBlockK - 1);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t + (e & 1);
        const bool masked =
            edge && (q0 + c >= tq ||
                     (causal && q_offset + q0 + c < k_offset + krow[e >> 1]));
        st[j][e] = masked
                       ? 0.f
                       : exp2f(fmaf(st[j][e], scale2, -tLse[c] * kLog2e));
      }

    // dV += P^T dO: P^T as A fragments (hi, lo), dO as B through .trans
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t hi[4], lo[4];
      c_to_a_split(st[2 * kk], st[2 * kk + 1], hi, lo);
#pragma unroll
      for (int np = 0; np < OT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b,
                          tdO + (kk * 16 + bt_row) * LD + np * 16 + bt_col);
        mma_bf16_16816(acc_v[2 * np], hi, b[0], b[1]);
        mma_bf16_16816(acc_v[2 * np], lo, b[0], b[1]);
        mma_bf16_16816(acc_v[2 * np + 1], hi, b[2], b[3]);
        mma_bf16_16816(acc_v[2 * np + 1], lo, b[2], b[3]);
      }
    }

    // dS^T = P^T * (dP^T - delta[col]) * scale into dpt
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t + (e & 1);
        dpt[j][e] = st[j][e] * (dpt[j][e] - tDelta[c]) * sm_scale;
      }

    // dK += dS^T Q: dS^T as A fragments (hi, lo), Q as B through .trans
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t hi[4], lo[4];
      c_to_a_split(dpt[2 * kk], dpt[2 * kk + 1], hi, lo);
#pragma unroll
      for (int np = 0; np < OT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, tQ + (kk * 16 + bt_row) * LD + np * 16 + bt_col);
        mma_bf16_16816(acc_k[2 * np], hi, b[0], b[1]);
        mma_bf16_16816(acc_k[2 * np], lo, b[0], b[1]);
        mma_bf16_16816(acc_k[2 * np + 1], hi, b[2], b[3]);
        mma_bf16_16816(acc_k[2 * np + 1], lo, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before refill
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (krow[h] >= tk) continue;
    __nv_bfloat16* out_k = dk + (bh * tk + krow[h]) * d;
    __nv_bfloat16* out_v = dv + (bh * tk + krow[h]) * d;
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      const int col = j * 8 + 2 * t;
      if (vec) {  // d % 8 == 0: col < d means col + 1 < d
        if (col < d) {
          *reinterpret_cast<__nv_bfloat162*>(out_k + col) =
              __floats2bfloat162_rn(acc_k[j][2 * h], acc_k[j][2 * h + 1]);
          *reinterpret_cast<__nv_bfloat162*>(out_v + col) =
              __floats2bfloat162_rn(acc_v[j][2 * h], acc_v[j][2 * h + 1]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (col + e < d) {
            out_k[col + e] = __float2bfloat16(acc_k[j][2 * h + e]);
            out_v[col + e] = __float2bfloat16(acc_v[j][2 * h + e]);
          }
      }
    }
  }
}

template <int DMAX>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int bh, int tq, int tk, int d,
                      float sm_scale, int causal, int q_offset, int k_offset,
                      int vec, cudaStream_t stream) {
  auto kernel = flash_attention_bwd_dkv_tc_kernel<DMAX>;
  constexpr size_t smem = tc_smem_bytes<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tk + kBlockK - 1) / kBlockK);
  using bf16 = __nv_bfloat16;
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), tq, tk, d, sm_scale,
      causal, q_offset, k_offset, vec);
  return cudaGetLastError();
}

// -------------------------------------------------------------- f32 ---

constexpr int kBlockQ = 64;
constexpr int kThreads = 256;              // 32 row groups x 8 column lanes
constexpr int kRows = kBlockK / 32;        // key rows per thread
constexpr int kCols = kBlockQ / 8;         // query columns per thread

template <int DMAX>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (2 * kBlockK * (DMAX + 1) + 2 * kBlockQ * (DMAX + 1) +
          2 * kBlockK * (kBlockQ + 1) + 2 * kBlockQ);
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dkv_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               const float* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               float* __restrict__ dk, float* __restrict__ dv,
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
  const float* qb = q + bh * tq * d;
  const float* dob = dout + bh * tq * d;
  const float* kb = k + bh * tk * d;
  const float* vb = v + bh * tk * d;
  const float* lseb = lse + bh * tq;
  const float* deltab = delta + bh * tq;

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
        qx = qb[off];
        ox = dob[off];
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
    float* out_k = dk + (bh * tk + row) * d;
    float* out_v = dv + (bh * tk + row) * d;
#pragma unroll
    for (int j = 0; j < OC; ++j) {
      const int col = tx + 8 * j;
      if (col < d) {
        out_k[col] = acc_k[i][j];
        out_v[col] = acc_v[i][j];
      }
    }
  }
}

template <int DMAX>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int bh, int tq, int tk, int d,
                       float sm_scale, int causal, int q_offset, int k_offset,
                       cudaStream_t stream) {
  auto kernel = flash_attention_bwd_dkv_kernel<DMAX>;
  constexpr size_t smem = smem_bytes<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tk + kBlockK - 1) / kBlockK);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), tq, tk, d, sm_scale,
      causal, q_offset, k_offset);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores). q and
// dout are [bh, tq, d], k, v, dk and dv [bh, tk, d], lse and delta
// [bh, tq] float32; all contiguous on one device. Returns the launch's
// cudaError_t (0 on success).
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
    return (int)(d <= 64
                     ? launch_f32<64>(q, k, v, dout, lse, delta, dk, dv, bh,
                                      tq, tk, d, sm_scale, causal, q_offset,
                                      k_offset, s)
                     : launch_f32<128>(q, k, v, dout, lse, delta, dk, dv, bh,
                                       tq, tk, d, sm_scale, causal, q_offset,
                                       k_offset, s));
  if (dtype == 1) {
    const int vec = d % 8 == 0 && aligned16(q) && aligned16(k) &&
                    aligned16(v) && aligned16(dout) && aligned16(dk) &&
                    aligned16(dv);
    return (int)(d <= 64
                     ? launch_tc<64>(q, k, v, dout, lse, delta, dk, dv, bh,
                                     tq, tk, d, sm_scale, causal, q_offset,
                                     k_offset, vec, s)
                     : launch_tc<128>(q, k, v, dout, lse, delta, dk, dv, bh,
                                      tq, tk, d, sm_scale, causal, q_offset,
                                      k_offset, vec, s));
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_bwd_dkv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
