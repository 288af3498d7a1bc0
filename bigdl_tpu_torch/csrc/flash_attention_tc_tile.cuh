// The bf16 flash-attention tile loop on Hopper's tensor cores, shared by
// the dense forward (flash_attention_fwd.cu, kernel 1) and the ring hop
// (flash_attention_carry.cu, kernel 2): one online-softmax update of a
// 64-row q tile's (acc, m, l) with every 64-row K/V tile it can see. It is
// the bf16 counterpart of `flash_tile` (flash_attention_tile.cuh, the f32
// design of both kernels) and, like it, the port's form of the JAX
// package's rule that the dense and carry kernels share one block update
// (`_kernel_block_update` in bigdl_tpu/ops/attention_kernel.py):
//   kCarry = false: fresh (acc = 0, m = NEG_INF, l = 0); O = acc / l (l = 0
//                   divides by 1) in bf16 and the f32 logsumexp are written.
//   kCarry = true:  the carried f32 (acc, m, l) are loaded in the
//                   accumulator layout below; the unnormalised (acc, m, l)
//                   are stored with the same map, no O and no logsumexp.
//                   A block owns its rows and every load of them precedes
//                   a barrier of the K/V loop that precedes every store,
//                   so the outputs may alias the inputs (the ring updates
//                   its carry in place). The carry holds m in natural-log
//                   units, the loop in log2 units: m is converted on load
//                   and on store, except NEG_INF, which stays exact.
//
// Layout. One block of 4 warps per (b*h, 64-row q tile); warp w owns q
// rows 16w .. 16w+15. The block's Q rows sit in shared memory as bf16 and
// are read as mma A fragments by ldmatrix on every K tile (held in
// registers they would cost 4 * D / 8 more a thread); 64-row K and V tiles
// stream through a 2-stage cp.async ring, so the next tile's copy overlaps
// this tile's products. Rows are padded to D + 8 elements, which puts the
// 8 rows of every ldmatrix in 8 different bank groups. Per K/V tile, on
// the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate):
//   S = Q K^T                        (B fragments: K by ldmatrix)
//   online softmax of S in f32 registers, in the accumulator layout: a
//   row's 64 scores live in the 4 lanes of a quad, so a row's max and sum
//   are two shuffles (xor 1, 2)
//   acc += P V                       (P repacked in registers into A
//                                     fragments, split into bf16 hi + lo;
//                                     V by ldmatrix.trans)
// acc stays in f32 registers: thread (g, t) = (lane / 4, lane % 4) of warp
// w holds rows 16w + g and 16w + g + 8, columns 8j + 2t and 8j + 2t + 1.
//
// Under causal masking the loop stops at the last K tile the q tile can
// see (no tile at all when the K/V lies wholly in the queries' future:
// the carry then passes through bit for bit), and q tiles are scheduled
// last-first so that the long causal rows start early; tiles off the
// diagonal and the ragged edge skip the mask. Ragged Tq and Tk are masked
// here (no caller padding). Head dims up to 128 are zero-filled to the
// compiled width (64 or 128); rows are copied 16 bytes at a time when
// `vec` (D a multiple of 8 and every pointer 16-byte aligned), one element
// at a time otherwise. Each block owns its rows and sums in a fixed order,
// so the results are the same bits on every run (no atomics).
//
// Included by exactly one translation unit of each kernel library, hence
// the anonymous namespace.

#pragma once

#include "flash_attention_tile.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr float kLn2 = 0.6931471805599453f;

template <int DMAX>
constexpr size_t tc_smem_bytes() {
  // Q: [kBlockQ][DMAX + 8]; K, V: 2 stages of [kBlockK][DMAX + 8]
  return sizeof(__nv_bfloat16) * (DMAX + 8) * (kBlockQ + 4 * kBlockK);
}

// max and sum over the 4 lanes of a quad (one row of the accumulator)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int DMAX, bool kCarry>
__device__ __forceinline__ void flash_tc_tile(
    const TileArgs<__nv_bfloat16>& a, int vec) {
  constexpr int LD = DMAX + 8;
  constexpr int NT = kBlockK / 8;   // S column tiles of 8 keys
  constexpr int KD = DMAX / 16;     // 16-deep steps over the head dim
  constexpr int OT = DMAX / 8;      // O column tiles of 8
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  __nv_bfloat16* sK = sQ + kBlockQ * LD;  // [2][kBlockK][LD]
  __nv_bfloat16* sV = sK + 2 * kBlockK * LD;

  const int tq = a.tq, tk = a.tk, d = a.d;
  const float sm_scale = a.sm_scale;
  const int causal = a.causal, q_offset = a.q_offset, k_offset = a.k_offset;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const __nv_bfloat16* qb = a.q + bh * tq * d;
  const __nv_bfloat16* kb = a.k + bh * tk * d;
  const __nv_bfloat16* vb = a.v + bh * tk * d;

  int n_kb = (tk + kBlockK - 1) / kBlockK;
  if (causal) {
    // key tiles wholly in this q tile's future contribute nothing; reach
    // may be negative, and C's division truncates: clamp first
    const long long reach =
        (long long)q_offset + q0 + kBlockQ - k_offset + kBlockK - 1;
    const long long need = reach < 0 ? 0 : reach / kBlockK;
    if (need < n_kb) n_kb = (int)need;
  }

  if (kCarry && n_kb == 0) {
    // no key is visible to these rows: the carry passes through bit for
    // bit (m's log2 round trip would not), copied unless out is in
    const int rows = min(kBlockQ, tq - q0);
    const int64_t r0 = bh * tq + q0;
    if (a.acc_out != a.acc_in)
      for (int i = threadIdx.x; i < rows * d; i += kThreads)
        a.acc_out[r0 * d + i] = a.acc_in[r0 * d + i];
    for (int i = threadIdx.x; i < rows; i += kThreads) {
      if (a.m_out != a.m_in) a.m_out[r0 + i] = a.m_in[r0 + i];
      if (a.l_out != a.l_in) a.l_out[r0 + i] = a.l_in[r0 + i];
    }
    return;
  }

  // this thread's two q rows (g and g + 8 of the warp's 16); m in units
  // of log2 (scores times sm_scale * log2 e), as exp2 takes them
  int row[2];
  float m[2], l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = q0 + warp * 16 + g + 8 * h;
    m[h] = kNegInf;
    l[h] = 0.f;
  }
  const float scale2 = sm_scale * kLog2e;

  float acc[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  if (kCarry) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row[h] >= tq) continue;
      const int64_t r = bh * tq + row[h];
      const float mc = a.m_in[r];
      m[h] = mc <= kHalfNegInf ? kNegInf : mc * kLog2e;
      l[h] = a.l_in[r];
      const float* in = a.acc_in + r * d;
#pragma unroll
      for (int j = 0; j < OT; ++j) {
        const int col = j * 8 + 2 * t;
        if (vec) {  // d % 8 == 0: col < d means col + 1 < d
          if (col < d) {
            const float2 x = *reinterpret_cast<const float2*>(in + col);
            acc[j][2 * h] = x.x;
            acc[j][2 * h + 1] = x.y;
          }
        } else {
          if (col < d) acc[j][2 * h] = in[col];
          if (col + 1 < d) acc[j][2 * h + 1] = in[col + 1];
        }
      }
    }
  }

  load_rows<kBlockQ, DMAX, kThreads>(sQ, qb, q0, tq, d, vec);
  if (n_kb > 0) {
    load_rows<kBlockK, DMAX, kThreads>(sK, kb, 0, tk, d, vec);
    load_rows<kBlockK, DMAX, kThreads>(sV, vb, 0, tk, d, vec);
  }
  cp_async_commit();

  // ldmatrix row addresses: A fragments (rows of Q), B fragments of K^T
  // (rows of K, two 8-key tiles at once) and of V (rows of V, .trans,
  // two 8-column tiles at once)
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

    // S = Q K^T, [16 x 64] per warp
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t aq[4];
      ldmatrix_x4(aq, sQ + a_row * LD + kk * 16 + a_col);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, tK + (np * 16 + b_row) * LD + kk * 16 + b_col);
        mma_bf16_16816(s[2 * np], aq, bk[0], bk[1]);
        mma_bf16_16816(s[2 * np + 1], aq, bk[2], bk[3]);
      }
    }

    // scale (log2 units) and mask; masked pairs become NEG_INF
    const int k0 = kt * kBlockK;
    const bool edge =
        k0 + kBlockK > tk ||
        (causal && (long long)q_offset + q0 <
                       (long long)k_offset + k0 + kBlockK - 1);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        const bool masked =
            edge && (col >= tk ||
                     (causal && q_offset + row[h] < k_offset + col));
        const float x = masked ? kNegInf : s[j][e] * scale2;
        s[j][e] = x;
        mx[h] = fmaxf(mx[h], x);
      }

    // online softmax: fully masked so far shifts by 0, so exp2(NEG_INF -
    // shift) is 0 and a running max still at NEG_INF scales the old
    // (empty) sums by 0
    float shift[2], rs[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = quad_max(mx[h]);
      shift[h] = mx[h] <= kHalfNegInf ? 0.f : mx[h];
      const float scale_old =
          m[h] <= kHalfNegInf ? 0.f : exp2f(m[h] - shift[h]);
      m[h] = mx[h];
      l[h] *= scale_old;
      rs[h] = 0.f;
#pragma unroll
      for (int j = 0; j < OT; ++j) {
        acc[j][2 * h] *= scale_old;
        acc[j][2 * h + 1] *= scale_old;
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float p = exp2f(s[j][e] - shift[h]);
        s[j][e] = p;
        rs[h] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] += quad_sum(rs[h]);

    // acc += P V: P as A fragments (hi, lo), V as B through .trans
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t hi[4], lo[4];
      c_to_a_split(s[2 * kk], s[2 * kk + 1], hi, lo);
#pragma unroll
      for (int np = 0; np < OT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, tV + (kk * 16 + bt_row) * LD + np * 16 + bt_col);
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
    const int64_t r = bh * tq + row[h];
    if (kCarry) {
      float* out = a.acc_out + r * d;
#pragma unroll
      for (int j = 0; j < OT; ++j) {
        const int col = j * 8 + 2 * t;
        if (vec) {
          if (col < d)
            *reinterpret_cast<float2*>(out + col) =
                make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
        } else {
          if (col < d) out[col] = acc[j][2 * h];
          if (col + 1 < d) out[col + 1] = acc[j][2 * h + 1];
        }
      }
      if (t == 0) {  // a row still fully masked keeps NEG_INF exactly
        a.m_out[r] = m[h] <= kHalfNegInf ? kNegInf : m[h] * kLn2;
        a.l_out[r] = l[h];
      }
      continue;
    }
    const float den = l[h] == 0.f ? 1.f : l[h];
    __nv_bfloat16* out = a.o + r * d;
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      const int col = j * 8 + 2 * t;
      const float x0 = acc[j][2 * h] / den, x1 = acc[j][2 * h + 1] / den;
      if (vec) {  // d % 8 == 0: col < d means col + 1 < d
        if (col < d)
          *reinterpret_cast<__nv_bfloat162*>(out + col) =
              __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < d) out[col] = __float2bfloat16(x0);
        if (col + 1 < d) out[col + 1] = __float2bfloat16(x1);
      }
    }
    if (t == 0) {
      const float shift = m[h] <= kHalfNegInf ? 0.f : m[h];
      a.lse[r] = shift * kLn2 + logf(den);
    }
  }
}

// Launch `kernel` (a __global__ wrapper of flash_tc_tile<DMAX, ...>) over
// the (bh, q tile) grid with its dynamic shared memory.
template <int DMAX>
cudaError_t launch_tc_tile(void (*kernel)(const TileArgs<__nv_bfloat16>, int),
                           const TileArgs<__nv_bfloat16>& a, int vec, int bh,
                           cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (a.tq + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, kThreads, smem, stream>>>(a, vec);
  return cudaGetLastError();
}

}  // namespace
