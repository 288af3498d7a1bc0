// Flash-attention forward for NVIDIA Hopper (sm_90a): O and the per-row
// logsumexp of softmax(sm_scale * Q K^T, masked) V, over [B*H, T, D]
// tensors in f32 or bf16, with f32 softmax statistics and an f32
// logsumexp.
//
// Replaces the TPU kernel `_flash_fwd_kernel` in
// bigdl_tpu/ops/attention_kernel.py (launched by `flash_attention_forward`,
// numerics in `_kernel_block_update`). It computes the same function,
// including the two guards that keep fully masked rows at O = 0 and
// lse = 0: a row whose running max is still NEG_INF shifts by 0, and a row
// whose normaliser is 0 divides by 1.
//
// What bounds it. At the LM training shape (B*H = 64, T = 2048, D = 64,
// causal, bf16) the two products are 3.4e10 operations against 34 MB of
// traffic: the tensor cores' rate bounds it (0.035 ms at 989 TFLOP/s), not
// the memory (0.010 ms at 3.35 TB/s). So the products belong on the
// tensor cores, with the operands fed from shared memory without stalls.
//
// bf16 design (the training and prefill path in bf16). One block of 4
// warps per (b*h, 64-row q tile); warp w owns q rows 16w .. 16w+15. The
// block's Q rows sit in shared memory as bf16 and are read as mma A
// fragments by ldmatrix on every K tile (held in registers they would
// cost 4 * D / 8 more a thread); 64-row K and V tiles stream through a
// 2-stage cp.async ring, so the next tile's copy overlaps this tile's
// products. Rows are padded to D + 8 elements, which puts the 8 rows of
// every ldmatrix in 8 different bank groups. Per K/V tile, on the tensor
// cores (mma.sync m16n8k16, bf16 in, f32 accumulate):
//   S = Q K^T                        (B fragments: K by ldmatrix)
//   online softmax of S in f32 registers, in the accumulator layout: a
//   row's 64 scores live in the 4 lanes of a quad, so a row's max and sum
//   are two shuffles (xor 1, 2)
//   acc += P V                       (P repacked in registers into A
//                                     fragments; V by ldmatrix.trans)
// acc stays in f32 registers; O = acc / l is written once as bf16 and the
// f32 logsumexp once a row.
//
// Precision. q, k and v are bf16 already, so S is exact products summed
// in f32, as the plain version computes it. P is f32: rounded once to
// bf16 it carries 2^-9 of relative error per term, which over ~2048 keys
// puts O 3.6-4.1 times past the per-element limit that holds ring and
// zigzag attention (f32 P, kernel 2) to this kernel (2^-7 |O| +
// 1e-4 max|O|). So P is split into bf16 hi + bf16 lo and acc += P_hi V +
// P_lo V: two MMAs, an error of about 2^-17 (sized on the CPU by
// tests/test_torch_flash_backward.py, the forward split test). The
// softmax statistics m and l are summed from the f32 P, as in the plain
// version.
//
// Under causal masking the loop stops at the last K tile the q tile can
// see, and q tiles are scheduled last-first so that the long causal rows
// start early; tiles off the diagonal and the ragged edge skip the mask.
// Ragged Tq and Tk are masked here (no caller padding). Head dims up to
// 128 are zero-filled to the compiled width (64 or 128); rows are copied
// 16 bytes at a time when D is a multiple of 8 and every pointer is
// 16-byte aligned, one element at a time otherwise. Each block owns its
// rows and sums in a fixed order, so O and lse are the same bits on every
// run (no atomics).
//
// f32 inputs keep the first design, `flash_tile<float, DMAX, false>` in
// flash_attention_tile.cuh (shared with the ring hop, kernel 2): f32 FMAs
// on the CUDA cores out of shared memory. Its limit against the plain
// version is 1e-4 on O with no relative part, which bf16 operands do not
// meet. The entry point picks the design by dtype alone (f32: CUDA cores,
// bf16: tensor cores); nothing retries the other design.
//
// Next step, not this one: wgmma (warpgroup MMAs from shared memory), TMA
// loads and warp specialisation.

#include "flash_attention_tile.cuh"
#include "mma_bf16.cuh"

namespace {

// ------------------------------------------------------------- bf16 ---

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

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    int tq, int tk, int d, float sm_scale, int causal,
                    int q_offset, int k_offset, int vec) {
  constexpr int LD = DMAX + 8;
  constexpr int NT = kBlockK / 8;   // S column tiles of 8 keys
  constexpr int KD = DMAX / 16;     // 16-deep steps over the head dim
  constexpr int OT = DMAX / 8;      // O column tiles of 8
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  __nv_bfloat16* sK = sQ + kBlockQ * LD;  // [2][kBlockK][LD]
  __nv_bfloat16* sV = sK + 2 * kBlockK * LD;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const __nv_bfloat16* qb = q + bh * tq * d;
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
    const float den = l[h] == 0.f ? 1.f : l[h];
    __nv_bfloat16* out = o + r * d;
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
      lse[r] = shift * kLn2 + logf(den);
    }
  }
}

template <int DMAX>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      void* lse, int bh, int tq, int tk, int d,
                      float sm_scale, int causal, int q_offset, int k_offset,
                      int vec, cudaStream_t stream) {
  auto kernel = flash_fwd_tc_kernel<DMAX>;
  constexpr size_t smem = tc_smem_bytes<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (tq + kBlockQ - 1) / kBlockQ);
  using bf16 = __nv_bfloat16;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), tq, tk, d, sm_scale, causal, q_offset,
      k_offset, vec);
  return cudaGetLastError();
}

// -------------------------------------------------------------- f32 ---

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const TileArgs<float> a) {
  flash_tile<float, DMAX, false>(a);
}

cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int tq, int tk, int d,
                       float sm_scale, int causal, int q_offset, int k_offset,
                       cudaStream_t stream) {
  TileArgs<float> a{};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o = static_cast<float*>(o);
  a.lse = static_cast<float*>(lse);
  a.tq = tq;
  a.tk = tk;
  a.d = d;
  a.sm_scale = sm_scale;
  a.causal = causal;
  a.q_offset = q_offset;
  a.k_offset = k_offset;
  return d <= 64
             ? launch_tile<float, 64>(flash_fwd_kernel<64>, a, bh, stream)
             : launch_tile<float, 128>(flash_fwd_kernel<128>, a, bh, stream);
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores). q is
// [bh, tq, d], k and v [bh, tk, d], o like q, lse [bh, tq] float32; all
// contiguous on one device. Returns the launch's cudaError_t (0 on
// success).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int bh,
                                   int tq, int tk, int d, float sm_scale,
                                   int causal, int q_offset, int k_offset,
                                   int dtype, void* stream) {
  if (!tile_shape_ok(bh, tq, tk, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_f32(q, k, v, o, lse, bh, tq, tk, d, sm_scale, causal,
                           q_offset, k_offset, s);
  if (dtype == 1) {
    const int vec = d % 8 == 0 && aligned16(q) && aligned16(k) &&
                    aligned16(v) && aligned16(o);
    return (int)(d <= 64
                     ? launch_tc<64>(q, k, v, o, lse, bh, tq, tk, d, sm_scale,
                                     causal, q_offset, k_offset, vec, s)
                     : launch_tc<128>(q, k, v, o, lse, bh, tq, tk, d,
                                      sm_scale, causal, q_offset, k_offset,
                                      vec, s));
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
