// One ring-attention hop for NVIDIA Hopper (sm_90a): continue a carried,
// unnormalised online softmax (acc, m, l) with one K/V shard, over
// [B*H, T, D] tensors in f32 or bf16 with f32 math and an f32 carry:
//   acc <- acc * exp(m - m') + exp(S - m') V,   l <- l * exp(m - m') +
//   rowsum(exp(S - m')),   m' = max(m, rowmax(S)),
//   S = sm_scale * Q K^T, masked causally at the global positions
//   q_offset + i >= k_offset + j.
// `attention_state_finish` (acc / l) normalises after the last hop.
//
// Replaces the TPU kernel `_flash_carry_kernel` in
// bigdl_tpu/ops/attention_kernel.py:277 (launched by
// `flash_attention_carry`, numerics in `_kernel_block_update`), which ring
// and zigzag attention (`parallel/sequence.py`) run once a hop. The
// offsets are runtime arguments, as the TPU kernel takes them as data.
//
// What bounds it (chip_smoke.py `carry_bound`: q, k, v read once, the f32
// carry read once and written once, 4 D operations per unmasked pair), at
// B*H = 8, D = 64, bf16:
//   ring below-diagonal hop, 2048 x 2048, all pairs: 8.6e9 operations
//     against 15 MB, operations bound it (8.7 us at 989 TFLOP/s; the
//     bytes take 4.5 us at 3.35 TB/s);
//   ring diagonal hop, half the pairs: 4.3e9 operations, 4.3 us, against
//     the same 15 MB, 4.5 us: bytes bound it;
//   zigzag chunk, 1024 x 1024, all pairs: 2.1e9 operations, 2.2 us,
//     against 7.4 MB, 2.2 us: bytes bound it, barely.
// Half the bytes are the carry (8.7 MB of the 15 at the ring's hop).
//
// Design, by dtype (the entry point picks by dtype alone; nothing retries
// the other design):
//   bf16: `flash_tc_tile<DMAX, true>` (flash_attention_tc_tile.cuh), the
//     tensor-core loop of kernel 1's bf16 design: 4 warps of 16 q rows,
//     mma.sync m16n8k16, Q re-read by ldmatrix, a 2-stage cp.async K/V
//     ring. The carried acc is loaded and stored in the accumulator layout
//     (thread (g, t) of warp w: rows 16w + g and 16w + g + 8, columns
//     8j + 2t and 8j + 2t + 1), m and l once a row; m is converted from
//     natural-log to log2 units on load and back on store, and a row still
//     fully masked stores m = NEG_INF exactly.
//   f32: `flash_tile<DMAX, true>` (flash_attention_tile.cuh), the CUDA-core
//     loop of kernel 1's f32 design. f32 inputs have no relative limit
//     against the plain version, and neither bf16 operands nor TF32 meet
//     1e-5 of max|acc|.
// In both, a block owns its rows, so the outputs may alias the inputs and
// the ring updates its carry in place (the carry's in and out pointers are
// not __restrict__). When the causal bound leaves no K tile (the shard lies
// wholly in the queries' future) the carry passes through bit for bit, as
// the TPU kernel's n_needed = 0 leaves it. Unlike the TPU wrapper, nothing
// falls back to the blockwise XLA step: ragged Tq and Tk are masked here,
// and any head dim up to 128 is taken.
//
// Why P is split into bf16 hi + lo for P V (as kernels 1, 3 and 4 do): in a
// CPU emulation of this arithmetic against the plain version
// (tests/test_torch_attention_kernel.py, the carry split test: B2 H4 D64,
// causal, below-diagonal, diagonal and still-masked hops), the split takes
// 0.12-0.19 of phase 9(a)'s limit on acc (1e-5 of max|plain|); P rounded
// once to bf16 takes 83-137 of it.
//
// Left for later: wgmma and TMA (as for kernels 1, 3 and 4), and launches
// that under-fill the card: a ring hop is 256 blocks and a zigzag chunk
// 128, on 132 SMs.

#include "flash_attention_tc_tile.cuh"

namespace {

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_carry_tc_kernel(const TileArgs<__nv_bfloat16> a, int vec) {
  flash_tc_tile<DMAX, true>(a, vec);
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_carry_kernel(const TileArgs<float> a) {
  flash_tile<DMAX, true>(a);
}

template <typename T>
TileArgs<T> carry_args(const void* q, const void* k, const void* v,
                       const void* acc_in, const void* m_in,
                       const void* l_in, void* acc_out, void* m_out,
                       void* l_out, int tq, int tk, int d, float sm_scale,
                       int causal, int q_offset, int k_offset) {
  TileArgs<T> a{};
  a.q = static_cast<const T*>(q);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.acc_in = static_cast<const float*>(acc_in);
  a.m_in = static_cast<const float*>(m_in);
  a.l_in = static_cast<const float*>(l_in);
  a.acc_out = static_cast<float*>(acc_out);
  a.m_out = static_cast<float*>(m_out);
  a.l_out = static_cast<float*>(l_out);
  a.tq = tq;
  a.tk = tk;
  a.d = d;
  a.sm_scale = sm_scale;
  a.causal = causal;
  a.q_offset = q_offset;
  a.k_offset = k_offset;
  return a;
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores), of q, k
// and v. q is [bh, tq, d], k and v [bh, tk, d]; acc [bh, tq, d], m and l
// [bh, tq], in and out, float32; all contiguous on one device. The outputs
// may be the inputs. Returns the launch's cudaError_t (0 on success).
extern "C" int flash_attention_carry(const void* q, const void* k,
                                     const void* v, const void* acc_in,
                                     const void* m_in, const void* l_in,
                                     void* acc_out, void* m_out, void* l_out,
                                     int bh, int tq, int tk, int d,
                                     float sm_scale, int causal,
                                     int q_offset, int k_offset, int dtype,
                                     void* stream) {
  if (!tile_shape_ok(bh, tq, tk, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const auto a = carry_args<float>(q, k, v, acc_in, m_in, l_in, acc_out,
                                     m_out, l_out, tq, tk, d, sm_scale,
                                     causal, q_offset, k_offset);
    return (int)(d <= 64
                     ? launch_tile<64>(flash_carry_kernel<64>, a, bh, s)
                     : launch_tile<128>(flash_carry_kernel<128>, a, bh, s));
  }
  if (dtype == 1) {
    const auto a = carry_args<__nv_bfloat16>(
        q, k, v, acc_in, m_in, l_in, acc_out, m_out, l_out, tq, tk, d,
        sm_scale, causal, q_offset, k_offset);
    const int vec = d % 8 == 0 && aligned16(q) && aligned16(k) &&
                    aligned16(v) && aligned16(acc_in) && aligned16(acc_out);
    return (int)(d <= 64
                     ? launch_tc_tile<64>(flash_carry_tc_kernel<64>, a, vec,
                                          bh, s)
                     : launch_tc_tile<128>(flash_carry_tc_kernel<128>, a,
                                           vec, bh, s));
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_carry_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
