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
// bigdl_tpu/ops/attention_kernel.py (launched by `flash_attention_carry`,
// numerics in `_kernel_block_update`), which ring and zigzag attention
// (`parallel/sequence.py`) run once a hop. The offsets are runtime
// arguments, as the TPU kernel takes them as data.
//
// Design. The tile loop is `flash_tile<T, DMAX, true>` in
// flash_attention_tile.cuh, the same code as kernel 1's f32 design: the two
// cannot drift apart (kernel 1's bf16 design runs on the tensor cores; this
// kernel does not, in either dtype). A block loads its rows' carried acc, m
// and l with the map it stores them with (row ty * kRows + i, column tx + 8 *
// j), so the outputs may alias the inputs and the ring updates its carry in
// place. When the causal bound leaves no K tile (the shard lies wholly in the
// queries' future) the carry passes through bit for bit, as the TPU kernel's
// n_needed = 0 leaves it. A row still fully masked keeps m = NEG_INF and l =
// 0: the old sums are scaled by 0 while the carried m is NEG_INF, and the
// shift is 0 while the new m is. Unlike the TPU wrapper, nothing falls back
// to the blockwise XLA step: ragged Tq and Tk are masked here, and any head
// dim up to 128 is taken.
//
// What bounds it. At the ring's hop shape (B*H = 8, Tq = Tk = 2048,
// D = 64, bf16) a below-diagonal hop is 8.6e9 operations against 15 MB of
// traffic (q, k, v read; acc, m, l read and written): the tensor cores'
// rate bounds it (8.7 us at 989 TFLOP/s), not the memory (4.5 us at
// 3.35 TB/s). This first version, like kernel 1's f32 design, does the
// products as f32 FMAs on the CUDA cores out of shared memory; its time is
// recorded against the bound in PERF.md.

#include "flash_attention_tile.cuh"

namespace {

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_carry_kernel(const TileArgs<T> a) {
  flash_tile<T, DMAX, true>(a);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* acc_in, const void* m_in, const void* l_in,
                   void* acc_out, void* m_out, void* l_out, int bh, int tq,
                   int tk, int d, float sm_scale, int causal, int q_offset,
                   int k_offset, cudaStream_t stream) {
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
  return d <= 64
             ? launch_tile<T, 64>(flash_carry_kernel<T, 64>, a, bh, stream)
             : launch_tile<T, 128>(flash_carry_kernel<T, 128>, a, bh,
                                   stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v). q is [bh, tq, d], k and v
// [bh, tk, d]; acc [bh, tq, d], m and l [bh, tq], in and out, float32; all
// contiguous on one device. The outputs may be the inputs.
// Returns the launch's cudaError_t (0 on success).
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
  if (dtype == 0)
    return (int)launch<float>(q, k, v, acc_in, m_in, l_in, acc_out, m_out,
                              l_out, bh, tq, tk, d, sm_scale, causal,
                              q_offset, k_offset, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, acc_in, m_in, l_in, acc_out,
                                      m_out, l_out, bh, tq, tk, d, sm_scale,
                                      causal, q_offset, k_offset, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_carry_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
