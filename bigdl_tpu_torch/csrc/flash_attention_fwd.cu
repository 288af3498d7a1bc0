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
// bf16 design (the training and prefill path in bf16): the tensor-core
// loop `flash_tc_tile<DMAX, false>` of flash_attention_tc_tile.cuh, shared
// with the ring hop (kernel 2). One block of 4 warps per (b*h, 64-row q
// tile), each warp 16 rows; Q resident in shared memory and read by
// ldmatrix, K/V tiles through a 2-stage cp.async ring; per K/V tile
// S = Q K^T and acc += P V on mma.sync m16n8k16 (bf16 in, f32 accumulate),
// with the online softmax in f32 registers in the accumulator layout. acc
// stays in f32 registers; O = acc / l is written once as bf16 and the f32
// logsumexp once a row.
//
// Precision. q, k and v are bf16 already, so S is exact products summed
// in f32, as the plain version computes it. P is f32: rounded once to
// bf16 it carries 2^-9 of relative error per term, which over ~2048 keys
// puts O 3.6-4.1 times past the per-element limit that holds ring and
// zigzag attention to this kernel (2^-7 |O| + 1e-4 max|O|) when their P is
// f32. So P is split into bf16 hi + bf16 lo and acc += P_hi V + P_lo V:
// two MMAs, an error of about 2^-17 (sized on the CPU by
// tests/test_torch_attention_kernel.py, the forward split test). The
// softmax statistics m and l are summed from the f32 P, as in the plain
// version.
//
// Causal tile skipping, last-first q tiles, ragged edges, the padded head
// dim and element copies for D % 8 != 0 or unaligned pointers are the
// shared loop's (see its header). Each block owns its rows and sums in a
// fixed order, so O and lse are the same bits on every run (no atomics).
//
// f32 inputs keep the first design, `flash_tile<DMAX, false>` in
// flash_attention_tile.cuh (shared with the ring hop, kernel 2): f32 FMAs
// on the CUDA cores out of shared memory. Its limit against the plain
// version is 1e-4 on O with no relative part, which bf16 operands do not
// meet. The entry point picks the design by dtype alone (f32: CUDA cores,
// bf16: tensor cores); nothing retries the other design.
//
// Next step, not this one: wgmma (warpgroup MMAs from shared memory), TMA
// loads and warp specialisation.

#include "flash_attention_tc_tile.cuh"

namespace {

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_tc_kernel(const TileArgs<__nv_bfloat16> a, int vec) {
  flash_tc_tile<DMAX, false>(a, vec);
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const TileArgs<float> a) {
  flash_tile<DMAX, false>(a);
}

template <typename T>
TileArgs<T> fwd_args(const void* q, const void* k, const void* v, void* o,
                     void* lse, int tq, int tk, int d, float sm_scale,
                     int causal, int q_offset, int k_offset) {
  TileArgs<T> a{};
  a.q = static_cast<const T*>(q);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.o = static_cast<T*>(o);
  a.lse = static_cast<float*>(lse);
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
  if (dtype == 0) {
    const auto a = fwd_args<float>(q, k, v, o, lse, tq, tk, d, sm_scale,
                                   causal, q_offset, k_offset);
    return (int)(d <= 64
                     ? launch_tile<64>(flash_fwd_kernel<64>, a, bh, s)
                     : launch_tile<128>(flash_fwd_kernel<128>, a, bh, s));
  }
  if (dtype == 1) {
    const auto a = fwd_args<__nv_bfloat16>(q, k, v, o, lse, tq, tk, d,
                                           sm_scale, causal, q_offset,
                                           k_offset);
    const int vec = d % 8 == 0 && aligned16(q) && aligned16(k) &&
                    aligned16(v) && aligned16(o);
    return (int)(d <= 64
                     ? launch_tc_tile<64>(flash_fwd_tc_kernel<64>, a, vec,
                                          bh, s)
                     : launch_tc_tile<128>(flash_fwd_tc_kernel<128>, a, vec,
                                           bh, s));
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
