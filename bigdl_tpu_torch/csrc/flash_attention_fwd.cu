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
// Design. The tile loop is `flash_tile<T, DMAX, false>` in
// flash_attention_tile.cuh, shared with the ring hop (kernel 2,
// flash_attention_carry.cu): one block of 128 threads per (b*h, 64-row q
// tile). The TPU kernel held all of K and V for a head in VMEM;
// 2048 x 64 x 4 B x 2 does not fit the 227 KB a Hopper block may use, so
// here 64-row K/V tiles stream through shared memory and the online
// softmax (running max m, normaliser l, accumulator acc) lives in
// registers, starting fresh; O and the logsumexp are written at the end.
//
// What bounds it. At the prefill shapes (T up to 2048, D = 64) attention
// does about T/2 multiply-adds per byte it must move, so the card's
// arithmetic rate bounds it, not its memory. This first version does the
// arithmetic as f32 FMAs on the CUDA cores out of shared memory (no
// tensor cores, no TMA, no pipelining); it aims to be right and simple,
// and its time is recorded against the bound in PERF.md.

#include "flash_attention_tile.cuh"

namespace {

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const TileArgs<T> a) {
  flash_tile<T, DMAX, false>(a);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int tq, int tk, int d, float sm_scale,
                   int causal, int q_offset, int k_offset,
                   cudaStream_t stream) {
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
  return d <= 64 ? launch_tile<T, 64>(flash_fwd_kernel<T, 64>, a, bh, stream)
                 : launch_tile<T, 128>(flash_fwd_kernel<T, 128>, a, bh,
                                       stream);
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
  if (!tile_shape_ok(bh, tq, tk, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, o, lse, bh, tq, tk, d, sm_scale,
                              causal, q_offset, k_offset, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, o, lse, bh, tq, tk, d,
                                      sm_scale, causal, q_offset, k_offset,
                                      s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
