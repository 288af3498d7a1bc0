// Fused BatchNorm-affine + ReLU forward for NVIDIA Hopper (sm_90a):
//     y = relu(cast(x * scale + shift))      (relu = 1)
//     y =      cast(x * scale + shift)       (relu = 0)
// over a contiguous [N, C] row-major matrix (an NHWC activation with its
// leading axes flattened), scale and shift [C] f32, x f32 or bf16, y f32
// or bf16, math in f32.
//
// Replaces the TPU kernel `_fwd_kernel` in bigdl_tpu/ops/bn_relu_kernel.py
// (launched by `bn_relu_forward`). It computes the same function in the
// same order: the multiply and the add are two roundings (__fmul_rn,
// __fadd_rn, never a fused multiply-add), the result is rounded to y's type,
// and the max with 0 comes after that cast. So the kernel is bitwise equal
// to the plain PyTorch version `(x * scale + shift).to(y.dtype).clamp_min(0)`
// on the card.
//
// Design. Elementwise with a per-column coefficient, so nothing is carried
// between blocks. Each block owns a run of whole rows (about 4096 vectors);
// its 256 threads walk the run's (row, vector) pairs, neighbouring threads
// on neighbouring addresses. When C is a multiple of 4 and the pointers
// are aligned, a thread moves 4 elements at a time (16 B of f32, 8 B of
// bf16); otherwise one. Ragged N and C need no padding: the last block
// takes the rows that are left.
//
// What bounds it. Two flops per element against 6 B moved (f32 in, bf16
// out): memory bandwidth (3.35 TB/s on an H100 SXM). The design reads
// each input once and writes each output once, with wide coalesced
// accesses, and keeps scale/shift in the read-only cache.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVectorsPerBlock = 4096;

struct alignas(8) Bf16x4 {
  __nv_bfloat162 lo, hi;
};

__device__ __forceinline__ void load(const float* p, float (&v)[1]) {
  v[0] = *p;
}
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[1]) {
  v[0] = __bfloat162float(*p);
}
__device__ __forceinline__ void load(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[4]) {
  const Bf16x4 t = *reinterpret_cast<const Bf16x4*>(p);
  const float2 a = __bfloat1622float2(t.lo);
  const float2 b = __bfloat1622float2(t.hi);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void store(float* p, const float (&v)[1]) {
  *p = v[0];
}
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[1]) {
  *p = __float2bfloat16_rn(v[0]);
}
__device__ __forceinline__ void store(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[4]) {
  Bf16x4 t;
  t.lo = __floats2bfloat162_rn(v[0], v[1]);
  t.hi = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<Bf16x4*>(p) = t;
}

// the value a float takes once stored in T (round to nearest even)
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename Tx, typename Ty, int VEC, bool RELU>
__global__ void __launch_bounds__(kThreads)
bn_relu_fwd_kernel(const Tx* __restrict__ x, const float* __restrict__ scale,
                   const float* __restrict__ shift, Ty* __restrict__ y,
                   long long n_rows, int c, int rows_per_block) {
  const int cv = c / VEC;  // vectors per row
  const long long row0 = (long long)blockIdx.x * rows_per_block;
  const int rows = (int)min((long long)rows_per_block, n_rows - row0);
  const int work = rows * cv;
  const long long base = row0 * c;
  for (int j = threadIdx.x; j < work; j += kThreads) {
    const int r = j / cv;
    const int col = (j - r * cv) * VEC;
    const long long off = base + (long long)r * c + col;
    float v[VEC];
    load(x + off, v);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      float t = __fadd_rn(__fmul_rn(v[k], __ldg(scale + col + k)),
                          __ldg(shift + col + k));
      t = round_to(t, y);
      // NaN stays NaN, as clamp_min keeps it
      if (RELU) t = (t < 0.f) ? 0.f : t;
      v[k] = t;
    }
    store(y + off, v);
  }
}

template <typename Tx, typename Ty>
cudaError_t launch(const void* x, const void* scale, const void* shift,
                   void* y, long long n_rows, int c, int relu,
                   cudaStream_t stream) {
  const bool vec4 = c % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % (4 * sizeof(Tx)) == 0 &&
                    reinterpret_cast<uintptr_t>(y) % (4 * sizeof(Ty)) == 0;
  const int cv = vec4 ? c / 4 : c;
  const int rows_per_block = cv >= kVectorsPerBlock ? 1
                                                    : kVectorsPerBlock / cv;
  const long long blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const Tx* xp = static_cast<const Tx*>(x);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(shift);
  Ty* yp = static_cast<Ty*>(y);
  const dim3 grid((unsigned)blocks);
  if (vec4) {
    if (relu)
      bn_relu_fwd_kernel<Tx, Ty, 4, true><<<grid, kThreads, 0, stream>>>(
          xp, sp, bp, yp, n_rows, c, rows_per_block);
    else
      bn_relu_fwd_kernel<Tx, Ty, 4, false><<<grid, kThreads, 0, stream>>>(
          xp, sp, bp, yp, n_rows, c, rows_per_block);
  } else {
    if (relu)
      bn_relu_fwd_kernel<Tx, Ty, 1, true><<<grid, kThreads, 0, stream>>>(
          xp, sp, bp, yp, n_rows, c, rows_per_block);
    else
      bn_relu_fwd_kernel<Tx, Ty, 1, false><<<grid, kThreads, 0, stream>>>(
          xp, sp, bp, yp, n_rows, c, rows_per_block);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. x and y are contiguous [n_rows, c],
// scale and shift contiguous [c] float32, all on one device. Launches on
// `stream` and does not synchronise. Returns the launch's cudaError_t
// (0 on success).
extern "C" int bn_relu_fwd(const void* x, const void* scale,
                           const void* shift, void* y, long long n_rows,
                           int c, int x_dtype, int y_dtype, int relu,
                           void* stream) {
  if (n_rows < 1 || c < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && y_dtype == 0)
    return (int)launch<float, float>(x, scale, shift, y, n_rows, c, relu, s);
  if (x_dtype == 0 && y_dtype == 1)
    return (int)launch<float, __nv_bfloat16>(x, scale, shift, y, n_rows, c,
                                             relu, s);
  if (x_dtype == 1 && y_dtype == 0)
    return (int)launch<__nv_bfloat16, float>(x, scale, shift, y, n_rows, c,
                                             relu, s);
  if (x_dtype == 1 && y_dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(x, scale, shift, y,
                                                     n_rows, c, relu, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* bn_relu_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
