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
// x is read in its own dtype: in bf16 training the BN layer hands over the
// bf16 activation it received, not the f32 copy its statistics use (the
// upcast is exact, so y is the same bits either way).
//
// Design. Elementwise with a per-column coefficient, so nothing is carried
// between blocks. Every thread owns one octet of 8 neighbouring columns for
// the whole launch: its 8 scales and shifts are loaded once into registers
// and no index is divided. A block is `group_octets` octet lanes (at most
// 64 columns, one column group: blockIdx.y) by `lanes_y` row lanes; the
// octet lanes of a row are neighbouring addresses, and when a group spans
// the whole row so are the rows, so a warp reads one contiguous run. Each
// thread walks the rows of the grid-stride loop. When C % 8 == 0 and both
// pointers are 16-byte aligned, an octet moves as 16-byte accesses (one of
// 8 bf16 values, two of 4 f32); otherwise element by element, masked at the
// ragged edge. The caller picks the groups and the row lanes (fewer for a
// small N, so that a small matrix still spreads over many blocks); the row
// blocks are as many as fill every SM at the kernel's occupancy, and for a
// matrix far larger than the L2 cache as many as give each thread about 4
// passes (on the H100 faster there than one resident wave, and slower
// where the matrix fits in L2).
//
// What bounds it. Three flops per element against 4 B moved (bf16 in, bf16
// out; 6 B with an f32 x): memory bandwidth (3.35 TB/s on an H100 SXM). The
// design reads each input once and writes each output once with 16-byte
// coalesced accesses, and keeps every SM busy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kOctet = 8;  // columns a thread owns
constexpr long long kLargeElems = 1LL << 25;
constexpr long long kPassesLarge = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 8 values from p (16-byte aligned) as f32
__device__ __forceinline__ void load8(const float* p, float (&v)[kOctet]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&v)[kOctet]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float (&v)[kOctet]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&v)[kOctet]) {
  uint4 t;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&t);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = t;
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// the value a float takes once stored in T (round to nearest even)
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename Ty, bool RELU>
__device__ __forceinline__ float affine(float v, float s, float b) {
  float t = round_to(__fadd_rn(__fmul_rn(v, s), b), static_cast<Ty*>(nullptr));
  // NaN stays NaN, as clamp_min keeps it
  if (RELU) t = (t < 0.f) ? 0.f : t;
  return t;
}

// WIDE: C % 8 == 0 and x, y 16-byte aligned, so every octet is whole and
// moves as 16-byte accesses
template <typename Tx, typename Ty, bool RELU, bool WIDE>
__global__ void __launch_bounds__(256)
bn_relu_fwd_kernel(const Tx* __restrict__ x, const float* __restrict__ scale,
                   const float* __restrict__ shift, Ty* __restrict__ y,
                   long long n_rows, int c) {
  const int col0 = (blockIdx.y * blockDim.x + threadIdx.x) * kOctet;
  if (col0 >= c) return;
  float s[kOctet], b[kOctet];
#pragma unroll
  for (int k = 0; k < kOctet; ++k) {
    const bool in = WIDE || col0 + k < c;
    s[k] = in ? __ldg(scale + col0 + k) : 0.f;
    b[k] = in ? __ldg(shift + col0 + k) : 0.f;
  }
  const long long step = (long long)gridDim.x * blockDim.y;
#pragma unroll 4
  for (long long r = (long long)blockIdx.x * blockDim.y + threadIdx.y;
       r < n_rows; r += step) {
    const long long off = r * c + col0;
    if (WIDE) {
      float v[kOctet];
      load8(x + off, v);
#pragma unroll
      for (int k = 0; k < kOctet; ++k) v[k] = affine<Ty, RELU>(v[k], s[k], b[k]);
      store8(y + off, v);
    } else {
#pragma unroll
      for (int k = 0; k < kOctet; ++k)
        if (col0 + k < c)
          store1(y + off + k, affine<Ty, RELU>(to_f32(x[off + k]), s[k], b[k]));
    }
  }
}

template <typename Tx, typename Ty, bool RELU, bool WIDE>
cudaError_t launch_one(const Tx* x, const float* scale, const float* shift,
                       Ty* y, long long n_rows, int c, int group_octets,
                       int lanes_y, cudaStream_t stream) {
  auto kernel = bn_relu_fwd_kernel<Tx, Ty, RELU, WIDE>;
  const int threads = group_octets * lanes_y;
  // the SM count and this kernel's resident blocks an SM, by block size,
  // asked once (a race between two first calls writes the same value)
  static int occupancy[257];
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && occupancy[threads] == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occupancy[threads],
                                                        kernel, threads, 0);
  if (err != cudaSuccess) return err;
  const int per_sm = occupancy[threads];
  const int octets = (c + kOctet - 1) / kOctet;
  const int groups = (octets + group_octets - 1) / group_octets;
  // as many row blocks as fill every SM at this occupancy, at most one a
  // pass of lanes_y rows; a matrix of 2^25 elements or more (several
  // times the L2 cache) streams faster from more, shorter-lived blocks:
  // there, about kPassesLarge passes a thread
  const long long fill = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long passes = (n_rows + lanes_y - 1) / lanes_y;
  long long want = fill / groups > 0 ? fill / groups : 1;
  const long long short_lived = (passes + kPassesLarge - 1) / kPassesLarge;
  if (n_rows * c >= kLargeElems && short_lived > want) want = short_lived;
  const long long row_blocks = passes < want ? passes : want;
  if (row_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)row_blocks, (unsigned)groups),
      block(group_octets, lanes_y);
  kernel<<<grid, block, 0, stream>>>(x, scale, shift, y, n_rows, c);
  return cudaGetLastError();
}

template <typename Tx, typename Ty>
cudaError_t launch(const void* x, const void* scale, const void* shift,
                   void* y, long long n_rows, int c, int group_octets,
                   int lanes_y, int relu, cudaStream_t stream) {
  const bool wide = c % kOctet == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const Tx* xp = static_cast<const Tx*>(x);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(shift);
  Ty* yp = static_cast<Ty*>(y);
#define BN_FWD_LAUNCH(R, W)                                               \
  return launch_one<Tx, Ty, R, W>(xp, sp, bp, yp, n_rows, c, group_octets, \
                                  lanes_y, stream)
  if (relu) {
    if (wide) BN_FWD_LAUNCH(true, true);
    BN_FWD_LAUNCH(true, false);
  }
  if (wide) BN_FWD_LAUNCH(false, true);
  BN_FWD_LAUNCH(false, false);
#undef BN_FWD_LAUNCH
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. x and y are contiguous [n_rows, c],
// scale and shift contiguous [c] float32, all on the current device. A
// block is group_octets x lanes_y threads (at most 256), each owning 8
// columns; blockIdx.y walks the ceil(ceil(c / 8) / group_octets) column
// groups. Launches on `stream` and does not synchronise. Returns the
// launch's cudaError_t (0 on success).
extern "C" int bn_relu_fwd(const void* x, const void* scale,
                           const void* shift, void* y, long long n_rows,
                           int c, int group_octets, int lanes_y, int x_dtype,
                           int y_dtype, int relu, void* stream) {
  if (n_rows < 1 || c < 1 || group_octets < 1 || lanes_y < 1 ||
      group_octets * lanes_y > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && y_dtype == 0)
    return (int)launch<float, float>(x, scale, shift, y, n_rows, c,
                                     group_octets, lanes_y, relu, s);
  if (x_dtype == 0 && y_dtype == 1)
    return (int)launch<float, __nv_bfloat16>(x, scale, shift, y, n_rows, c,
                                             group_octets, lanes_y, relu, s);
  if (x_dtype == 1 && y_dtype == 0)
    return (int)launch<__nv_bfloat16, float>(x, scale, shift, y, n_rows, c,
                                             group_octets, lanes_y, relu, s);
  if (x_dtype == 1 && y_dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(
        x, scale, shift, y, n_rows, c, group_octets, lanes_y, relu, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* bn_relu_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
