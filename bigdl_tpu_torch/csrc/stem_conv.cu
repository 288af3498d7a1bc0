// Space-to-depth stem convolution for NVIDIA Hopper (sm_90a):
//     out[b, i, j, o] = bias[o] + sum_{dy, dx, c} xp[b, i+dy, j+dx, c]
//                                                 * wk[dy, dx, c, o]
// over x2 [B, H, W, C2] (NHWC, f32 or bf16), wk [kt, kt, C2, O] (f32 or
// bf16), bias [O] f32 or none; xp is x2 zero-padded by pad_front rows and
// columns in front and kt - 1 - pad_front behind. The sum runs in f32 and
// out [B, H, W, O] takes x2's dtype. ResNet-50's stem after the 2x2
// space-to-depth: x2 [b, 112, 112, 12], kt = 4, O = 64, pads 2 / 1.
//
// Replaces the TPU kernel `_stem_kernel` in bigdl_tpu/ops/stem_kernel.py
// (launched by `stem_conv_forward`), which builds an im2col tile in VMEM
// and runs one [pixels, kt*kt*C2] @ [kt*kt*C2, O] product. The function is
// the same; the Mosaic workarounds (dx-shifted pre-padded copies, W tiles
// that divide W) are not needed here.
//
// Design. One block of 256 threads owns an 8 x 16 tile of output pixels of
// one image and a chunk of 64 output channels. It stages into shared
// memory, as f32:
//   - the input halo, (8 + kt - 1) x (16 + kt - 1) x C2, read from the
//     UNPADDED x2 with zeros wherever the halo falls outside the image,
//     which is the padding on both sides and the ragged edge at once;
//   - the weight chunk [kt*kt*C2, 64] (48 KB at ResNet-50's shape, so the
//     dynamic shared memory is raised above 48 KB).
// Thread (col, lane) then computes the 8 pixels of column `col` for the
// 4 channels 4*lane .. 4*lane+3 in registers: for each (dx, c) it loads
// the column's 8 + kt - 1 halo values once and reuses them for every dy,
// with one 16-byte weight load per (dy, dx, c). It adds the bias and
// stores NHWC with the channels fastest, 16 lanes writing 64 consecutive
// channels of a pixel (16-byte stores when O % 4 == 0). Any H, W and O
// (ragged tiles and channel chunks guarded), C2 <= 16, kt in {2, 4, 6}.
//
// What bounds it. 2 * kt*kt*C2 operations per output against 2-4 bytes
// written per output: by the card's f32 rate (67 TFLOP/s on the CUDA
// cores) the operations bound it in f32; against the tensor cores' bf16
// rate the bytes would. This first kernel does its FMAs on the CUDA
// cores; tensor cores (`mma.sync` / `wgmma`) and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 16;               // channel lanes, 4 channels each
constexpr int kChunk = 4 * kLanes;       // output channels a block owns
constexpr int kTileW = kThreads / kLanes;  // output columns a block owns
constexpr int kTileH = 8;                // output rows a block owns
constexpr int kMaxC2 = 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct alignas(8) Bf16x4 {
  __nv_bfloat162 lo, hi;
};

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  Bf16x4 t;
  t.lo = __floats2bfloat162_rn(v[0], v[1]);
  t.hi = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<Bf16x4*>(p) = t;
}

// shared memory of one block: the weight chunk and the input halo, f32
size_t smem_bytes(int kt, int c2) {
  return sizeof(float) * ((size_t)kt * kt * c2 * kChunk +
                          (size_t)(kTileH + kt - 1) * (kTileW + kt - 1) * c2);
}

template <typename TX, typename TW, int KT>
__global__ void __launch_bounds__(kThreads)
stem_conv_kernel(const TX* __restrict__ x, const TW* __restrict__ wk,
                 const float* __restrict__ bias, TX* __restrict__ out,
                 int h, int w, int c2, int n_out, int pad_front,
                 int tiles_w) {
  constexpr int HH = kTileH + KT - 1;  // halo rows
  constexpr int HW = kTileW + KT - 1;  // halo columns
  extern __shared__ __align__(16) float smem[];
  const int k_total = KT * KT * c2;
  float* w_s = smem;                      // [k_total][kChunk]
  float* x_s = smem + k_total * kChunk;   // [HH][HW][c2]

  const int tid = threadIdx.x;
  const int tile_y = blockIdx.x / tiles_w;
  const int y0 = tile_y * kTileH;
  const int x0 = (blockIdx.x - tile_y * tiles_w) * kTileW;
  const int b = blockIdx.y;
  const int o0 = blockIdx.z * kChunk;

  // the weight chunk: w_s[k][o] = wk[k][o0 + o], zero past O
  for (int i = tid; i < k_total * kChunk; i += kThreads) {
    const int k = i / kChunk;
    const int o = o0 + (i - k * kChunk);
    w_s[i] = o < n_out ? to_f32(wk[(long long)k * n_out + o]) : 0.f;
  }
  // the halo: rows y0 - pad_front .., columns x0 - pad_front .., zero
  // outside the image (the padding on either side, the ragged edge)
  const TX* xb = x + (long long)b * h * w * c2;
  for (int i = tid; i < HH * HW * c2; i += kThreads) {
    const int r = i / c2;
    const int c = i - r * c2;
    const int hy = r / HW;
    const int gy = y0 + hy - pad_front;
    const int gx = x0 + (r - hy * HW) - pad_front;
    float v = 0.f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w)
      v = to_f32(xb[((long long)gy * w + gx) * c2 + c]);
    x_s[i] = v;
  }
  __syncthreads();

  const int lane = tid % kLanes;  // channels o0 + 4 * lane .. + 3
  const int col = tid / kLanes;   // output column x0 + col
  float acc[kTileH][4];
#pragma unroll
  for (int i = 0; i < kTileH; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int dx = 0; dx < KT; ++dx) {
    for (int c = 0; c < c2; ++c) {
      float v[HH];
#pragma unroll
      for (int r = 0; r < HH; ++r) v[r] = x_s[(r * HW + col + dx) * c2 + c];
#pragma unroll
      for (int dy = 0; dy < KT; ++dy) {
        const float4 wv = *reinterpret_cast<const float4*>(
            w_s + ((dy * KT + dx) * c2 + c) * kChunk + 4 * lane);
#pragma unroll
        for (int i = 0; i < kTileH; ++i) {
          acc[i][0] = fmaf(v[dy + i], wv.x, acc[i][0]);
          acc[i][1] = fmaf(v[dy + i], wv.y, acc[i][1]);
          acc[i][2] = fmaf(v[dy + i], wv.z, acc[i][2]);
          acc[i][3] = fmaf(v[dy + i], wv.w, acc[i][3]);
        }
      }
    }
  }

  const int ox = x0 + col;
  const int oc = o0 + 4 * lane;
  if (ox >= w || oc >= n_out) return;
  float bv[4] = {0.f, 0.f, 0.f, 0.f};
  if (bias != nullptr) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (oc + j < n_out) bv[j] = bias[oc + j];
  }
  const bool vec = n_out % 4 == 0;  // then oc + 3 < n_out, 16 B aligned
#pragma unroll
  for (int i = 0; i < kTileH; ++i) {
    const int oy = y0 + i;
    if (oy >= h) break;
    TX* p = out + (((long long)b * h + oy) * w + ox) * n_out + oc;
    float r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      r[j] = bias != nullptr ? acc[i][j] + bv[j] : acc[i][j];
    if (vec) {
      store4(p, r);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (oc + j < n_out) store1(p + j, r[j]);
    }
  }
}

template <typename TX, typename TW, int KT>
cudaError_t launch(const void* x, const void* wk, const float* bias,
                   void* out, int b, int h, int w, int c2, int n_out,
                   int pad_front, cudaStream_t stream) {
  auto kernel = stem_conv_kernel<TX, TW, KT>;
  const size_t smem = smem_bytes(KT, c2);
  // above 48 KB a kernel must opt in to its dynamic shared memory; the
  // largest request (kt = 6, C2 = 16) is 161 KB of the 227 KB allowed
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int tiles_w = (w + kTileW - 1) / kTileW;
  const int tiles_h = (h + kTileH - 1) / kTileH;
  const long long tiles = (long long)tiles_w * tiles_h;
  const int chunks = (n_out + kChunk - 1) / kChunk;
  if (tiles > 0x7fffffffLL || b > 65535 || chunks > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)b, (unsigned)chunks);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(wk), bias,
      static_cast<TX*>(out), h, w, c2, n_out, pad_front, tiles_w);
  return cudaGetLastError();
}

template <typename TX, typename TW>
cudaError_t launch_kt(int kt, const void* x, const void* wk,
                      const float* bias, void* out, int b, int h, int w,
                      int c2, int n_out, int pad_front, cudaStream_t s) {
  switch (kt) {
    case 2:
      return launch<TX, TW, 2>(x, wk, bias, out, b, h, w, c2, n_out,
                               pad_front, s);
    case 4:
      return launch<TX, TW, 4>(x, wk, bias, out, b, h, w, c2, n_out,
                               pad_front, s);
    case 6:
      return launch<TX, TW, 6>(x, wk, bias, out, b, h, w, c2, n_out,
                               pad_front, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. x [b, h, w, c2] and wk
// [kt, kt, c2, n_out] contiguous, bias contiguous [n_out] float32 (read
// only when has_bias), out contiguous [b, h, w, n_out] in x's dtype, all
// on one device. Launches on `stream` and does not synchronise. Returns
// the launch's cudaError_t (0 on success).
extern "C" int stem_conv(const void* x, const void* wk, const void* bias,
                         void* out, int b, int h, int w, int c2, int n_out,
                         int kt, int pad_front, int x_dtype, int w_dtype,
                         int has_bias, void* stream) {
  if (b < 1 || h < 1 || w < 1 || c2 < 1 || c2 > kMaxC2 || n_out < 1 ||
      pad_front < 0 || pad_front > kt - 1)
    return (int)cudaErrorInvalidValue;
  const float* bp = has_bias ? static_cast<const float*>(bias) : nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0)
    return (int)launch_kt<float, float>(kt, x, wk, bp, out, b, h, w, c2,
                                        n_out, pad_front, s);
  if (x_dtype == 0 && w_dtype == 1)
    return (int)launch_kt<float, __nv_bfloat16>(kt, x, wk, bp, out, b, h, w,
                                                c2, n_out, pad_front, s);
  if (x_dtype == 1 && w_dtype == 0)
    return (int)launch_kt<__nv_bfloat16, float>(kt, x, wk, bp, out, b, h, w,
                                                c2, n_out, pad_front, s);
  if (x_dtype == 1 && w_dtype == 1)
    return (int)launch_kt<__nv_bfloat16, __nv_bfloat16>(
        kt, x, wk, bp, out, b, h, w, c2, n_out, pad_front, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* stem_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
