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
// What bounds it. 2 * kt*kt*C2 operations per output against 2-4 bytes
// written per output. At ResNet-50's training shape (b128, bf16) that is
// 3.0e10 operations (0.030 ms at the tensor cores' 989 TFLOP/s) against
// 244 MB, 205 MB of it the output (0.073 ms at 3.35 TB/s): the bytes bound
// it, once the products are on the tensor cores. In f32 the CUDA cores'
// 67 TFLOP/s bound it (0.113 ms at the served b32 shape).
//
// Two designs; the entry point picks one by dtype and shape alone, and
// nothing retries the other:
//   - tensor cores: x2 and wk both bf16 and O % 8 == 0 (the bf16 training
//     path);
//   - CUDA cores (f32 FMAs): everything else the function takes: f32
//     (the served path, f32 with TF32 off), mixed f32 / bf16, and bf16
//     with O % 8 != 0.
//
// Tensor-core design: an implicit GEMM with M = output pixels, N = O and
// K = kt*kt taps x 16 channels, on mma.sync m16n8k16 (bf16 in, f32
// accumulate). A block of 8 warps is persistent: it stages its chunk of
// 64 output channels of the weights once, as bf16 [kt*kt][16][64] with
// zeros past C2 (rows padded to 72 for ldmatrix), and then walks over
// 16 x 16 tiles of output pixels. For each tile it stages the input halo,
// (16 + kt - 1)^2 pixels x 16 channels, with cp.async from the UNPADDED
// x2, zero-filled wherever the halo falls outside the image (the padding
// on both sides and the ragged edge at once) and past C2; the next
// tile's halo copy overlaps this tile's products (two stages). With C2
// padded to 16 one k16 step is one (dy, dx) tap, and the A row of pixel
// (y, x) at that tap is the 32 contiguous bytes halo[y+dy][x+dx][0:16]:
// ldmatrix reads it directly, no im2col copy. Halo pixels are 48 bytes
// apart, so the 8 rows of an ldmatrix (8 neighbouring pixels) fall in 8
// different bank groups. Warp w owns output rows 2w and 2w+1 of the tile
// (two m16 tiles of 16 pixels) and all 64 channels, so every weight
// fragment it loads serves two MMAs. At ResNet-50's kt = 4 a tile is 16
// k16 steps (12 with no padding: the bytes bound it, so the extra
// products cost nothing that matters). The epilogue adds the bias in f32,
// rounds once to bf16 and stages the tile in shared memory, so that each
// pixel's 64 channels (128 B) leave as 16-byte coalesced stores. The
// halo is copied 8 bytes (4 channels) at a time when C2 % 4 == 0 and x2
// is 8-byte aligned, one element at a time otherwise. Products are exact
// in bf16 and summed in f32, so the result differs from the plain version
// only in the order of the f32 sum; each output is computed by one warp
// in a fixed order, so a second launch gives the same bits (no atomics).
//
// CUDA-core design (the first one): one block of 256 threads owns an
// 8 x 16 tile of output pixels of one image and a chunk of 64 output
// channels. It stages the same zero-filled halo and the weight chunk in
// shared memory as f32, and thread (col, lane) computes the 8 pixels of
// column `col` for the 4 channels 4*lane .. 4*lane+3 in registers: for
// each (dx, c) it loads the column's 8 + kt - 1 halo values once and
// reuses them for every dy, with one 16-byte weight load per (dy, dx, c).
// It adds the bias and stores NHWC with the channels fastest (16-byte
// stores when O % 4 == 0). Any H, W and O, C2 <= 16, kt in {2, 4, 6}.
//
// Next step, not this one: wgmma and TMA for the tensor-core design; the
// f32 path on TF32 tensor cores if the served path ever allows TF32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

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

// ------------------------------------------------- tensor cores, bf16 ---

constexpr int kTcThreads = 256;  // 8 warps
constexpr int kTcTile = 16;      // a tile: 16 x 16 output pixels
constexpr int kTcC = 16;         // channels a k16 step takes (C2 padded)
constexpr int kPix = 24;         // halo pixel stride in bf16 (48 bytes)
constexpr int kLd = kChunk + 8;  // weight and output row stride in bf16

template <int KT>
struct TcLayout {
  static constexpr int kSide = kTcTile + KT - 1;          // halo side
  static constexpr int kW = KT * KT * kTcC * kLd;         // weights
  static constexpr int kHalo = kSide * kSide * kPix;      // one stage
  static constexpr int kOut = kTcTile * kTcTile * kLd;    // output tile
  static constexpr size_t kBytes =
      sizeof(__nv_bfloat16) * (kW + 2 * kHalo + kOut);
};

// image, first output row and first output column of pixel tile `tile`
struct TileAt {
  int b, y0, x0;
};

__device__ __forceinline__ TileAt tile_at(int tile, int tiles_h,
                                          int tiles_w) {
  const int per_image = tiles_h * tiles_w;
  const int b = tile / per_image;
  const int r = tile - b * per_image;
  const int ty = r / tiles_w;
  return {b, ty * kTcTile, (r - ty * tiles_w) * kTcTile};
}

// the halo of a tile into dst [side][side][kPix]: x2 rows y0 - pad_front
// .., columns x0 - pad_front .., channels 0 .. 15; zero outside the image
// and past C2
template <int KT>
__device__ __forceinline__ void load_halo(__nv_bfloat16* dst,
                                          const __nv_bfloat16* x, TileAt at,
                                          int h, int w, int c2,
                                          int pad_front, bool vec) {
  constexpr int kSide = TcLayout<KT>::kSide;
  const int gy0 = at.y0 - pad_front, gx0 = at.x0 - pad_front;
  const __nv_bfloat16* xb = x + (long long)at.b * h * w * c2;
  if (vec) {  // C2 % 4 == 0 and x 8-byte aligned: 4 channels a copy
    for (int i = threadIdx.x; i < kSide * kSide * 4; i += kTcThreads) {
      const int p = i >> 2, c = (i & 3) * 4;
      const int hy = p / kSide;
      const int gy = gy0 + hy, gx = gx0 + (p - hy * kSide);
      const bool ok = c < c2 && gy >= 0 && gy < h && gx >= 0 && gx < w;
      cp_async_8(dst + p * kPix + c,
                 ok ? xb + ((long long)gy * w + gx) * c2 + c : x, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kSide * kSide * kTcC; i += kTcThreads) {
      const int p = i / kTcC, c = i % kTcC;
      const int hy = p / kSide;
      const int gy = gy0 + hy, gx = gx0 + (p - hy * kSide);
      const bool ok = c < c2 && gy >= 0 && gy < h && gx >= 0 && gx < w;
      dst[p * kPix + c] = ok ? xb[((long long)gy * w + gx) * c2 + c]
                             : __float2bfloat16(0.f);
    }
  }
}

template <int KT>
__global__ void __launch_bounds__(kTcThreads)
stem_conv_tc_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ wk,
                    const float* __restrict__ bias,
                    __nv_bfloat16* __restrict__ out, int n_tiles,
                    int tiles_h, int tiles_w, int h, int w, int c2,
                    int n_out, int pad_front, int vec) {
  using L = TcLayout<KT>;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* sW = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  __nv_bfloat16* sX = sW + L::kW;          // [2][side][side][kPix]
  __nv_bfloat16* sO = sX + 2 * L::kHalo;   // [16 * 16][kLd]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int o0 = blockIdx.y * kChunk;

  // the weight chunk, once: sW[tap][c][o] = wk[tap][c][o0 + o], zero past
  // C2 and past O
  for (int i = tid; i < KT * KT * kTcC * kChunk; i += kTcThreads) {
    const int o = i % kChunk;
    const int c = (i / kChunk) % kTcC;
    const int tap = i / (kChunk * kTcC);
    sW[(tap * kTcC + c) * kLd + o] =
        c < c2 && o0 + o < n_out
            ? wk[((long long)tap * c2 + c) * n_out + o0 + o]
            : __float2bfloat16(0.f);
  }
  // this thread's output channels: j * 8 + 2t and + 1 of the chunk
  float bv[kChunk / 8][2];
#pragma unroll
  for (int j = 0; j < kChunk / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int o = o0 + j * 8 + 2 * t + e;
      bv[j][e] = bias != nullptr && o < n_out ? bias[o] : 0.f;
    }

  int tile = blockIdx.x;
  if (tile < n_tiles)
    load_halo<KT>(sX, x, tile_at(tile, tiles_h, tiles_w), h, w, c2,
                  pad_front, vec);
  cp_async_commit();

  // ldmatrix row addresses: A (16 pixels of a row x 16 channels: pixel
  // column, channel half) and B through .trans (16 channels x 16 output
  // channels of the weights: channel row, output column half)
  const int a_px = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_c = (lane >> 4) * 8;
  const int bt_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int bt_col = (lane >> 4) * 8;

  for (int it = 0; tile < n_tiles; ++it, tile += gridDim.x) {
    const int stage = it & 1;
    const TileAt at = tile_at(tile, tiles_h, tiles_w);
    const int next = tile + gridDim.x;
    if (next < n_tiles)  // the next halo's copy overlaps this tile
      load_halo<KT>(sX + (stage ^ 1) * L::kHalo, x,
                    tile_at(next, tiles_h, tiles_w), h, w, c2, pad_front,
                    vec);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* hx = sX + stage * L::kHalo;

    float acc[2][kChunk / 8][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < kChunk / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

#pragma unroll
    for (int dy = 0; dy < KT; ++dy) {
#pragma unroll
      for (int dx = 0; dx < KT; ++dx) {
        const __nv_bfloat16* wt = sW + (dy * KT + dx) * kTcC * kLd;
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldmatrix_x4(a[mt], hx + ((2 * warp + mt + dy) * L::kSide + a_px +
                                   dx) * kPix + a_c);
#pragma unroll
        for (int np = 0; np < kChunk / 16; ++np) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, wt + bt_row * kLd + np * 16 + bt_col);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16_16816(acc[mt][2 * np], a[mt], b[0], b[1]);
            mma_bf16_16816(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
          }
        }
      }
    }

    // the bias in f32, one rounding to bf16, the tile staged pixel-major
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < kChunk / 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int p = (2 * warp + mt) * kTcTile + g + 8 * hf;
          float r0 = acc[mt][j][2 * hf], r1 = acc[mt][j][2 * hf + 1];
          if (bias != nullptr) {
            r0 += bv[j][0];
            r1 += bv[j][1];
          }
          *reinterpret_cast<__nv_bfloat162*>(sO + p * kLd + j * 8 + 2 * t) =
              __floats2bfloat162_rn(r0, r1);
        }
    __syncthreads();
    // 16-byte stores, 8 a pixel: consecutive threads, consecutive bytes
    for (int i = tid; i < kTcTile * kTcTile * (kChunk / 8);
         i += kTcThreads) {
      const int p = i / (kChunk / 8), c = (i % (kChunk / 8)) * 8;
      const int oy = at.y0 + p / kTcTile, ox = at.x0 + p % kTcTile;
      if (oy < h && ox < w && o0 + c < n_out)
        *reinterpret_cast<uint4*>(
            out + (((long long)at.b * h + oy) * w + ox) * n_out + o0 + c) =
            *reinterpret_cast<const uint4*>(sO + p * kLd + c);
    }
  }
  cp_async_wait<0>();
}

template <int KT>
cudaError_t launch_tc(const void* x, const void* wk, const float* bias,
                      void* out, int b, int h, int w, int c2, int n_out,
                      int pad_front, cudaStream_t stream) {
  auto kernel = stem_conv_tc_kernel<KT>;
  constexpr size_t smem = TcLayout<KT>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int tiles_h = (h + kTcTile - 1) / kTcTile;
  const int tiles_w = (w + kTcTile - 1) / kTcTile;
  const long long n_tiles = (long long)b * tiles_h * tiles_w;
  const int chunks = (n_out + kChunk - 1) / kChunk;
  if (n_tiles > 0x7fffffffLL || chunks > 65535) return cudaErrorInvalidValue;
  // persistent blocks: as many as the SMs hold at once, each walking
  // over tiles gridDim.x apart
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kTcThreads, smem)) != cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long blocks = (long long)sms * per_sm;
  const dim3 grid((unsigned)(n_tiles < blocks ? n_tiles : blocks),
                  (unsigned)chunks);
  const int vec = c2 % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 8 == 0;
  using bf16 = __nv_bfloat16;
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wk), bias,
      static_cast<bf16*>(out), (int)n_tiles, tiles_h, tiles_w, h, w, c2,
      n_out, pad_front, vec);
  return cudaGetLastError();
}

cudaError_t launch_tc_kt(int kt, const void* x, const void* wk,
                         const float* bias, void* out, int b, int h, int w,
                         int c2, int n_out, int pad_front, cudaStream_t s) {
  // the 16-byte stores need out 16-byte aligned and O % 8 == 0
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return cudaErrorMisalignedAddress;
  switch (kt) {
    case 2:
      return launch_tc<2>(x, wk, bias, out, b, h, w, c2, n_out, pad_front, s);
    case 4:
      return launch_tc<4>(x, wk, bias, out, b, h, w, c2, n_out, pad_front, s);
    case 6:
      return launch_tc<6>(x, wk, bias, out, b, h, w, c2, n_out, pad_front, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. x [b, h, w, c2] and wk
// [kt, kt, c2, n_out] contiguous, bias contiguous [n_out] float32 (read
// only when has_bias), out contiguous [b, h, w, n_out] in x's dtype, all
// on one device. x and wk both bf16 with n_out % 8 == 0 run the
// tensor-core design, everything else the CUDA-core one. Launches on
// `stream` and does not synchronise. Returns the launch's cudaError_t (0
// on success).
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
    return (int)(n_out % 8 == 0
                     ? launch_tc_kt(kt, x, wk, bp, out, b, h, w, c2, n_out,
                                    pad_front, s)
                     : launch_kt<__nv_bfloat16, __nv_bfloat16>(
                           kt, x, wk, bp, out, b, h, w, c2, n_out,
                           pad_front, s));
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* stem_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
