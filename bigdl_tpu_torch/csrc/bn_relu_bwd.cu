// Fused BatchNorm-affine + ReLU backward for NVIDIA Hopper (sm_90a), over a
// contiguous [N, C] row-major matrix. From the forward's input x (f32 or
// bf16), its coefficients scale and shift ([C] f32) and the cotangent g
// (f32 or bf16) it computes, with math in f32:
//     pre = cast_to_g_dtype(x * scale + shift)        (relu = 1 only)
//     g32 = f32(pre > 0 ? g : 0)                      (g32 = f32(g) if relu = 0)
//     dx  = g32 * scale                               [N, C] f32
//     ds_part[t, :] = sum over the rows of tile t of g32 * x   [n_tiles, C]
//     db_part[t, :] = sum over the rows of tile t of g32       [n_tiles, C]
// The caller sums the partials over tiles into dscale and dshift.
//
// Replaces the TPU kernel `_bwd_kernel` in bigdl_tpu/ops/bn_relu_kernel.py
// (launched by `bn_relu_backward`). Like it, the pre-activation is
// recomputed here: the forward saves no mask and no pre-activation. The
// multiply and the add of `pre` and the product of dx are single roundings
// (__fmul_rn, __fadd_rn), so the mask and dx are bitwise those of the plain
// PyTorch version on the card; only the partial sums are summed in another
// order.
//
// Design. The TPU kernel ran its grid in order on one core; here tiles run
// in parallel, so each block owns one tile of `tile_n` rows and writes that
// tile's partial sums, with no atomics. A block is 32 column lanes x 8 row
// lanes: a warp reads 32 neighbouring columns of one row (coalesced), and
// each thread walks its column down every 8th row of the tile, keeping its
// two sums in registers. The 8 row lanes are then added in shared memory
// in a fixed order. The caller picks tile_n from (N, C) alone, so for a
// given N and C the summation order is fixed and two runs give the same
// dscale and dshift bit for bit. Ragged N and C are masked here.
//
// What bounds it. About 4 flops per element against 10 B moved (x f32 and
// g bf16 read, dx f32 written): memory bandwidth. This first version uses
// scalar (4 B and 2 B) loads; wider accesses are a later optimisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanesX = 32;  // columns per pass
constexpr int kLanesY = 8;   // row lanes

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// the value a float takes once stored in T (round to nearest even)
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename Tx, typename Tg, bool RELU>
__global__ void __launch_bounds__(kLanesX * kLanesY)
bn_relu_bwd_kernel(const Tx* __restrict__ x, const float* __restrict__ scale,
                   const float* __restrict__ shift, const Tg* __restrict__ g,
                   float* __restrict__ dx, float* __restrict__ ds_part,
                   float* __restrict__ db_part, long long n_rows, int c,
                   int tile_n) {
  __shared__ float s_ds[kLanesY][kLanesX + 1];
  __shared__ float s_db[kLanesY][kLanesX + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long long row0 = (long long)blockIdx.x * tile_n;
  const long long row_end = min(row0 + tile_n, n_rows);
  for (int c0 = 0; c0 < c; c0 += kLanesX) {
    const int col = c0 + tx;
    float acc_ds = 0.f, acc_db = 0.f;
    if (col < c) {
      const float s = __ldg(scale + col);
      const float b = __ldg(shift + col);
#pragma unroll 4
      for (long long r = row0 + ty; r < row_end; r += kLanesY) {
        const long long off = r * c + col;
        const float xv = to_f32(x[off]);
        float gv = to_f32(g[off]);
        if (RELU) {
          const float pre = round_to(__fadd_rn(__fmul_rn(xv, s), b), g);
          if (!(pre > 0.f)) gv = 0.f;
        }
        dx[off] = __fmul_rn(gv, s);
        acc_ds = __fadd_rn(acc_ds, __fmul_rn(gv, xv));
        acc_db = __fadd_rn(acc_db, gv);
      }
    }
    s_ds[ty][tx] = acc_ds;
    s_db[ty][tx] = acc_db;
    __syncthreads();
    if (ty == 0 && col < c) {
      float ds = 0.f, db = 0.f;
#pragma unroll
      for (int k = 0; k < kLanesY; ++k) {
        ds = __fadd_rn(ds, s_ds[k][tx]);
        db = __fadd_rn(db, s_db[k][tx]);
      }
      const long long part = (long long)blockIdx.x * c + col;
      ds_part[part] = ds;
      db_part[part] = db;
    }
    __syncthreads();  // the next pass reuses s_ds / s_db
  }
}

template <typename Tx, typename Tg>
cudaError_t launch(const void* x, const void* scale, const void* shift,
                   const void* g, void* dx, void* ds_part, void* db_part,
                   long long n_rows, int c, int tile_n, int relu,
                   cudaStream_t stream) {
  const long long tiles = (n_rows + tile_n - 1) / tile_n;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles), block(kLanesX, kLanesY);
  const Tx* xp = static_cast<const Tx*>(x);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(shift);
  const Tg* gp = static_cast<const Tg*>(g);
  float* dxp = static_cast<float*>(dx);
  float* dsp = static_cast<float*>(ds_part);
  float* dbp = static_cast<float*>(db_part);
  if (relu)
    bn_relu_bwd_kernel<Tx, Tg, true><<<grid, block, 0, stream>>>(
        xp, sp, bp, gp, dxp, dsp, dbp, n_rows, c, tile_n);
  else
    bn_relu_bwd_kernel<Tx, Tg, false><<<grid, block, 0, stream>>>(
        xp, sp, bp, gp, dxp, dsp, dbp, n_rows, c, tile_n);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. x and g are contiguous
// [n_rows, c]; scale and shift contiguous [c] float32; dx contiguous
// [n_rows, c] float32; ds_part and db_part contiguous
// [ceil(n_rows / tile_n), c] float32; all on one device. Launches on
// `stream` and does not synchronise. Returns the launch's cudaError_t
// (0 on success).
extern "C" int bn_relu_bwd(const void* x, const void* scale,
                           const void* shift, const void* g, void* dx,
                           void* ds_part, void* db_part, long long n_rows,
                           int c, int tile_n, int x_dtype, int g_dtype,
                           int relu, void* stream) {
  if (n_rows < 1 || c < 1 || tile_n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && g_dtype == 0)
    return (int)launch<float, float>(x, scale, shift, g, dx, ds_part, db_part,
                                     n_rows, c, tile_n, relu, s);
  if (x_dtype == 0 && g_dtype == 1)
    return (int)launch<float, __nv_bfloat16>(x, scale, shift, g, dx, ds_part,
                                             db_part, n_rows, c, tile_n, relu,
                                             s);
  if (x_dtype == 1 && g_dtype == 0)
    return (int)launch<__nv_bfloat16, float>(x, scale, shift, g, dx, ds_part,
                                             db_part, n_rows, c, tile_n, relu,
                                             s);
  if (x_dtype == 1 && g_dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(
        x, scale, shift, g, dx, ds_part, db_part, n_rows, c, tile_n, relu, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* bn_relu_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
