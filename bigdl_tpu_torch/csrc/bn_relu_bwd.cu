// Fused BatchNorm-affine + ReLU backward for NVIDIA Hopper (sm_90a), over an
// [N, C] matrix. From the forward's input x (f32 or bf16, contiguous), its
// coefficients scale and shift ([C] f32) and the cotangent g (f32 or bf16,
// rows `ldg` elements apart, columns contiguous) it computes, with math in
// f32:
//     pre = cast_to_g_dtype(x * scale + shift)        (relu = 1 only)
//     g32 = f32(pre > 0 ? g : 0)                      (g32 = f32(g) if relu = 0)
//     dx  = g32 * scale                               [N, C] f32, contiguous
//     ds  = sum over the rows of g32 * x              [C]
//     db  = sum over the rows of g32                  [C]
// in one launch.
//
// Replaces the TPU kernel `_bwd_kernel` in bigdl_tpu/ops/bn_relu_kernel.py
// (launched by `bn_relu_backward`). Like it, the pre-activation is
// recomputed here: the forward saves no mask and no pre-activation. The
// multiply and the add of `pre` and the product of dx are single roundings
// (__fmul_rn, __fadd_rn), so the mask and dx are bitwise those of the plain
// PyTorch version on the card; only ds and db are summed in another order.
//
// Inputs as the main path gives them. x is read in its own dtype (the bf16
// activation in bf16 training, not the f32 copy the BN statistics use; the
// upcast is exact, so every output is the same bits either way). g may be a
// channel slice of a wider gradient (a `Concat` branch's share of the
// joined NHWC gradient): it is read in place with its row stride.
//
// Design. The TPU kernel ran its grid in order on one core and left the sum
// over tiles to the caller; here the grid is 2-D, (row tiles) x (column
// groups of at most 64 columns), so a wide C is spread over blocks and a
// short N still fills the card. A block is `group_octets` octet lanes by
// `lanes_y` row lanes (a power of 2). Every thread owns one octet of 8
// neighbouring columns: it walks its row lane's rows of the tile, keeping
// 8 + 8 sums in registers, and moves an octet as 16-byte accesses (x and g
// in bf16 one load each, f32 two; dx two 16-byte stores) when C % 8 == 0
// and every pointer and g's row stride keep 16-byte alignment, else element
// by element, masked at the ragged edge. The row lanes are then added in a
// fixed tree in shared memory and the tile's partial sums written out.
// Each block then takes a ticket (an integer atomic on its column group's
// counter, never a floating-point atomic); the last of the group's tiles
// to finish reads every tile's partials back from L2 and adds them in tile
// order (in 16 runs of consecutive tiles, several loads in flight each,
// then the runs in order), writes
// ds and db, and resets the counter to 0 for the next launch. The caller
// picks the partition from (N, C) alone, so for a given N and C the
// summation order is fixed and two launches give the same bits, whatever
// the dtypes, the alignment and the row stride.
//
// What bounds it. About 7 flops per element against 8 B moved (x and g
// bf16 read, dx f32 written; 10 B with an f32 x): memory bandwidth. The
// partials add 8 B a column a tile, under 1% at every ResNet-50 site.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kOctet = 8;      // columns a thread owns
constexpr int kMaxThreads = 256;
constexpr int kRuns = 16;      // runs of consecutive tiles in the final sum
constexpr int kBatch = 4;      // tiles' partials loaded at once there

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

// s[k] += ds_part and b[k] += db_part of column col + k over tiles
// [t0, t1), in tile order; V = 4 reads 4 columns as one 16-byte load
// (C % 4 == 0), and kBatch tiles' loads of both are in flight at once
template <int V>
__device__ __forceinline__ void sum_run(const float* ds_part,
                                        const float* db_part, long long c,
                                        int col, int t0, int t1,
                                        float (&s)[V], float (&b)[V]) {
  int t = t0;
  for (; t + kBatch <= t1; t += kBatch) {
    float vs[kBatch][V], vb[kBatch][V];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const long long off = (t + u) * c + col;
      if constexpr (V == 4) {
        const float4 q = __ldcg(reinterpret_cast<const float4*>(ds_part + off));
        const float4 r = __ldcg(reinterpret_cast<const float4*>(db_part + off));
        vs[u][0] = q.x; vs[u][1] = q.y; vs[u][2] = q.z; vs[u][3] = q.w;
        vb[u][0] = r.x; vb[u][1] = r.y; vb[u][2] = r.z; vb[u][3] = r.w;
      } else {
        vs[u][0] = __ldcg(ds_part + off);
        vb[u][0] = __ldcg(db_part + off);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
#pragma unroll
      for (int k = 0; k < V; ++k) {
        s[k] = __fadd_rn(s[k], vs[u][k]);
        b[k] = __fadd_rn(b[k], vb[u][k]);
      }
  }
  for (; t < t1; ++t)
#pragma unroll
    for (int k = 0; k < V; ++k) {
      s[k] = __fadd_rn(s[k], __ldcg(ds_part + t * c + col + k));
      b[k] = __fadd_rn(b[k], __ldcg(db_part + t * c + col + k));
    }
}

// the value a float takes once stored in T (round to nearest even)
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// WIDE: C % 8 == 0 and x, g (with its row stride) and dx 16-byte aligned,
// so every octet is whole and moves as 16-byte accesses
template <typename Tx, typename Tg, bool RELU, bool WIDE>
__global__ void __launch_bounds__(kMaxThreads, 4)
bn_relu_bwd_kernel(const Tx* __restrict__ x, const float* __restrict__ scale,
                   const float* __restrict__ shift, const Tg* __restrict__ g,
                   long long ldg, float* __restrict__ dx, float* ds_part,
                   float* db_part,
                   float* __restrict__ ds, float* __restrict__ db,
                   unsigned int* __restrict__ tickets, long long n_rows,
                   int c, int tile_rows, int n_tiles) {
  // [kOctet][threads] each: a column of the octet, then the thread
  __shared__ float red_s[kOctet * kMaxThreads], red_b[kOctet * kMaxThreads];
  __shared__ bool last;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int lanes_x = blockDim.x, lanes_y = blockDim.y;
  const int col0 = (blockIdx.y * lanes_x + tx) * kOctet;
  float as[kOctet], ab[kOctet];
#pragma unroll
  for (int k = 0; k < kOctet; ++k) as[k] = ab[k] = 0.f;

  if (col0 < c) {
    float s[kOctet], b[kOctet];
#pragma unroll
    for (int k = 0; k < kOctet; ++k) {
      const bool in = WIDE || col0 + k < c;
      s[k] = in ? __ldg(scale + col0 + k) : 0.f;
      b[k] = in ? __ldg(shift + col0 + k) : 0.f;
    }
    const long long r0 = (long long)blockIdx.x * tile_rows;
    const long long r1 = min(r0 + tile_rows, n_rows);
#pragma unroll(WIDE ? 4 : 1)
    for (long long r = r0 + ty; r < r1; r += lanes_y) {
      float xv[kOctet], gv[kOctet];
      if (WIDE) {
        load8(x + r * c + col0, xv);
        load8(g + r * ldg + col0, gv);
      } else {
#pragma unroll
        for (int k = 0; k < kOctet; ++k) {
          const bool in = col0 + k < c;
          xv[k] = in ? to_f32(x[r * c + col0 + k]) : 0.f;
          gv[k] = in ? to_f32(g[r * ldg + col0 + k]) : 0.f;
        }
      }
#pragma unroll
      for (int k = 0; k < kOctet; ++k) {
        if (RELU) {
          const float pre = round_to(__fadd_rn(__fmul_rn(xv[k], s[k]), b[k]),
                                     static_cast<const Tg*>(nullptr));
          if (!(pre > 0.f)) gv[k] = 0.f;
        }
        as[k] = __fadd_rn(as[k], __fmul_rn(gv[k], xv[k]));
        ab[k] = __fadd_rn(ab[k], gv[k]);
        gv[k] = __fmul_rn(gv[k], s[k]);  // dx
      }
      float* d = dx + r * c + col0;
      if (WIDE) {
        *reinterpret_cast<float4*>(d) = make_float4(gv[0], gv[1], gv[2], gv[3]);
        *reinterpret_cast<float4*>(d + 4) =
            make_float4(gv[4], gv[5], gv[6], gv[7]);
      } else {
#pragma unroll
        for (int k = 0; k < kOctet; ++k)
          if (col0 + k < c) d[k] = gv[k];
      }
    }
  }

  // the row lanes' sums, added in a fixed tree: row lane i takes row lane
  // i + stride (neighbouring threads on neighbouring words: no bank
  // conflict)
  const int tid = ty * lanes_x + tx, threads = lanes_x * lanes_y;
#pragma unroll
  for (int k = 0; k < kOctet; ++k) {
    red_s[k * threads + tid] = as[k];
    red_b[k * threads + tid] = ab[k];
  }
  for (int stride = lanes_y / 2; stride > 0; stride /= 2) {
    __syncthreads();
    if (ty < stride) {
      const int other = tid + stride * lanes_x;
#pragma unroll
      for (int k = 0; k < kOctet; ++k) {
        as[k] = __fadd_rn(as[k], red_s[k * threads + other]);
        ab[k] = __fadd_rn(ab[k], red_b[k * threads + other]);
        red_s[k * threads + tid] = as[k];
        red_b[k * threads + tid] = ab[k];
      }
    }
  }
  if (ty == 0 && col0 < c) {
    const long long part = (long long)blockIdx.x * c + col0;
#pragma unroll
    for (int k = 0; k < kOctet; ++k)
      if (col0 + k < c) {
        ds_part[part + k] = as[k];
        db_part[part + k] = ab[k];
      }
    __threadfence();  // the partials before the ticket
  }

  // the last tile of this column group to finish adds every tile's partials
  __syncthreads();
  if (tx == 0 && ty == 0)
    last = atomicAdd(tickets + blockIdx.y, 1u) == (unsigned)(n_tiles - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int gcols = lanes_x * kOctet, cbase = blockIdx.y * gcols;
  const int run = (n_tiles + kRuns - 1) / kRuns;
  // WIDE: C % 8 == 0, so 4 columns of a tile's partials are one 16-byte load
  constexpr int V = WIDE ? 4 : 1;
  const int lanes = gcols / V;
  for (int item = tid; item < kRuns * lanes; item += threads) {
    const int i = item / lanes, j = (item - i * lanes) * V, col = cbase + j;
    float s[V], b[V];
#pragma unroll
    for (int k = 0; k < V; ++k) s[k] = b[k] = 0.f;
    if (col < c) {
      const int t0 = min(i * run, n_tiles), t1 = min(t0 + run, n_tiles);
      sum_run<V>(ds_part, db_part, c, col, t0, t1, s, b);
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      red_s[i * gcols + j + k] = s[k];
      red_b[i * gcols + j + k] = b[k];
    }
  }
  __syncthreads();
  for (int j = tid; j < gcols; j += threads) {
    const int col = cbase + j;
    if (col >= c) continue;
    float s = 0.f, b = 0.f;
#pragma unroll
    for (int i = 0; i < kRuns; ++i) {
      s = __fadd_rn(s, red_s[i * gcols + j]);
      b = __fadd_rn(b, red_b[i * gcols + j]);
    }
    ds[col] = s;
    db[col] = b;
  }
  if (tid == 0) tickets[blockIdx.y] = 0u;
}

template <typename Tx, typename Tg>
cudaError_t launch(const void* x, const void* scale, const void* shift,
                   const void* g, long long ldg, void* dx, void* ds_part,
                   void* db_part, void* ds, void* db, void* tickets,
                   long long n_rows, int c, int group_octets, int lanes_y,
                   int tile_rows, int n_tiles, int relu,
                   cudaStream_t stream) {
  const bool wide = c % kOctet == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                    (ldg * (long long)sizeof(Tg)) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  const int octets = (c + kOctet - 1) / kOctet;
  const int groups = (octets + group_octets - 1) / group_octets;
  const dim3 grid((unsigned)n_tiles, (unsigned)groups),
      block(group_octets, lanes_y);
  const Tx* xp = static_cast<const Tx*>(x);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(shift);
  const Tg* gp = static_cast<const Tg*>(g);
  float* dxp = static_cast<float*>(dx);
  float* dsp = static_cast<float*>(ds_part);
  float* dbp = static_cast<float*>(db_part);
  float* dso = static_cast<float*>(ds);
  float* dbo = static_cast<float*>(db);
  unsigned int* tk = static_cast<unsigned int*>(tickets);
#define BN_BWD_LAUNCH(R, W)                                                  \
  bn_relu_bwd_kernel<Tx, Tg, R, W><<<grid, block, 0, stream>>>(              \
      xp, sp, bp, gp, ldg, dxp, dsp, dbp, dso, dbo, tk, n_rows, c, tile_rows, \
      n_tiles)
  if (relu) {
    if (wide) BN_BWD_LAUNCH(true, true);
    else BN_BWD_LAUNCH(true, false);
  } else {
    if (wide) BN_BWD_LAUNCH(false, true);
    else BN_BWD_LAUNCH(false, false);
  }
#undef BN_BWD_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. x is contiguous [n_rows, c]; g is
// [n_rows, c] with unit column stride and rows ldg >= c elements apart;
// scale and shift contiguous [c] float32; dx contiguous [n_rows, c] float32;
// ds_part and db_part contiguous [n_tiles, c] float32 scratch; ds and db
// [c] float32; tickets one unsigned int a column group
// (ceil(ceil(c / 8) / group_octets) of them), all 0 before the launch and
// left 0 after it; all on one device. A block is group_octets x lanes_y
// threads (at most 256, lanes_y a power of 2, group_octets at most 32),
// each owning 8 columns; tile
// t covers rows [t * tile_rows, min((t + 1) * tile_rows, n_rows)), and
// n_tiles * tile_rows must cover n_rows. Launches on `stream` and does not
// synchronise; two launches that share `tickets` must not run at once.
// Returns the launch's cudaError_t (0 on success).
extern "C" int bn_relu_bwd(const void* x, const void* scale,
                           const void* shift, const void* g, long long ldg,
                           void* dx, void* ds_part, void* db_part, void* ds,
                           void* db, void* tickets, long long n_rows, int c,
                           int group_octets, int lanes_y, int tile_rows,
                           int n_tiles, int x_dtype, int g_dtype, int relu,
                           void* stream) {
  if (n_rows < 1 || c < 1 || ldg < c || group_octets < 1 || lanes_y < 1 ||
      (lanes_y & (lanes_y - 1)) != 0 ||
      group_octets * lanes_y > kMaxThreads ||
      group_octets * kRuns > kMaxThreads || tile_rows < 1 || n_tiles < 1 ||
      (long long)n_tiles * tile_rows < n_rows ||
      (long long)(n_tiles - 1) * tile_rows >= n_rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && g_dtype == 0)
    return (int)launch<float, float>(x, scale, shift, g, ldg, dx, ds_part,
                                     db_part, ds, db, tickets, n_rows, c,
                                     group_octets, lanes_y, tile_rows,
                                     n_tiles, relu, s);
  if (x_dtype == 0 && g_dtype == 1)
    return (int)launch<float, __nv_bfloat16>(
        x, scale, shift, g, ldg, dx, ds_part, db_part, ds, db, tickets,
        n_rows, c, group_octets, lanes_y, tile_rows, n_tiles, relu, s);
  if (x_dtype == 1 && g_dtype == 0)
    return (int)launch<__nv_bfloat16, float>(
        x, scale, shift, g, ldg, dx, ds_part, db_part, ds, db, tickets,
        n_rows, c, group_octets, lanes_y, tile_rows, n_tiles, relu, s);
  if (x_dtype == 1 && g_dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(
        x, scale, shift, g, ldg, dx, ds_part, db_part, ds, db, tickets,
        n_rows, c, group_octets, lanes_y, tile_rows, n_tiles, relu, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* bn_relu_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
