// Warp-level bf16 tensor-core helpers for Hopper (sm_90a), shared by the
// kernels whose bf16 design runs its products on the tensor cores: the
// flash-attention forward and backward (flash_attention_fwd.cu,
// flash_attention_bwd_dq.cu, flash_attention_bwd_dkv.cu) and the
// space-to-depth stem (stem_conv.cu):
//
//   ldmatrix_x4 / ldmatrix_x4_trans   four 8x8 b16 matrices from shared
//                                     memory into the mma fragment layout
//   mma_bf16_16816                    D += A B, m16n8k16, bf16 in, f32 out
//   cp_async_16 / _8 / _4             asynchronous global -> shared copies
//                                     that zero-fill when the source is
//                                     out of range; commit / wait
//   split_bf16x2, c_to_a_split        f32 -> bf16 hi + bf16 lo, and two
//                                     m16n8 f32 accumulator tiles repacked
//                                     into one m16k16 A fragment (hi, lo)
//   load_rows, aligned16              rows of a [n, d] bf16 matrix into a
//                                     padded shared tile (the flash
//                                     kernels' operand loads)
//
// Fragment layout of mma.m16n8k16 (lane = 4 * g + t, g = lane / 4,
// t = lane % 4; each 32-bit register holds two bf16, the lower column in
// the lower half):
//   A (16 x 16, row-major):  a0 = (g, 2t..2t+1)   a1 = (g+8, 2t..2t+1)
//                            a2 = (g, 2t+8..+9)   a3 = (g+8, 2t+8..+9)
//   B (16 x 8, k x n):       b0 = (k 2t..2t+1, n g)  b1 = (k 2t+8..+9, n g)
//   C (16 x 8, f32):         c0, c1 = (g, 2t..2t+1)  c2, c3 = (g+8, ...)
// So the C tiles of columns 0-7 and 8-15 of a row block are, element for
// element, the A fragment of a 16-deep step over those columns: the
// product of a softmax tile with the next operand needs no shared memory.
//
// Included by exactly one translation unit of each kernel library, hence
// the anonymous namespace.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// r[i] <- matrix i, whose 8 row addresses come from lanes 8i .. 8i+7:
// lane l receives row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row)));
}

// The same, transposed: lane l receives rows 2 (l % 4) and 2 (l % 4) + 1
// of column l / 4 (a B fragment out of a row-major [k][n] tile).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row)));
}

// d += a b: a is a 16x16 bf16 A fragment, (b0, b1) a 16x8 B fragment.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid (the
// source is then not read, but must still be a mapped address).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}

// 8 bytes global -> shared, asynchronously; zeros when !valid.
__device__ __forceinline__ void cp_async_8(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :
               : "r"(smem_u32(dst)), "l"(src), "r"(valid ? 8 : 0));
}

// 4 bytes global -> shared, asynchronously; zeros when !valid.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :
               : "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x0, x1) -> hi = bf16(x), lo = bf16(x - hi), packed in pairs. hi + lo
// carries x to about 2^-17 of |x|, where hi alone carries it to 2^-9.
__device__ __forceinline__ void split_bf16x2(float x0, float x1,
                                             uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// Two m16n8 f32 accumulator tiles (columns 0-7 in c0, 8-15 in c1) as one
// m16k16 A fragment, split into its bf16 high and low halves.
__device__ __forceinline__ void c_to_a_split(const float (&c0)[4],
                                             const float (&c1)[4],
                                             uint32_t (&hi)[4],
                                             uint32_t (&lo)[4]) {
  split_bf16x2(c0[0], c0[1], hi[0], lo[0]);
  split_bf16x2(c0[2], c0[3], hi[1], lo[1]);
  split_bf16x2(c1[0], c1[1], hi[2], lo[2]);
  split_bf16x2(c1[2], c1[3], hi[3], lo[3]);
}

constexpr float kLog2e = 1.4426950408889634f;

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// rows row0 .. row0 + R - 1 of a [n, d] bf16 matrix into a [R][DMAX + 8]
// shared tile, by a block of THREADS threads; rows >= n and columns >= d
// become 0. 16-byte cp.async copies when `vec` (d % 8 == 0 and src
// 16-byte aligned; the caller commits and waits), element copies
// otherwise.
template <int R, int DMAX, int THREADS>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          int row0, int n, int d, bool vec) {
  constexpr int LD = DMAX + 8;
  if (vec) {
    constexpr int kChunks = DMAX / 8;
    for (int i = threadIdx.x; i < R * kChunks; i += THREADS) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const bool ok = row0 + r < n && c < d;
      cp_async_16(dst + r * LD + c,
                  ok ? src + (int64_t)(row0 + r) * d + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < R * DMAX; i += THREADS) {
      const int r = i / DMAX, c = i % DMAX;
      dst[r * LD + c] = row0 + r < n && c < d
                            ? src[(int64_t)(row0 + r) * d + c]
                            : __float2bfloat16(0.f);
    }
  }
}

}  // namespace
