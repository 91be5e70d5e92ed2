// int8 tensor-core fragments of the int8 conv kernel (csrc/int8_conv.cu):
// `mma.sync.aligned.m16n8k32` with s8 operands and s32 accumulation, the s8
// counterpart of mma_bf16.cuh's m16n8k16.
//
// In 32-bit registers the fragments are those of m16n8k16 bf16, with four
// bytes in a register where bf16 has two: lane = 4 * g + t holds
//   A: a0 = A[g][4t .. 4t+3], a1 = A[g+8][4t ..], a2 = A[g][16+4t ..],
//      a3 = A[g+8][16+4t ..], which is what mma::ldmatrix_x4 gives on a
//      row-major 16 x 32-byte tile (row l % 16, byte offset 16 * (l / 16));
//   B: b0 = B[4t .. 4t+3][g], b1 = B[16+4t .. 16+4t+3][g], packed once on the
//      host in that order (ops/_mma_pack.py:pack_b_s8: for each 32-row K tile,
//      for each pair of 8-column N tiles, for each lane, {b0, b1} of the first
//      N tile and of the second: one 16-byte read a lane feeds two MMAs);
//   D: d0, d1 = D[g][2t], D[g][2t+1]; d2, d3 = D[g+8][2t], D[g+8][2t+1].
#pragma once
#include <stdint.h>

#include "mma_bf16.cuh"

namespace mma {

// d += a (16x32 s8, row) * b (32x8 s8, col), exact in s32.
__device__ __forceinline__ void mma_16832_s8(int (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x -> clip(round_half_even(x / xs), -127, 127): an IEEE division (no
// reciprocal), then a round-to-nearest-even conversion; saturating for
// huge values, as the plain version's clip.
__device__ __forceinline__ int quantize_s8(float x, float xs) {
  const int q = __float2int_rn(__fdiv_rn(x, xs));
  return max(-127, min(127, q));
}

// f32(acc) * scale, then + bias: two rounded operations, never contracted
// into an FMA, so the result equals the plain version's bit for bit.
__device__ __forceinline__ float dequant(int acc, float scale, float bias) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

}  // namespace mma
