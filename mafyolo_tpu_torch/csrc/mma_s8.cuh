// Device code the int8 kernels share (csrc/int8_conv.cu, csrc/int8_dw.cu):
// the tensor-core fragments of `mma.sync.aligned.m16n8k32` with s8 operands
// and s32 accumulation (the s8 counterpart of mma_bf16.cuh's m16n8k16), the
// quantize, dequantize and rounding steps of their exactness contract, and
// multiply-shift division.
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

// v rounded to T (round to nearest even), as T and back in f32.
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// Two neighbouring elements, each rounded once to the stored type.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// n / d for 0 <= n < 2^31 and a divisor d >= 1 fixed for a launch, by one
// multiply-high, an add and a shift (Granlund and Montgomery's method): the
// kernels' index arithmetic divides by runtime widths on every element.
struct FastDiv {
  uint32_t m, l;
  int d;
  __device__ __forceinline__ int div(int n) const {
    return (int)((__umulhi(m, (uint32_t)n) + (uint32_t)n) >> l);
  }
  __device__ __forceinline__ int mod(int n, int q) const { return n - q * d; }
};

inline FastDiv make_div(int d) {
  uint32_t l = 0;
  while ((1ull << l) < (unsigned long long)d) ++l;
  const uint64_t m = ((1ull << 32) * ((1ull << l) - (uint64_t)d)) / (uint64_t)d + 1;
  return FastDiv{(uint32_t)m, l, d};
}

// torch's SiLU on the card, x / (1 + exp(-x)) in f32: expf (no fast math)
// and an IEEE division, so that a fused SiLU gives torch's bits.
__device__ __forceinline__ float silu_exact(float x) {
  return __fdiv_rn(x, __fadd_rn(1.0f, expf(-x)));
}

}  // namespace mma
