// bf16 tensor-core fragments shared by the front-end, neck and stem kernels:
// `ldmatrix` for the A operand (activations, row-major in shared memory),
// `mma.sync.aligned.m16n8k16` with f32 accumulation (bf16 operands; fp16
// for the stem, whose byte inputs and scaled weights want its 11 bits), and
// the bf16 pack helpers of the epilogues.
//
// The B operand (weights) is packed once on the host in the order the
// fragments are read (ops/_mma_pack.py:pack_b): for each 16-row K tile, for
// each pair of 8-column N tiles, for each lane, four 32-bit registers
//   {b0, b1 of the first N tile, b0, b1 of the second},
// where lane = 4 * g + t holds column g of its N tile and
//   b0 = (B[2t][g], B[2t + 1][g]),  b1 = (B[2t + 8][g], B[2t + 9][g]).
// So one 16-byte read a lane (512 bytes a warp, coalesced) feeds two MMAs
// with no transposition in the kernel: straight from device memory (the
// front-end, whose weights stay in L1) or from a staged copy of the block's
// fragments in shared memory (the neck GEMM).
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

namespace mma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices. Lane l gives the 16-byte row address of row
// (l % 8) of matrix (l / 8). With row = l % 16 and k offset = 8 * (l / 16)
// of a row-major 16x16 tile, the four registers are the A fragment of
// m16n8k16: (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15),
// (rows 8-15, k 8-15).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col); d: rows g and g + 8, columns 2t, 2t+1
// as {d0, d1} and {d2, d3}.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The same with fp16 operands (fragment layouts are those of bf16).
__device__ __forceinline__ void mma_16816_f16(float (&d)[4], const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One K tile of a warp tile of MT x 16 rows by NP x 16 columns: `a_addr[i]`
// is this lane's ldmatrix address for M tile i at this K tile, `b` this
// lane's fragment of the first N-tile pair at this K tile (shared memory),
// pairs 32 uint4 apart; only the first `npv` pairs are computed
// (warp-uniform).
template <int MT, int NP>
__device__ __forceinline__ void mma_ktile(float (&acc)[MT][2 * NP][4],
                                          const uint32_t (&a_addr)[MT], const uint4* b,
                                          int npv) {
  uint32_t a[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) ldmatrix_x4(a[i], a_addr[i]);
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    if (j < npv) {
      const uint4 bb = b[j * 32];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        mma_16816(acc[i][2 * j], a[i], bb.x, bb.y);
        mma_16816(acc[i][2 * j + 1], a[i], bb.z, bb.w);
      }
    }
  }
}

// x * sigmoid(x) = 0.5 x (1 + tanh(x / 2)) with the hardware tanh: one
// special-function instruction instead of an exponential and a divide. Its
// relative error is about 2^-11, under the bf16 rounding (2^-9) that every
// caller applies to the result.
__device__ __forceinline__ float silu(float x) {
  const float h = 0.5f * x;
  float th;
  asm("tanh.approx.f32 %0, %1;" : "=f"(th) : "f"(h));
  return fmaf(h, th, h);
}

__device__ __forceinline__ uint32_t pack_bf162(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void store_bf162(__nv_bfloat16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

// 8 bf16 (one 16-byte word) <-> 8 floats.
__device__ __forceinline__ void unpack8(uint4 v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

// 16-byte asynchronous copy global -> shared; `valid` false writes zeros
// (the source is then not read, but must still be an address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace mma
