// Real-int8 dense convolution (groups 1) of the quantized deploy graph:
// 1x1 stride 1 and 3x3 stride 2 in MAF-YOLO, any k, stride and pad here.
//
// Replaces: the INT8_INFER branch of mafyolo_tpu/models/blocks.py:_RawConv
// (306-321), an XLA conv with int8 operands and int32 accumulation (no
// Pallas kernel; PyTorch has no int8 convolution on the card).
//
// In: activations NHWC [B, H, W, C] in bf16 or f32 with a pixel pitch of
// `ldx` elements (>= C: a channel slice of a wider tensor reads in place);
// the per-tensor activation scale xs; the weights quantized and packed once
// on the host (ops/quant_conv.py:pack): int8 [K, O], K = (ky, kx, c)
// padded to Kp (a multiple of 32), in mma.m16n8k32 fragment order
// (csrc/mma_s8.cuh); f32 scale[o] = xs * w_scale[o] and bias[o].
// Out: NHWC [B, Ho, Wo, O] in the input's type,
//   out = bf16/f32( f32(sum_k q(x) * w_q) * scale[o] + bias[o] )
// with q(x) = clip(round_half_even(x / xs), -127, 127) and zeros outside
// the image, equal bit for bit to ops/quant_conv.py:int8_conv_plain.
//
// Bound on the H100 (data sheet rates): at N's sites in bs32@640 the
// arithmetic is 2 * M * K * O int8 operations against 1979 TOP/s and the
// bytes are the activations in and out plus the weights at 3.35 TB/s; most
// 1x1 sites have K, O <= 128 and are bound by bytes. The design is a first
// one, right before fast:
//
//   * One GEMM: rows are output pixels, K the taps, columns the output
//     channels. A block of 128 threads owns 64 pixels by 64 channels; each
//     warp 16 pixels by the 64 channels, as 8 m16n8k32 MMAs a K step.
//   * Quantize on load: a thread builds 16 bytes of a pixel's K row (one
//     16-byte word of shared memory), from two (bf16) or four (f32) 16-byte
//     loads where C is a multiple of 16 and the pitch and base are
//     aligned, else element by element walking (ky, kx, c). The tile's rows
//     are 48 bytes apart, so that ldmatrix reads them without bank
//     conflicts.
//   * B fragments straight from device memory (one 16-byte read a lane
//     feeds two MMAs; the weights of a conv stay in L1/L2).
//   * Epilogue from registers: __int2float_rn, __fmul_rn, __fadd_rn, one
//     rounding to the output type.
// Not done yet (a later PR): double-buffered staging, wgmma, TMA, and
// fusing the activation that follows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_s8.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBM = 64;          // output pixels a block
constexpr int kBN = 64;          // output channels a block
constexpr int kBK = 32;          // K bytes a step
constexpr int kPitch = 48;       // bytes between staged rows

// 16 consecutive elements at p (16-byte aligned) -> their quantized bytes.
template <typename T>
__device__ __forceinline__ void load16_vec(const T* p, float xs, uint32_t (&w)[4]);

template <>
__device__ __forceinline__ void load16_vec(const __nv_bfloat16* p, float xs,
                                           uint32_t (&w)[4]) {
  const uint4* v = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float f[8];
    mma::unpack8(v[h], f);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        word |= (uint32_t)(mma::quantize_s8(f[4 * i + j], xs) & 0xff) << (8 * j);
      w[2 * h + i] = word;
    }
  }
}

template <>
__device__ __forceinline__ void load16_vec(const float* p, float xs, uint32_t (&w)[4]) {
  const float4* v = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 f = v[i];
    w[i] = (uint32_t)(mma::quantize_s8(f.x, xs) & 0xff) |
           (uint32_t)(mma::quantize_s8(f.y, xs) & 0xff) << 8 |
           (uint32_t)(mma::quantize_s8(f.z, xs) & 0xff) << 16 |
           (uint32_t)(mma::quantize_s8(f.w, xs) & 0xff) << 24;
  }
}

struct Geo {
  int B, H, W, C, ldx, Ho, Wo, O, k, stride, pad, K, Kp;
  float xs;
  bool vec;        // C % 16 == 0 and every 16-element run is 16-byte aligned
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
int8_conv_kernel(const T* __restrict__ x, const uint4* __restrict__ wfrag,
                 const float* __restrict__ scale, const float* __restrict__ bias,
                 T* __restrict__ out, Geo g) {
  __shared__ __align__(16) int8_t sa[kBM * kPitch];
  const int M = g.B * g.Ho * g.Wo;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int npairs = (g.O + 15) >> 4;

  // this thread's staged row (pixel) and the half of the K step it builds
  const int r = threadIdx.x >> 1, kh = (threadIdx.x & 1) * 16;
  const int m = m0 + r;
  const bool mvalid = m < M;
  int b = 0, oy = 0, ox = 0;
  if (mvalid) {
    b = m / (g.Ho * g.Wo);
    const int rem = m - b * g.Ho * g.Wo;
    oy = rem / g.Wo;
    ox = rem - oy * g.Wo;
  }
  const int iy0 = oy * g.stride - g.pad, ix0 = ox * g.stride - g.pad;
  const T* xb = x + (size_t)b * g.H * g.W * g.ldx;

  int acc[kBN / 8][4];
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0;

  const uint32_t a_addr = mma::smem_u32(sa + (16 * warp + (lane & 15)) * kPitch +
                                        16 * (lane >> 4));
  for (int k0 = 0; k0 < g.Kp; k0 += kBK) {
    // ---- stage 16 quantized bytes of row r: K indices kk .. kk + 15
    uint32_t words[4] = {0u, 0u, 0u, 0u};
    const int kk = k0 + kh;
    if (mvalid && kk < g.K) {
      const int tap = kk / g.C;
      int c = kk - tap * g.C;
      int ky = tap / g.k, kx = tap - ky * g.k;
      if (g.vec) {   // one tap, 16 aligned channels
        const int iy = iy0 + ky, ix = ix0 + kx;
        if (iy >= 0 && iy < g.H && ix >= 0 && ix < g.W)
          load16_vec(xb + ((size_t)iy * g.W + ix) * g.ldx + c, g.xs, words);
      } else {
#pragma unroll 4
        for (int j = 0; j < 16; ++j) {
          int q = 0;
          const int iy = iy0 + ky, ix = ix0 + kx;
          if (kk + j < g.K && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W)
            q = mma::quantize_s8(mma::to_f32(xb[((size_t)iy * g.W + ix) * g.ldx + c]), g.xs);
          words[j >> 2] |= (uint32_t)(q & 0xff) << (8 * (j & 3));
          if (++c == g.C) {
            c = 0;
            if (++kx == g.k) {
              kx = 0;
              ++ky;
            }
          }
        }
      }
    }
    *reinterpret_cast<uint4*>(sa + r * kPitch + kh) =
        make_uint4(words[0], words[1], words[2], words[3]);
    __syncthreads();

    // ---- 16 pixels x 64 channels a warp
    uint32_t a[4];
    mma::ldmatrix_x4(a, a_addr);
    const uint4* bk = wfrag + (size_t)(k0 / kBK) * npairs * 32 + lane;
#pragma unroll
    for (int j = 0; j < kBN / 16; ++j) {
      const int pair = (n0 >> 4) + j;
      if (pair < npairs) {
        const uint4 bb = bk[pair * 32];
        mma::mma_16832_s8(acc[2 * j], a, bb.x, bb.y);
        mma::mma_16832_s8(acc[2 * j + 1], a, bb.z, bb.w);
      }
    }
    __syncthreads();
  }

  // ---- epilogue: rows g and g + 8 of the warp's 16, columns 2t, 2t + 1
  const int gr = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + 16 * warp + gr + 8 * h;
    if (row >= M) continue;
    T* orow = out + (size_t)row * g.O;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + 8 * j + 2 * t + e;
        if (col < g.O)
          mma::store_as(orow + col, mma::dequant(acc[j][2 * h + e], scale[col], bias[col]));
      }
    }
  }
}

}  // namespace

extern "C" int int8_conv(const void* x, const void* wfrag, const float* scale,
                         const float* bias, void* out, int B, int H, int W, int C,
                         int ldx, int Ho, int Wo, int O, int k, int stride, int pad,
                         int Kp, float xs, int bf16, void* stream) {
  const size_t esize = bf16 ? 2 : 4;
  Geo g{B, H, W, C, ldx, Ho, Wo, O, k, stride, pad, k * k * C, Kp, xs, false};
  g.vec = C % 16 == 0 && (ldx * esize) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int M = B * Ho * Wo;
  const dim3 grid((M + kBM - 1) / kBM, (O + kBN - 1) / kBN);
  if (bf16)
    int8_conv_kernel<__nv_bfloat16><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const uint4*>(wfrag), scale,
        bias, static_cast<__nv_bfloat16*>(out), g);
  else
    int8_conv_kernel<float><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const float*>(x), static_cast<const uint4*>(wfrag), scale, bias,
        static_cast<float*>(out), g);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
