// Real-int8 depthwise convolution of the quantized deploy graph: stride 1,
// k in {3, 5, 7, 9}, 'same' padding k / 2 (the UniRepLKNet DW convs of
// MAF-YOLO's RepHDW bottlenecks and heads).
//
// Replaces: the INT8_INFER branch of mafyolo_tpu/models/blocks.py:_RawConv
// (306-321) at feature_group_count = C, an XLA conv with int8 operands and
// int32 accumulation (no Pallas kernel; PyTorch has no int8 convolution on
// the card).
//
// In: activations NHWC [B, H, W, C] in bf16 or f32 with a pixel pitch of
// `ldx` elements (>= C); the per-tensor activation scale xs; the weights
// quantized once on the host (ops/quant_conv.py:pack), int8 [k*k, C]
// tap-major; f32 scale[c] = xs * w_scale[c] and bias[c]. Out: NHWC
// [B, H, W, C] in the input's type,
//   out = bf16/f32( f32(sum_taps q(x) * w_q) * scale[c] + bias[c] )
// with q(x) = clip(round_half_even(x / xs), -127, 127) and ZERO outside the
// image (the halo is staged as 0, never as a quantized neighbour), equal
// bit for bit to ops/quant_conv.py:int8_conv_plain.
//
// Bound on the H100 (data sheet rates): bytes. A site moves its input and
// output once (4 bytes an element in bf16) and does 2 k^2 int8 operations an
// output element: at k = 9 that is about 40 operations a byte, far below the
// 590 at which the int8 tensor cores would be the limit, and DW has no
// reduction over channels for an MMA to use. So the multiply-adds run on
// the CUDA cores in int32:
//
//   * A block of 256 threads owns a 16 x 16 pixel tile of one image for 32
//     channels: it stages the (16 + k - 1)^2 x 32 quantized input bytes
//     with their halo in shared memory (a warp loads one pixel's 32
//     neighbouring channels, 64 bytes in bf16), the k^2 weights of its
//     channel in registers.
//   * Each thread then computes 32 output pixels of its channel, k^2 int32
//     multiply-adds each, from shared memory (lane c reads byte c of a
//     32-byte row: no bank conflicts).
//   * Epilogue: __int2float_rn, __fmul_rn, __fadd_rn, one rounding to the
//     output type.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_s8.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = kThreads / 32;
constexpr int kTile = 16;        // output pixels a side
constexpr int kCh = 32;          // channels a block

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
int8_dw_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ scale, const float* __restrict__ bias,
               T* __restrict__ out, int H, int W, int C, int ldx, float xs) {
  constexpr int P = K / 2, S = kTile + K - 1;
  __shared__ int8_t tile[S * S][kCh];
  const int tiles_x = (W + kTile - 1) / kTile;
  const int y0 = (blockIdx.x / tiles_x) * kTile, x0 = (blockIdx.x % tiles_x) * kTile;
  const int c = threadIdx.x & 31, grp = threadIdx.x >> 5;
  const int ch = blockIdx.y * kCh + c;
  const bool cvalid = ch < C;
  const size_t b = blockIdx.z;

  const T* xb = x + b * H * W * (size_t)ldx;
  for (int i = grp; i < S * S; i += kGroups) {
    const int iy = y0 - P + i / S, ix = x0 - P + i % S;
    int q = 0;
    if (cvalid && iy >= 0 && iy < H && ix >= 0 && ix < W)
      q = mma::quantize_s8(mma::to_f32(xb[((size_t)iy * W + ix) * ldx + ch]), xs);
    tile[i][c] = (int8_t)q;
  }
  int wr[K * K];
#pragma unroll
  for (int i = 0; i < K * K; ++i) wr[i] = cvalid ? (int)w[(size_t)i * C + ch] : 0;
  __syncthreads();
  if (!cvalid) return;

  const float sc = scale[ch], bi = bias[ch];
  T* ob = out + b * H * W * (size_t)C;
  for (int p = grp; p < kTile * kTile; p += kGroups) {
    const int oy = p / kTile, ox = p % kTile;
    if (y0 + oy >= H || x0 + ox >= W) continue;
    int acc = 0;
#pragma unroll
    for (int ky = 0; ky < K; ++ky)
#pragma unroll
      for (int kx = 0; kx < K; ++kx)
        acc += (int)tile[(oy + ky) * S + ox + kx][c] * wr[ky * K + kx];
    mma::store_as(ob + ((size_t)(y0 + oy) * W + x0 + ox) * C + ch, mma::dequant(acc, sc, bi));
  }
}

template <typename T>
int launch(const T* x, const int8_t* w, const float* scale, const float* bias, T* out,
           int B, int H, int W, int C, int ldx, int k, float xs, cudaStream_t stream) {
  const dim3 grid(((H + kTile - 1) / kTile) * ((W + kTile - 1) / kTile),
                  (C + kCh - 1) / kCh, B);
  switch (k) {
    case 3: int8_dw_kernel<T, 3><<<grid, kThreads, 0, stream>>>(x, w, scale, bias, out, H, W, C, ldx, xs); break;
    case 5: int8_dw_kernel<T, 5><<<grid, kThreads, 0, stream>>>(x, w, scale, bias, out, H, W, C, ldx, xs); break;
    case 7: int8_dw_kernel<T, 7><<<grid, kThreads, 0, stream>>>(x, w, scale, bias, out, H, W, C, ldx, xs); break;
    case 9: int8_dw_kernel<T, 9><<<grid, kThreads, 0, stream>>>(x, w, scale, bias, out, H, W, C, ldx, xs); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int int8_dw(const void* x, const void* w, const float* scale, const float* bias,
                       void* out, int B, int H, int W, int C, int ldx, int k, float xs,
                       int bf16, void* stream) {
  if (bf16)
    return launch(static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
                  scale, bias, static_cast<__nv_bfloat16*>(out), B, H, W, C, ldx, k, xs,
                  (cudaStream_t)stream);
  return launch(static_cast<const float*>(x), static_cast<const int8_t*>(w), scale, bias,
                static_cast<float*>(out), B, H, W, C, ldx, k, xs, (cudaStream_t)stream);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
