// Stem conv: deploy layer 0 of the MAF graphs, relu(conv3x3/s2(rgb(u8)/255) + b).
//
// Replaces: mafyolo_tpu/ops/stem_pallas.py:stem_conv_s2 (_stem_kernel).
//
// Input uint8 BGR NHWC [B, H, W, 3] as the loader gives it (H, W even);
// weights f32 [3, 3, 3, O] HWIO with the input-channel axis in BGR order and
// /255 folded in, then the bias [O] (ops/stem.py:stem_build). Output NHWC
// [B, H/2, W/2, O] in f32 or bf16:
//   out[b, y, x, o] = relu(bias[o] + sum_{dy,dx,c} in[b, 2y+dy-1, 2x+dx-1, c]
//                                                  * w[dy, dx, c, o])
// with zeros read outside the image: output row/col 0 reads input row/col -1
// (the rolled-and-masked tap of stem_pallas.py:84-86); with H and W even the
// bottom and right taps are always inside.
//
// One thread computes one output pixel for a run of 8 output channels, in
// f32, from the 27 input bytes it reads straight from device memory; the
// 28*O weights sit in shared memory. Consecutive threads own consecutive
// 8-channel runs of the NHWC output, so the stores are one contiguous
// stream (32 bytes a thread in f32, 16 in bf16).
//
// Bound on the H100: device memory. At S bs32@640 the kernel reads 39 MB
// and writes 210 MB (bf16) for 5.7 GFLOP, far under the FMA rate; it reads
// the input once from device memory (neighbouring pixels share rows in L1)
// and writes the output once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 8;         // output channels per thread
constexpr int kMaxO = 256;      // 28 * 256 floats of shared memory

__device__ __forceinline__ void store_run(float* out, const float* v) {
  float4* o = reinterpret_cast<float4*>(out);
  o[0] = make_float4(v[0], v[1], v[2], v[3]);
  o[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store_run(__nv_bfloat16* out, const float* v) {
  __nv_bfloat162 h[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(h);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
stem_kernel(const uint8_t* __restrict__ img, const float* __restrict__ wts,
            T* __restrict__ out, int B, int H, int W, int O) {
  extern __shared__ float ws[];   // [27 * O] taps, then [O] bias
  const int nw = 28 * O;
  for (int i = threadIdx.x; i < nw; i += blockDim.x) ws[i] = wts[i];
  __syncthreads();

  const int H2 = H / 2, W2 = W / 2, runs = O / kRun;
  const size_t total = (size_t)B * H2 * W2 * runs;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int r = (int)(i % runs);
    const size_t p = i / runs;                  // output pixel (b, y, x)
    const int x = (int)(p % W2);
    const int y = (int)((p / W2) % H2);
    const int b = (int)(p / ((size_t)W2 * H2));
    const int o0 = r * kRun;

    float acc[kRun];
#pragma unroll
    for (int j = 0; j < kRun; ++j) acc[j] = ws[27 * O + o0 + j];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int iy = 2 * y + dy - 1;
      if (iy < 0) continue;
      const uint8_t* row = img + ((size_t)b * H + iy) * W * 3;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int ix = 2 * x + dx - 1;
        if (ix < 0) continue;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float v = (float)__ldg(row + ix * 3 + c);
          const float4* wr = reinterpret_cast<const float4*>(
              ws + ((dy * 3 + dx) * 3 + c) * O + o0);
          const float4 w0 = wr[0], w1 = wr[1];
          acc[0] = fmaf(v, w0.x, acc[0]);
          acc[1] = fmaf(v, w0.y, acc[1]);
          acc[2] = fmaf(v, w0.z, acc[2]);
          acc[3] = fmaf(v, w0.w, acc[3]);
          acc[4] = fmaf(v, w1.x, acc[4]);
          acc[5] = fmaf(v, w1.y, acc[5]);
          acc[6] = fmaf(v, w1.z, acc[6]);
          acc[7] = fmaf(v, w1.w, acc[7]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kRun; ++j) acc[j] = fmaxf(acc[j], 0.f);
    store_run(out + p * O + o0, acc);
  }
}

template <typename T>
int launch(const void* img, const float* wts, void* out, int B, int H, int W,
           int O, cudaStream_t stream) {
  if (B <= 0 || H < 2 || W < 2 || (H | W) & 1 || O <= 0 || O % kRun || O > kMaxO)
    return (int)cudaErrorInvalidValue;
  const size_t total = (size_t)B * (H / 2) * (W / 2) * (O / kRun);
  size_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 16384) blocks = 16384;   // grid-stride beyond this
  stem_kernel<T><<<(unsigned)blocks, kThreads, 28 * O * sizeof(float), stream>>>(
      static_cast<const uint8_t*>(img), wts, static_cast<T*>(out), B, H, W, O);
  return (int)cudaGetLastError();
}

}  // namespace

// img: uint8 [B,H,W,3]; wts: f32 [28*O] (ops/stem.py:stem_build); out: NHWC
// [B,H/2,W/2,O]. Returns the cudaError_t of the launch.
extern "C" int stem_f32(const void* img, const float* wts, void* out, int B,
                        int H, int W, int O, void* stream) {
  return launch<float>(img, wts, out, B, H, W, O, (cudaStream_t)stream);
}

extern "C" int stem_bf16(const void* img, const float* wts, void* out, int B,
                         int H, int W, int O, void* stream) {
  return launch<__nv_bfloat16>(img, wts, out, B, H, W, O, (cudaStream_t)stream);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
