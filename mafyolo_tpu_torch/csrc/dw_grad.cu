// Depthwise-conv weight gradient, two deterministic passes.
//
// Replaces: mafyolo_tpu/ops/dw_grad_pallas.py:dw_grad_planar (_planar_kernel)
// and :dw_grad_kernel (_dk_kernel), the two Pallas forms of the same sum.
//
// Computes, for a stride-1 depthwise conv with kernel k, padding pad and
// dilation d:
//   dk[c, ky, kx] = sum_{b, ho, wo} x[b, ho + ky*d - pad, wo + kx*d - pad, c]
//                                   * g[b, ho, wo, c]
// with x [B, H, W, C] and g [B, Ho, Wo, C] in channels-last memory (f32 or
// bf16), zeros read outside the image, and f32 accumulation. Output f32
// [C, 1, k, k] (the torch depthwise weight layout). Any H and W; no 16-row
// limit as in dw_grad_kernel.
//
// Pass 1 (dk_partial): a block owns 32 channels (threadIdx.x, so every load
// of x and g is coalesced along C) and walks a fixed, strided list of
// 16x16 output tiles (b, row band, column band). For each tile it stages the
// x tile plus its (k-1)*d halo in shared memory as f32, zero outside the
// image, then each of its 8 pixel lanes (threadIdx.y) takes every 8th pixel
// of the tile, reads g once from device memory and adds x*g into k*k
// registers. At the end the 8 lanes are summed in a fixed order and the
// block writes one partial [k*k, C] row set for its split.
// Pass 2 (dk_reduce): sums the splits in order. No atomics: the same inputs
// on the same card give the same bits.
//
// Bound on the H100: the shared-memory loads of pass 1, one per FMA (32
// FMAs per SM per clock against 128 the card could issue); device memory
// is read about once (x plus a halo of at most (1 + halo/16)^2, g once).
// Register tiling along W would cut the loads per FMA; that is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCT = 32;   // channels per block
constexpr int kPY = 8;    // pixel lanes per block
constexpr int kTH = 16;   // output tile rows
constexpr int kTW = 16;   // output tile columns

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <int K, typename T>
__global__ void __launch_bounds__(kCT * kPY)
dk_partial(const T* __restrict__ x, const T* __restrict__ g,
           float* __restrict__ part, int H, int W, int C, int Ho, int Wo,
           int pad, int dil, int tiles_h, int tiles_w, int n_tiles) {
  extern __shared__ float xs[];   // [SH * SW][kCT], f32
  const int halo = (K - 1) * dil;
  const int SW = kTW + halo;
  const int n_stage = (kTH + halo) * SW * kCT;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kCT + tx;
  const int c0 = blockIdx.x * kCT;
  const int c = c0 + tx;

  float acc[K * K];
#pragma unroll
  for (int j = 0; j < K * K; ++j) acc[j] = 0.f;

  for (int t = blockIdx.y; t < n_tiles; t += gridDim.y) {
    const int b = t / (tiles_h * tiles_w);
    const int r = t - b * tiles_h * tiles_w;
    const int h0 = (r / tiles_w) * kTH;
    const int w0 = (r % tiles_w) * kTW;
    __syncthreads();   // the previous tile's reads are done
    for (int i = tid; i < n_stage; i += kCT * kPY) {
      const int cc = i % kCT;
      const int p = i / kCT;
      const int yy = h0 - pad + p / SW;
      const int xx = w0 - pad + p % SW;
      float v = 0.f;
      if (yy >= 0 && yy < H && xx >= 0 && xx < W && c0 + cc < C)
        v = to_f32(x[((size_t)(b * H + yy) * W + xx) * C + c0 + cc]);
      xs[i] = v;
    }
    __syncthreads();
    if (c < C) {
      for (int p = ty; p < kTH * kTW; p += kPY) {
        const int oy = p / kTW, ox = p % kTW;
        const int ho = h0 + oy, wo = w0 + ox;
        if (ho >= Ho || wo >= Wo) continue;
        const float gv = to_f32(g[((size_t)(b * Ho + ho) * Wo + wo) * C + c]);
        const float* row = xs + ((size_t)oy * SW + ox) * kCT + tx;
#pragma unroll
        for (int ky = 0; ky < K; ++ky) {
#pragma unroll
          for (int kx = 0; kx < K; ++kx)
            acc[ky * K + kx] = fmaf(row[(ky * dil * SW + kx * dil) * kCT], gv,
                                    acc[ky * K + kx]);
        }
      }
    }
  }

  // sum the pixel lanes in a fixed order; xs is free again
  __syncthreads();
  float* red = xs;   // [kPY][kCT]
#pragma unroll
  for (int j = 0; j < K * K; ++j) {
    red[ty * kCT + tx] = acc[j];
    __syncthreads();
    if (ty == 0 && c < C) {
      float s = 0.f;
      for (int i = 0; i < kPY; ++i) s += red[i * kCT + tx];
      part[((size_t)blockIdx.y * K * K + j) * C + c] = s;
    }
    __syncthreads();
  }
}

__global__ void dk_reduce(const float* __restrict__ part, float* __restrict__ out,
                          int n_split, int kk, int C) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;   // j * C + c
  if (i >= kk * C) return;
  float s = 0.f;
  for (int t = 0; t < n_split; ++t) s += part[(size_t)t * kk * C + i];
  const int j = i / C, c = i - j * C;
  out[(size_t)c * kk + j] = s;
}

template <int K, typename T>
int launch(const void* x, const void* g, float* part, int H, int W, int C,
           int Ho, int Wo, int pad, int dil, int B, int n_split, size_t smem,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      dk_partial<K, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_h = (Ho + kTH - 1) / kTH, tiles_w = (Wo + kTW - 1) / kTW;
  const dim3 grid((C + kCT - 1) / kCT, n_split);
  dk_partial<K, T><<<grid, dim3(kCT, kPY), smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), part, H, W, C, Ho, Wo,
      pad, dil, tiles_h, tiles_w, B * tiles_h * tiles_w);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int k, const void* x, const void* g, float* part, int H, int W,
             int C, int Ho, int Wo, int pad, int dil, int B, int n_split,
             size_t smem, cudaStream_t s) {
  switch (k) {
    case 1: return launch<1, T>(x, g, part, H, W, C, Ho, Wo, pad, dil, B, n_split, smem, s);
    case 3: return launch<3, T>(x, g, part, H, W, C, Ho, Wo, pad, dil, B, n_split, smem, s);
    case 5: return launch<5, T>(x, g, part, H, W, C, Ho, Wo, pad, dil, B, n_split, smem, s);
    case 7: return launch<7, T>(x, g, part, H, W, C, Ho, Wo, pad, dil, B, n_split, smem, s);
    case 9: return launch<9, T>(x, g, part, H, W, C, Ho, Wo, pad, dil, B, n_split, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Shared memory per block: the staged x tile, or the lane sums at the end.
// A request over the card's limit fails in cudaFuncSetAttribute, and that
// error is returned to the caller.
size_t smem_bytes(int k, int dil) {
  const int halo = (k - 1) * dil;
  const size_t stage = (size_t)(kTH + halo) * (kTW + halo) * kCT * sizeof(float);
  const size_t red = (size_t)kPY * kCT * sizeof(float);
  return stage > red ? stage : red;
}

}  // namespace

// x, g channels-last [B,H,W,C] / [B,Ho,Wo,C]; bf16 != 0 means __nv_bfloat16
// elements, else float. part: f32 scratch [n_split, k*k, C]; out: f32
// [C, k*k]. Returns the cudaError_t of the launches.
extern "C" int dw_grad(const void* x, const void* g, float* part, float* out,
                       int bf16, int B, int H, int W, int C, int Ho, int Wo,
                       int k, int pad, int dil, int n_split, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = smem_bytes(k, dil);
  const int err = bf16
      ? dispatch<__nv_bfloat16>(k, x, g, part, H, W, C, Ho, Wo, pad, dil, B, n_split, smem, s)
      : dispatch<float>(k, x, g, part, H, W, C, Ho, Wo, pad, dil, B, n_split, smem, s);
  if (err != 0) return err;
  const int n = k * k * C;
  dk_reduce<<<(n + 255) / 256, 256, 0, s>>>(part, out, n_split, k * k, C);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
