// FMA-rate probe: y = bf16(sum_i x * w[i]), 25 dependent f32 FMAs per element
// over a bf16 operand (the shape of a 5x5 depthwise stencil's inner loop).
//
// Replaces: tools/profile_vpu.py:pallas_fma, the TPU tool that calibrates
// the vector unit's FMA ceiling against XLA's fused chain.
//
// Each thread loads 8 bf16 values with one 16-byte load, runs the chain
//   acc = x * w[0]; acc = fmaf(x, w[i], acc) for i = 1..24
// for each of them in f32 with the 25 taps in registers, and stores 8 bf16
// with one 16-byte store. The FMAs of one element depend on each other and
// are never folded into one multiply by sum(w): the build sets no fast-math,
// and nvcc does not reassociate float adds without it.
//
// Bound on the H100: at the TPU tool's shape, x [32768, 1536], the probe
// moves 201 MB (read once, written once) for 2.5 GFLOP, so device memory
// and the CUDA cores' f32 FMA rate bound it about equally; it reports both
// rates.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 25;
constexpr int kThreads = 256;

__device__ __forceinline__ float chain(float x, const float* w) {
  float acc = x * w[0];
#pragma unroll
  for (int i = 1; i < kTaps; ++i) acc = fmaf(x, w[i], acc);
  return acc;
}

__global__ void __launch_bounds__(kThreads)
fma_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ wg,
           __nv_bfloat16* __restrict__ y, long long n) {
  float w[kTaps];
#pragma unroll
  for (int i = 0; i < kTaps; ++i) w[i] = __ldg(wg + i);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n8 = n / 8;
  for (long long i = first; i < n8; i += stride) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(x) + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
    __nv_bfloat162 o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      o[j] = __floats2bfloat162_rn(chain(f.x, w), chain(f.y, w));
    }
    reinterpret_cast<uint4*>(y)[i] = *reinterpret_cast<const uint4*>(o);
  }
  for (long long i = n8 * 8 + first; i < n; i += stride)   // the ragged tail
    y[i] = __float2bfloat16_rn(chain(__bfloat162float(x[i]), w));
}

}  // namespace

// x, y: bf16 [n], 16-byte aligned; w: f32 [25]. Returns the cudaError_t of
// the launch.
extern "C" int fma_probe(const void* x, const float* w, void* y, long long n,
                         int blocks, void* stream) {
  if (n <= 0 || blocks <= 0 || (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15)
    return (int)cudaErrorInvalidValue;
  fma_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(x), w, static_cast<__nv_bfloat16*>(y), n);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
