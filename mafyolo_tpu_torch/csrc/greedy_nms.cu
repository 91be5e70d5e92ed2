// Greedy NMS keep mask, one thread block per image.
//
// Replaces: mafyolo_tpu/ops/pallas_nms.py:pallas_greedy_nms (_nms_kernel),
// and in the main path the XLA fixpoint mafyolo_tpu/ops/nms.py:_greedy_nms_mask
// that _blocked_greedy_select runs.
//
// Computes: boxes f32 [B, M, 4] (xyxy, score-descending, class offset
// applied) and valid u8 [B, M] -> keep u8 [B, M]. Walking i in score order,
// a kept box i suppresses every j > i with IoU(i, j) > thr, where
// IoU = inter / (((area_i + area_j) - inter) + 1e-7) and area = clip(w,0) *
// clip(h,0): the operation order of ops/boxes.py:box_iou_pairwise, in
// round-to-nearest intrinsics, and this file is built with -fmad=false, so
// the keep set equals the plain version's exactly.
//
// Bound on the H100: latency. The walk over i is sequential (M steps with a
// block barrier each); the work per step is at most M IoUs spread over the
// block's threads, and the bytes are read once. Design: the boxes, their
// areas and the keep flags sit in shared memory for the whole walk (M=2000:
// 42 KB), device memory is touched once on the way in and once on the way
// out, and a step whose box is already suppressed costs one shared-memory
// read and no barrier. Images run in parallel, one block each.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
greedy_nms_kernel(const float* __restrict__ boxes,
                  const uint8_t* __restrict__ valid,
                  uint8_t* __restrict__ keep, int m, float thr) {
  extern __shared__ float sm[];
  float* x1 = sm;
  float* y1 = x1 + m;
  float* x2 = y1 + m;
  float* y2 = x2 + m;
  float* area = y2 + m;
  uint8_t* alive = reinterpret_cast<uint8_t*>(area + m);

  const int b = blockIdx.x;
  const float* bx = boxes + (size_t)b * m * 4;
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    const float a = bx[4 * j], c = bx[4 * j + 1];
    const float e = bx[4 * j + 2], f = bx[4 * j + 3];
    x1[j] = a; y1[j] = c; x2[j] = e; y2[j] = f;
    area[j] = __fmul_rn(fmaxf(__fsub_rn(e, a), 0.f), fmaxf(__fsub_rn(f, c), 0.f));
    alive[j] = valid[(size_t)b * m + j] != 0;
  }
  __syncthreads();

  for (int i = 0; i < m; ++i) {
    // alive[i] is final: it was last written before the latest barrier.
    if (!alive[i]) continue;   // uniform across the block
    const float ax1 = x1[i], ay1 = y1[i], ax2 = x2[i], ay2 = y2[i];
    const float ai = area[i];
    for (int j = i + 1 + threadIdx.x; j < m; j += blockDim.x) {
      if (!alive[j]) continue;
      const float w = fmaxf(__fsub_rn(fminf(ax2, x2[j]), fmaxf(ax1, x1[j])), 0.f);
      const float h = fmaxf(__fsub_rn(fminf(ay2, y2[j]), fmaxf(ay1, y1[j])), 0.f);
      const float inter = __fmul_rn(w, h);
      const float denom = __fadd_rn(__fsub_rn(__fadd_rn(ai, area[j]), inter), 1e-7f);
      if (__fdiv_rn(inter, denom) > thr) alive[j] = 0;
    }
    __syncthreads();
  }

  for (int j = threadIdx.x; j < m; j += blockDim.x)
    keep[(size_t)b * m + j] = alive[j];
}

}  // namespace

extern "C" int greedy_nms(const float* boxes, const uint8_t* valid,
                          uint8_t* keep, int batch, int m, float thr,
                          void* stream) {
  const size_t smem = (size_t)m * 5 * sizeof(float) + (size_t)m;
  cudaError_t err = cudaFuncSetAttribute(
      greedy_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  greedy_nms_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      boxes, valid, keep, m, thr);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
