// Fused MAF-YOLO front-end: deploy layers 0-2, or 0-1, in one kernel.
//
// Replaces: mafyolo_tpu/ops/frontend_pallas.py:frontend_forward (_kernel),
// with fuse_l2 (layers 0-2) and without (layers 0-1).
//
// Computes: uint8 BGR NHWC [B, H, W, 3] (H, W multiples of 4) -> NHWC
// [B, H/4, W/4, c2] in f32 or bf16:
//   L0  relu(conv3x3/s2(x) + b0), /255 and the BGR->RGB flip folded into w0
//   L1  relu(conv3x3/s2(L0) + b1)
//   L2  deploy RepHDW(k=3): x2 = silu(1x1(L1)) split into a | b; a chain of
//       `depth` bottlenecks on b, each expand 1x1+SiLU -> DW3x3+bias+SiLU ->
//       project 1x1+SiLU; cv_out = silu(1x1 over concat [a, b, y0..] ).
// With depth 0 (and cs = mid = c2 = 0) the kernel stops after L1 and writes
// L1 itself, [B, H/4, W/4, c1]: the layers-0-1 mode, for graphs whose layer
// 2 is another block (the YOLOv6 office graphs). Each kernel takes it as the
// template flag kL2 = false: L0 and L1 run as in the full mode on a tile
// without the DW halo, and L1's results go out in 16-byte stores, so the
// full mode (kL2 = true) compiles to the code it had before.
// Every conv pads with zeros: L0 values outside the image are 0 before L1
// reads them, and expand outputs outside the image are 0 before the DW
// stencil reads them.
//
// Bound on the H100: as separate layers the 320- and 160-level maps would
// go to device memory and back several times, so both kernels here keep
// them on chip: one thread block per output tile at H/4 with all channels
// stages the input window, L0 over the tile plus halo, L1 over the tile
// plus the DW halo (`depth` pixels a side) and the RepHDW intermediates in
// shared memory. With the maps on chip the work left is arithmetic (S at
// bs32@640: 39.5 GFMA without halo recompute, against 144 MB of traffic),
// and two kernels do it:
//
//   * frontend_mma_kernel (the bf16 entry point, the serving path): L1 as an
//     implicit GEMM (rows = the tile's L1 pixels, K = 9 taps x c0, the A
//     fragment of tap (u, v) is the L0 pixel at (2y+u, 2x+v)) and every 1x1
//     conv run on the tensor cores: bf16 mma.sync m16n8k16 with f32
//     accumulation, A by ldmatrix from bf16 activations in shared memory, B
//     read as whole fragments from a host-packed bf16 buffer
//     (csrc/mma_bf16.cuh), one K tile ahead of the MMAs that use it. With one
//     512-thread block an SM the phases are bound by instruction issue, so
//     the epilogues are kept short: SiLU by the hardware tanh, biases once a
//     work item, row/column splits by a float multiply, 32-bit input loads.
//     bf16 staging halves the footprint, so the tile is
//     a rectangle up to 16 x 16 (less halo recompute). Channel counts are
//     padded to 16 with zero weights, and each producer writes zeros into
//     its pad columns, so a K tile never reads stale shared memory. L0 is a
//     GEMM too (K = 27 taps padded to 32; a lane builds its A fragment from
//     the window's bytes, which are exact in bf16); only the DW stencil stays
//     on the CUDA cores. Bias, ReLU/SiLU and the zero-padding masks run in
//     f32 in each epilogue and a value is rounded to bf16 once, when it is
//     stored for the next phase.
//   * frontend_kernel (the f32 entry point, the reference route of the
//     detection gates): every conv as f32 FMAs on the CUDA cores, a T x T
//     tile with T the largest of 8, 4, 2 that fits; a thread's work item is
//     a register tile of 2 pixels x 4 output channels.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kMaxThreads = 512;

struct Dims {
  int B, H, W, c0, c1, cs, mid, depth, c2;   // cs: the CSP split width c_
};

// Offsets (in floats) of each weight in the packed buffer; the order is
// ops/frontend.py:_layout.
struct WOff {
  int w0, b0, w1, b1, win, bin, m0, mstride, wout, bout;
};

__host__ __device__ inline WOff weight_offsets(const Dims& d) {
  WOff o;
  o.w0 = 0;
  o.b0 = o.w0 + 27 * d.c0;
  o.w1 = o.b0 + d.c0;
  o.b1 = o.w1 + 9 * d.c0 * d.c1;
  o.win = o.b1 + d.c1;
  o.bin = o.win + d.c1 * 2 * d.cs;
  o.m0 = o.bin + 2 * d.cs;
  // per bottleneck: wexp [cs][mid], bexp, wdw [9][mid], bdw, wproj [mid][cs], bproj
  o.mstride = d.cs * d.mid + d.mid + 9 * d.mid + d.mid + d.mid * d.cs + d.cs;
  o.wout = o.m0 + d.depth * o.mstride;
  o.bout = o.wout + (2 + d.depth) * d.cs * d.c2;
  return o;
}

// Shared-memory plan for tile size t (all sizes in floats, input in bytes).
struct Plan {
  int t, r1, r0, rin;
  int l1, x2, ys, region0;   // float offsets
  int in_bytes_off;          // byte offset of the u8 input window
  size_t bytes;
  int threads;               // block size, set by pick_plan
};

__host__ __device__ inline Plan make_plan(const Dims& d, int t) {
  Plan p;
  p.t = t;
  p.r1 = t + 2 * d.depth;   // L1 / x2 grid
  p.r0 = 2 * p.r1 + 1;      // L0 grid
  p.rin = 2 * p.r0 + 1;     // input window
  const int r1sq = p.r1 * p.r1;
  const int rn = p.r1 - 2;
  int region0 = p.r0 * p.r0 * d.c0;
  const int l2 = r1sq * d.mid + rn * rn * d.mid;   // expand + DW outputs
  if (l2 > region0) region0 = l2;
  int ys = 0;
  for (int i = 0; i < d.depth; ++i) {
    const int r = p.r1 - 2 * (i + 1);
    ys += r * r * d.cs;
  }
  p.region0 = 0;
  p.l1 = region0;
  p.x2 = p.l1 + r1sq * d.c1;
  p.ys = p.x2 + r1sq * 2 * d.cs;
  const int floats = p.ys + ys;
  p.in_bytes_off = floats * 4;
  p.bytes = ((size_t)p.in_bytes_off + (size_t)p.rin * p.rin * 3 + 15) & ~(size_t)15;
  return p;
}

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

__device__ __forceinline__ float4 silu4(float4 v) {
  return make_float4(silu(v.x), silu(v.y), silu(v.z), silu(v.w));
}

__device__ __forceinline__ float4 relu4(float4 v) {
  return make_float4(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f), fmaxf(v.z, 0.f), fmaxf(v.w, 0.f));
}

__device__ __forceinline__ void fma4(float4& acc, float4 w, float x) {
  acc.x = fmaf(w.x, x, acc.x);
  acc.y = fmaf(w.y, x, acc.y);
  acc.z = fmaf(w.z, x, acc.z);
  acc.w = fmaf(w.w, x, acc.w);
}

__device__ __forceinline__ float4 ld4(const float* p) {   // 16-byte aligned
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 ldg4(const float* p) {  // read-only weights
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// Register tile of one work item: PX output pixels x 4 output channels.
// Each activation read from shared memory feeds 4 FMAs and each 16-byte
// weight read feeds 4*PX.
constexpr int PX = 2;

// out = epi(p, o, bias[o..o+3] + sum_k w[k][o..o+3] * in[p*istride + k])
// over P pixels and C output channels (C % 4 == 0).
template <typename Epi>
__device__ __forceinline__ void pointwise(const float* __restrict__ in, int istride,
                                          int K, const float* __restrict__ w,
                                          const float* __restrict__ bias, int C,
                                          int P, Epi epi) {
  const int cg = C / 4, items = cg * ((P + PX - 1) / PX);
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int o = (it % cg) * 4, p0 = (it / cg) * PX;
    const float4 b4 = ldg4(bias + o);
    float4 acc[PX];
    const float* src[PX];
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      acc[j] = b4;
      src[j] = in + min(p0 + j, P - 1) * istride;
    }
    for (int k = 0; k < K; ++k) {
      const float4 wk = ldg4(w + k * C + o);
#pragma unroll
      for (int j = 0; j < PX; ++j) fma4(acc[j], wk, src[j][k]);
    }
#pragma unroll
    for (int j = 0; j < PX; ++j)
      if (p0 + j < P) epi(p0 + j, o, acc[j]);
  }
}

template <typename OutT, bool kL2>
__global__ void __launch_bounds__(kMaxThreads)
frontend_kernel(const uint8_t* __restrict__ img, const float* __restrict__ w,
                OutT* __restrict__ out, Dims d, Plan p, int tiles_x) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  uint8_t* s_in = smem_raw + p.in_bytes_off;
  float* s_l0 = sm + p.region0;
  float* s_l1 = sm + p.l1;
  float* s_x2 = sm + p.x2;
  float* s_ys = sm + p.ys;

  const WOff wo = weight_offsets(d);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int b = blockIdx.y;
  const int ty = blockIdx.x / tiles_x, tx = blockIdx.x % tiles_x;
  const int D = d.depth, T = p.t, R1 = p.r1, R0 = p.r0, RIN = p.rin;
  const int H0 = d.H / 2, W0 = d.W / 2, H1 = d.H / 4, W1 = d.W / 4;
  const int y1o = ty * T - D, x1o = tx * T - D;       // L1 grid origin
  const int y0o = 2 * y1o - 1, x0o = 2 * x1o - 1;     // L0 grid origin
  const int yio = 2 * y0o - 1, xio = 2 * x0o - 1;     // input window origin
  const int C2h = 2 * d.cs;

  // Phase 0: input window, zero outside the image.
  const uint8_t* im = img + (size_t)b * d.H * d.W * 3;
  for (int i = tid; i < RIN * RIN * 3; i += nth) {
    const int c = i % 3, px = i / 3;
    const int gy = yio + px / RIN, gx = xio + px % RIN;
    s_in[i] = (gy >= 0 && gy < d.H && gx >= 0 && gx < d.W)
                 ? im[((size_t)gy * d.W + gx) * 3 + c] : 0;
  }
  __syncthreads();

  // Phase 1: L0 over R0 x R0; zero outside the H/2 image (L1's padding).
  {
    const float* w0 = w + wo.w0;
    const int cg = d.c0 / 4, P = R0 * R0, items = cg * ((P + PX - 1) / PX);
    for (int it = tid; it < items; it += nth) {
      const int o = (it % cg) * 4, p0 = (it / cg) * PX;
      const float4 b4 = ldg4(w + wo.b0 + o);
      float4 acc[PX];
      const uint8_t* src[PX];
#pragma unroll
      for (int j = 0; j < PX; ++j) {
        const int px = min(p0 + j, P - 1);
        acc[j] = b4;
        src[j] = s_in + (2 * (px / R0) * RIN + 2 * (px % R0)) * 3;
      }
      for (int u = 0; u < 3; ++u)
        for (int v = 0; v < 3; ++v)
          for (int ci = 0; ci < 3; ++ci) {
            const float4 wk = ldg4(w0 + ((u * 3 + v) * 3 + ci) * d.c0 + o);
            const int off = (u * RIN + v) * 3 + ci;
#pragma unroll
            for (int j = 0; j < PX; ++j) fma4(acc[j], wk, (float)src[j][off]);
          }
#pragma unroll
      for (int j = 0; j < PX; ++j) {
        const int px = p0 + j;
        if (px >= P) break;
        const int gy = y0o + px / R0, gx = x0o + px % R0;
        const bool in = gy >= 0 && gy < H0 && gx >= 0 && gx < W0;
        st4(s_l0 + px * d.c0 + o, in ? relu4(acc[j]) : make_float4(0.f, 0.f, 0.f, 0.f));
      }
    }
  }
  __syncthreads();

  // Phase 2: L1 over R1 x R1 (values outside the image are never read
  // unmasked: they feed only expand outputs, which are zeroed there).
  {
    const float* w1 = w + wo.w1;
    const int cg = d.c1 / 4, P = R1 * R1, items = cg * ((P + PX - 1) / PX);
    for (int it = tid; it < items; it += nth) {
      const int o = (it % cg) * 4, p0 = (it / cg) * PX;
      const float4 b4 = ldg4(w + wo.b1 + o);
      float4 acc[PX];
      const float* src[PX];
#pragma unroll
      for (int j = 0; j < PX; ++j) {
        const int px = min(p0 + j, P - 1);
        acc[j] = b4;
        src[j] = s_l0 + (2 * (px / R1) * R0 + 2 * (px % R1)) * d.c0;
      }
      for (int u = 0; u < 3; ++u)
        for (int v = 0; v < 3; ++v) {
          const float* wt = w1 + (u * 3 + v) * d.c0 * d.c1 + o;
          const int off = (u * R0 + v) * d.c0;
          for (int ci = 0; ci < d.c0; ++ci) {
            const float4 wk = ldg4(wt + ci * d.c1);
#pragma unroll
            for (int j = 0; j < PX; ++j) fma4(acc[j], wk, src[j][off + ci]);
          }
        }
      if constexpr (kL2) {
#pragma unroll
        for (int j = 0; j < PX; ++j)
          if (p0 + j < P) st4(s_l1 + (p0 + j) * d.c1 + o, relu4(acc[j]));
      } else {
        // layers 0-1: the R1 grid is the tile; out is [B, H1, W1, c1]
#pragma unroll
        for (int j = 0; j < PX; ++j) {
          const int px = p0 + j;
          if (px >= P) break;
          const int Y = ty * T + px / R1, X = tx * T + px % R1;
          if (Y < H1 && X < W1)
            st4(out + (((size_t)b * H1 + Y) * W1 + X) * d.c1 + o, relu4(acc[j]));
        }
      }
    }
  }
  if constexpr (!kL2) return;
  __syncthreads();

  // Phase 3: x2 = silu(cv_in(L1)) over R1 x R1, channels [a | b].
  pointwise(s_l1, d.c1, d.c1, w + wo.win, w + wo.bin, C2h, R1 * R1,
            [&](int px, int o, float4 v) { st4(s_x2 + px * C2h + o, silu4(v)); });
  __syncthreads();

  // Phase 4: the bottleneck chain. Bottleneck m reads a grid of Ri = R1-2m
  // (offset m from the R1 grid) and writes y_m on Rn = Ri - 2.
  float* s_t = sm + p.region0;             // expand output, Ri x Ri x mid
  float* s_dw = s_t + R1 * R1 * d.mid;     // DW output, Rn x Rn x mid
  float* y_prev = nullptr;
  int yoff = 0;
  for (int m = 0; m < D; ++m) {
    const int Ri = R1 - 2 * m, Rn = Ri - 2;
    const float* wexp = w + wo.m0 + m * wo.mstride;
    const float* bexp = wexp + d.cs * d.mid;
    const float* wdw = bexp + d.mid;
    const float* bdw = wdw + 9 * d.mid;
    const float* wproj = bdw + d.mid;
    const float* bproj = wproj + d.mid * d.cs;
    const float* src = m == 0 ? s_x2 + d.cs : y_prev;
    const int sstride = m == 0 ? C2h : d.cs;
    pointwise(src, sstride, d.cs, wexp, bexp, d.mid, Ri * Ri,
              [&](int px, int o, float4 v) {
                const int gy = y1o + m + px / Ri, gx = x1o + m + px % Ri;
                const bool in = gy >= 0 && gy < H1 && gx >= 0 && gx < W1;
                st4(s_t + px * d.mid + o, in ? silu4(v) : make_float4(0.f, 0.f, 0.f, 0.f));
              });
    __syncthreads();
    {
      const int cg = d.mid / 4, P = Rn * Rn, items = cg * ((P + PX - 1) / PX);
      for (int it = tid; it < items; it += nth) {
        const int o = (it % cg) * 4, p0 = (it / cg) * PX;
        const float4 b4 = ldg4(bdw + o);
        float4 acc[PX];
        const float* src_t[PX];
#pragma unroll
        for (int j = 0; j < PX; ++j) {
          const int px = min(p0 + j, P - 1);
          acc[j] = b4;
          src_t[j] = s_t + ((px / Rn) * Ri + px % Rn) * d.mid + o;
        }
        for (int ky = 0; ky < 3; ++ky)
          for (int kx = 0; kx < 3; ++kx) {
            const float4 wk = ldg4(wdw + (ky * 3 + kx) * d.mid + o);
            const int off = (ky * Ri + kx) * d.mid;
#pragma unroll
            for (int j = 0; j < PX; ++j) {
              const float4 t = ld4(src_t[j] + off);
              acc[j].x = fmaf(wk.x, t.x, acc[j].x);
              acc[j].y = fmaf(wk.y, t.y, acc[j].y);
              acc[j].z = fmaf(wk.z, t.z, acc[j].z);
              acc[j].w = fmaf(wk.w, t.w, acc[j].w);
            }
          }
#pragma unroll
        for (int j = 0; j < PX; ++j)
          if (p0 + j < P) st4(s_dw + (p0 + j) * d.mid + o, silu4(acc[j]));
      }
    }
    __syncthreads();
    float* y = s_ys + yoff;
    pointwise(s_dw, d.mid, d.mid, wproj, bproj, d.cs, Rn * Rn,
              [&](int px, int o, float4 v) { st4(y + px * d.cs + o, silu4(v)); });
    __syncthreads();
    y_prev = y;
    yoff += Rn * Rn * d.cs;
  }

  // Phase 5: cv_out over the T x T tile, concat [a, b, y0, .., y_{D-1}].
  {
    const float* wout = w + wo.wout;
    const int cg = d.c2 / 4, P = T * T, items = cg * ((P + PX - 1) / PX);
    for (int it = tid; it < items; it += nth) {
      const int o = (it % cg) * 4, p0 = (it / cg) * PX;
      const float4 b4 = ldg4(w + wo.bout + o);
      float4 acc[PX];
      int rr[PX], qq[PX];
#pragma unroll
      for (int j = 0; j < PX; ++j) {
        const int px = min(p0 + j, P - 1);
        acc[j] = b4;
        rr[j] = px / T;
        qq[j] = px % T;
      }
      {
        const float* xp[PX];
#pragma unroll
        for (int j = 0; j < PX; ++j) xp[j] = s_x2 + ((rr[j] + D) * R1 + qq[j] + D) * C2h;
        for (int k = 0; k < C2h; ++k) {
          const float4 wk = ldg4(wout + k * d.c2 + o);
#pragma unroll
          for (int j = 0; j < PX; ++j) fma4(acc[j], wk, xp[j][k]);
        }
      }
      int off = 0;
      for (int m = 0; m < D; ++m) {
        const int Rn = R1 - 2 * (m + 1), e = D - (m + 1);
        const float* wk0 = wout + (C2h + m * d.cs) * d.c2 + o;
        const float* yp[PX];
#pragma unroll
        for (int j = 0; j < PX; ++j) yp[j] = s_ys + off + ((rr[j] + e) * Rn + qq[j] + e) * d.cs;
        for (int k = 0; k < d.cs; ++k) {
          const float4 wk = ldg4(wk0 + k * d.c2);
#pragma unroll
          for (int j = 0; j < PX; ++j) fma4(acc[j], wk, yp[j][k]);
        }
        off += Rn * Rn * d.cs;
      }
#pragma unroll
      for (int j = 0; j < PX; ++j) {
        if (p0 + j >= P) break;
        const int Y = ty * T + rr[j], X = tx * T + qq[j];
        if (Y < H1 && X < W1)
          st4(out + (((size_t)b * H1 + Y) * W1 + X) * d.c2 + o, silu4(acc[j]));
      }
    }
  }
}

// The largest tile of 8, 4, 2 whose footprint fits the card's per-block
// shared memory. Block size: 256 threads when two blocks share an SM (N),
// 512 when one block holds it alone (S, M), so that an SM keeps 16 warps
// either way (measured on the H100: 512 threads cost N 13% and save S 27%
// and M 21%).
cudaError_t pick_plan(const Dims& d, Plan* out) {
  int dev = 0, max_smem = 0, sm_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err != cudaSuccess) return err;
  for (int t = 8; t >= 2; t /= 2) {
    *out = make_plan(d, t);
    if (out->bytes <= (size_t)max_smem) {
      out->threads = 2 * out->bytes <= (size_t)sm_smem ? 256 : 512;
      return cudaSuccess;
    }
  }
  return cudaErrorInvalidConfiguration;
}

// Depth 0 is the layers-0-1 mode: nothing of layer 2 may be given; a
// negative depth is no mode.
inline bool layers01_ok(const Dims& d) {
  return d.depth > 0 || (d.depth == 0 && d.cs == 0 && d.mid == 0 && d.c2 == 0);
}

template <typename OutT, bool kL2>
int launch_t(const uint8_t* img, const float* w, OutT* out, Dims d, const Plan& p,
             void* stream) {
  cudaError_t err = cudaFuncSetAttribute(frontend_kernel<OutT, kL2>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)p.bytes);
  if (err != cudaSuccess) return (int)err;
  const int h1 = d.H / 4, w1 = d.W / 4;
  const int tiles_x = (w1 + p.t - 1) / p.t, tiles_y = (h1 + p.t - 1) / p.t;
  dim3 grid(tiles_x * tiles_y, d.B);
  frontend_kernel<OutT, kL2><<<grid, p.threads, p.bytes, (cudaStream_t)stream>>>(
      img, w, out, d, p, tiles_x);
  return (int)cudaGetLastError();
}

template <typename OutT>
int launch(const uint8_t* img, const float* w, OutT* out, Dims d, void* stream) {
  // Every channel count is a multiple of 4 (16-byte weight rows and
  // activation vectors); all MAF-YOLO and YOLOv6 widths are.
  if (d.H % 4 || d.W % 4 || !layers01_ok(d) || d.B < 1 || d.c0 % 4 ||
      d.c1 % 4 || d.cs % 4 || d.mid % 4 || d.c2 % 4)
    return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = pick_plan(d, &p);
  if (err != cudaSuccess) return (int)err;
  return d.depth ? launch_t<OutT, true>(img, w, out, d, p, stream)
                 : launch_t<OutT, false>(img, w, out, d, p, stream);
}

// ---------------------------------------------------------------------------
// The bf16 tensor-core kernel.

__host__ __device__ constexpr int pad16(int n) { return (n + 15) / 16 * 16; }

// Offsets (in bf16 elements) of each packed MMA weight; the order is
// ops/frontend.py:_mma_parts. Each is a [K, N] matrix padded to 16 both
// ways, in fragment order.
struct WOffB {
  int w0, w1, win, m0, mstride, wexp_len, wout, total;
};

__host__ __device__ inline WOffB mma_offsets(const Dims& d) {
  const int c0p = pad16(d.c0), c1p = pad16(d.c1), csp = pad16(d.cs),
            midp = pad16(d.mid);
  WOffB o;
  o.w0 = 0;                             // [27 -> 32, c0p]
  o.w1 = o.w0 + 32 * c0p;
  o.win = o.w1 + 9 * c0p * c1p;
  o.m0 = o.win + c1p * 2 * csp;
  o.wexp_len = csp * midp;              // then wproj [midp, csp]
  o.mstride = 2 * csp * midp;
  o.wout = o.m0 + d.depth * o.mstride;
  o.total = o.wout + (2 + d.depth) * csp * pad16(d.c2);
  return o;
}

// Shared-memory plan for a th x tw output tile. Strides are in bf16
// elements: the padded width + 8, so that the eight 16-byte rows of an
// ldmatrix fall on different banks. Three regions, reused across phases:
//   A  L0 (two column-parity planes a row), later the expand and DW outputs
//   B  the uint8 input window, then L1, then the y parts
//   C  x2 = [a | b], each half padded to 16 channels
struct PlanB {
  int th, tw, r1h, r1w, r0h, r0w, hw0, rinh, rinw;
  int c0p, c1p, csp, midp, c2p;
  int s0, s1, sx, st, sy;
  int off_b, off_c;   // byte offsets of regions B and C (A at 0)
  int dw_off;         // element offset of the DW output inside region A
  int in_pitch;       // bytes between rows of the input window
  size_t bytes;
  int threads;
};

__host__ __device__ inline size_t up16(size_t n) { return (n + 15) & ~(size_t)15; }

__host__ __device__ inline PlanB make_plan_b(const Dims& d, int th, int tw) {
  PlanB p;
  p.th = th;
  p.tw = tw;
  p.r1h = th + 2 * d.depth;
  p.r1w = tw + 2 * d.depth;
  p.r0h = 2 * p.r1h + 1;
  p.r0w = 2 * p.r1w + 1;
  p.hw0 = p.r1w + 1;            // even columns of an L0 row; odd ones: r1w
  p.rinh = 2 * p.r0h + 1;
  p.rinw = 2 * p.r0w + 1;
  p.c0p = pad16(d.c0);
  p.c1p = pad16(d.c1);
  p.csp = pad16(d.cs);
  p.midp = pad16(d.mid);
  p.c2p = pad16(d.c2);
  p.s0 = p.c0p + 8;
  p.s1 = p.c1p + 8;
  p.sx = 2 * p.csp + 8;
  p.st = p.midp + 8;
  p.sy = p.csp + 8;
  const size_t r1 = (size_t)p.r1h * p.r1w;
  const size_t l0 = (size_t)p.r0h * 2 * p.hw0 * p.s0 * 2;
  p.dw_off = (int)(r1 * p.st);
  const size_t tdw = (r1 + (size_t)(p.r1h - 2) * (p.r1w - 2)) * p.st * 2;
  size_t ys = 0;
  for (int m = 0; m < d.depth; ++m)
    ys += (size_t)(p.r1h - 2 * (m + 1)) * (p.r1w - 2 * (m + 1)) * p.sy * 2;
  p.in_pitch = (p.rinw * 3 + 3 + 3) / 4 * 4;   // up to 3 bytes of shift, whole words
  size_t b = (size_t)p.rinh * p.in_pitch;
  if (r1 * p.s1 * 2 > b) b = r1 * p.s1 * 2;
  if (ys > b) b = ys;
  p.off_b = (int)up16(l0 > tdw ? l0 : tdw);
  p.off_c = p.off_b + (int)up16(b);
  // region C (x2) is not used by the layers-0-1 mode
  p.bytes = (size_t)p.off_c + (d.depth ? up16(r1 * p.sx * 2) : 0);
  p.threads = 0;
  return p;
}

constexpr int kMaxNp0 = 4;   // layer 0 keeps its B fragments in registers: c0 <= 64

struct ORow {
  __nv_bfloat16* ptr;   // first channel of the output row; null: skip the row
  bool zero;            // write zeros (the row lies outside the image)
};

// One conv as a GEMM on the tensor cores: out[row][col] = act(bias(col) +
// sum over segments s, k < 16 * kseg(s): A_s[row][k] * B[k][col]) for
// row < P. aseg(s, row) is the shared-memory address of A_s[row][0]; the
// packed B walks the segments' K tiles in order, `npairs` N-tile pairs a K
// tile. A warp's work item is MT * 16 rows x 32 columns: MT = 2 reads each B
// fragment once for two row tiles, MT = 1 gives the short phases enough
// items for every warp. Columns >= nstore are not stored.
template <bool SILU, int MT, class ASeg, class KSeg, class Bias, class Out>
__device__ __forceinline__ void mma_phase(int P, int nseg, ASeg aseg, KSeg kseg,
                                          const __nv_bfloat16* __restrict__ wb, int npairs,
                                          Bias bias, int nstore, Out orow) {
  constexpr int kRows = MT * 16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int nblocks = (npairs + 1) / 2, items = ((P + kRows - 1) / kRows) * nblocks;
  const int g = lane >> 2, t = lane & 3;
  for (int it = warp; it < items; it += nwarps) {
    const int mb = it / nblocks;
    const int m0 = mb * kRows, np0 = (it - mb * nblocks) * 2;
    const int npv = min(2, npairs - np0);
    float acc[MT][4][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    // The K walk, one tile ahead: the fragments of the next K tile are
    // loaded before the MMAs of this one are issued, so a warp waits for a
    // load once, not once a tile.
    const uint4* b = reinterpret_cast<const uint4*>(wb) + (size_t)np0 * 32 + lane;
    uint32_t a_addr[MT], a_cur[MT][4], a_nxt[MT][4];
    uint4 b_cur[2], b_nxt[2];
    int s = 0, kt = 0, kts = kseg(0);
    auto seg_start = [&]() {
#pragma unroll
      for (int i = 0; i < MT; ++i)
        a_addr[i] = mma::smem_u32(aseg(s, min(m0 + i * 16 + (lane & 15), P - 1))) +
                    (lane >> 4) * 16;
    };
    auto load = [&](uint32_t (&a)[MT][4], uint4 (&bb)[2]) {
#pragma unroll
      for (int i = 0; i < MT; ++i) mma::ldmatrix_x4(a[i], a_addr[i] + kt * 32);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (j < npv) bb[j] = __ldg(b + j * 32);
    };
    seg_start();
    load(a_cur, b_cur);
    for (;;) {
      b += npairs * 32;
      if (++kt == kts) {
        kt = 0;
        if (++s < nseg) {
          kts = kseg(s);
          seg_start();
        }
      }
      const bool more = s < nseg;
      if (more) load(a_nxt, b_nxt);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (j < npv) {
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            mma::mma_16816(acc[i][2 * j], a_cur[i], b_cur[j].x, b_cur[j].y);
            mma::mma_16816(acc[i][2 * j + 1], a_cur[i], b_cur[j].z, b_cur[j].w);
          }
        }
      if (!more) break;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) a_cur[i][e] = a_nxt[i][e];
      b_cur[0] = b_nxt[0];
      b_cur[1] = b_nxt[1];
    }
    // the lane's 8 columns are the same for every row: their biases once
    float bv[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = np0 * 16 + j * 8 + 2 * t;
      const bool on = j < 2 * npv && col < nstore;
      bv[j][0] = on ? bias(col) : 0.f;
      bv[j][1] = on ? bias(col + 1) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + i * 16 + h * 8 + g;
        if (row >= P) continue;
        const ORow o = orow(row);
        if (o.ptr == nullptr) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = np0 * 16 + j * 8 + 2 * t;
          if (j >= 2 * npv || col >= nstore) continue;
          float v0 = acc[i][j][2 * h] + bv[j][0], v1 = acc[i][j][2 * h + 1] + bv[j][1];
          if (SILU) {
            v0 = mma::silu(v0);
            v1 = mma::silu(v1);
          } else {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          if (o.zero) v0 = v1 = 0.f;
          mma::store_bf162(o.ptr + col, v0, v1);
        }
      }
  }
}

// x / w and x % w for 0 <= x < 2^20 and a small w by a float multiply with
// inv = 1 / w (the margin (x + 0.5) / w keeps to either neighbouring integer
// is at least 0.5 / w, far above the rounding error): a few instructions
// where an integer division takes about twenty.
struct FastDiv {
  int w;
  float inv;
  __device__ __forceinline__ explicit FastDiv(int w_) : w(w_), inv(1.f / (float)w_) {}
  __device__ __forceinline__ int div(int x) const {
    return __float2int_rz(((float)x + 0.5f) * inv);
  }
  __device__ __forceinline__ void divmod(int x, int& q, int& r) const {
    q = div(x);
    r = x - q * w;
  }
};

__device__ __forceinline__ void load8(float (&acc)[8], const float* __restrict__ p) {
  const float4 a = ldg4(p), b = ldg4(p + 4);
  acc[0] = a.x; acc[1] = a.y; acc[2] = a.z; acc[3] = a.w;
  acc[4] = b.x; acc[5] = b.y; acc[6] = b.z; acc[7] = b.w;
}

template <bool kL2>
__global__ void __launch_bounds__(kMaxThreads)
frontend_mma_kernel(const uint8_t* __restrict__ img, const float* __restrict__ w,
                    const __nv_bfloat16* __restrict__ wm, __nv_bfloat16* __restrict__ out,
                    Dims d, PlanB p, int tiles_x, unsigned long long* __restrict__ prof) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* s_l0 = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s_t = s_l0;                   // expand output, Ri x Ri x midp
  __nv_bfloat16* s_dw = s_l0 + p.dw_off;       // DW output, Rn x Rn x midp
  uint8_t* s_in = smem_raw + p.off_b;
  __nv_bfloat16* s_l1 = reinterpret_cast<__nv_bfloat16*>(smem_raw + p.off_b);
  __nv_bfloat16* s_ys = s_l1;
  __nv_bfloat16* s_x2 = reinterpret_cast<__nv_bfloat16*>(smem_raw + p.off_c);

  const WOff wo = weight_offsets(d);
  const WOffB wb = mma_offsets(d);
  const int tid = threadIdx.x, nth = blockDim.x;
  const int b = blockIdx.y;
  const int ty = blockIdx.x / tiles_x, tx = blockIdx.x % tiles_x;
  const int D = d.depth;
  const int H0 = d.H / 2, W0 = d.W / 2, H1 = d.H / 4, W1 = d.W / 4;
  const int y1o = ty * p.th - D, x1o = tx * p.tw - D;   // L1 grid origin
  const int y0o = 2 * y1o - 1, x0o = 2 * x1o - 1;       // L0 grid origin
  const int yio = 2 * y0o - 1, xio = 2 * x0o - 1;       // input window origin
  const uint4 zero16 = make_uint4(0u, 0u, 0u, 0u);
  // With `prof` (the tuning entry point only) thread 0 of every block adds
  // the clocks of each phase, barrier included, to prof[phase]: 0 input, 1 L0,
  // 2 L1, 3 cv_in, 4 expand, 5 DW, 6 project, 7 cv_out.
  unsigned long long t0 = prof ? clock64() : 0;
  auto phase_end = [&](int phase) {
    __syncthreads();
    if (prof && tid == 0) {
      const unsigned long long t1 = clock64();
      atomicAdd(prof + phase, t1 - t0);
      t0 = t1;
    }
  };

  // Phase 0: input window, zero outside the image. A window row is one run
  // of bytes in the image; it is copied as the aligned 32-bit words that
  // cover it (an image row is W * 3 bytes, a multiple of 4, so a word lies
  // inside the image or outside it), and `shift` bytes into the first word
  // the window begins.
  const int shift = (xio * 3) & 3;
  {
    const uint8_t* im = img + (size_t)b * d.H * d.W * 3;
    const int wb3 = d.W * 3, a0 = xio * 3 - shift, nw = p.in_pitch / 4;
    uint32_t* s_in32 = reinterpret_cast<uint32_t*>(s_in);
    for (int i = tid; i < p.rinh * nw; i += nth) {
      const int r = i / nw, j = i - r * nw;
      const int gy = yio + r, gxb = a0 + 4 * j;
      s_in32[i] = (gy >= 0 && gy < d.H && gxb >= 0 && gxb < wb3)
                      ? __ldg(reinterpret_cast<const uint32_t*>(im + (size_t)gy * wb3 + gxb))
                      : 0u;
    }
  }
  phase_end(0);

  // Phase 1: L0 over r0h x r0w as a GEMM on the tensor cores: rows are L0
  // pixels, K = 27 taps (u, v, ci) padded to 32, and a lane builds its A
  // fragment straight from the window's bytes (0..255 are exact in bf16; /255
  // and the BGR flip sit in the weights). The B fragments do not change from
  // item to item and stay in registers. Zero outside the H/2 image (L1's
  // padding) and in the pad channels (zero weights and bias). A row is
  // stored as its even columns, then its odd ones, so that L1's stride-2
  // taps read neighbouring pixels.
  {
    const int lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int np = p.c0p / 16;
    uint4 bfr[2][kMaxNp0];
    int koff[2][4];
#pragma unroll
    for (int kt = 0; kt < 2; ++kt) {
#pragma unroll
      for (int j = 0; j < kMaxNp0; ++j)
        bfr[kt][j] = j < np ? __ldg(reinterpret_cast<const uint4*>(wm + wb.w0) +
                                    (kt * np + j) * 32 + lane)
                            : zero16;
#pragma unroll
      for (int q = 0; q < 4; ++q) {   // k of a0.lo, a0.hi, a2.lo, a2.hi
        const int k = kt * 16 + (q >> 1) * 8 + 2 * t + (q & 1);
        koff[kt][q] = k < 27 ? (k / 9) * p.in_pitch + k % 9 : -1;
      }
    }
    const int P = p.r0h * p.r0w;
    const FastDiv by_r0w(p.r0w);
    for (int it = tid >> 5; it < (P + 15) / 16; it += nth >> 5) {
      const uint8_t* src[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int ry, rx;
        by_r0w.divmod(min(it * 16 + h * 8 + g, P - 1), ry, rx);
        src[h] = s_in + 2 * ry * p.in_pitch + shift + 2 * rx * 3;
      }
      float acc[2 * kMaxNp0][4];
#pragma unroll
      for (int j = 0; j < 2 * kMaxNp0; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
      for (int kt = 0; kt < 2; ++kt) {
        float v[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            v[h][q] = koff[kt][q] >= 0 ? (float)src[h][koff[kt][q]] : 0.f;
        const uint32_t a[4] = {mma::pack_bf162(v[0][0], v[0][1]), mma::pack_bf162(v[1][0], v[1][1]),
                               mma::pack_bf162(v[0][2], v[0][3]), mma::pack_bf162(v[1][2], v[1][3])};
#pragma unroll
        for (int j = 0; j < kMaxNp0; ++j)
          if (j < np) {
            mma::mma_16816(acc[2 * j], a, bfr[kt][j].x, bfr[kt][j].y);
            mma::mma_16816(acc[2 * j + 1], a, bfr[kt][j].z, bfr[kt][j].w);
          }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int px = it * 16 + h * 8 + g;
        if (px >= P) continue;
        int ry, rx;
        by_r0w.divmod(px, ry, rx);
        const int gy = y0o + ry, gx = x0o + rx;
        const bool inside = gy >= 0 && gy < H0 && gx >= 0 && gx < W0;
        __nv_bfloat16* dst = s_l0 + ((size_t)(ry * 2 + (rx & 1)) * p.hw0 + (rx >> 1)) * p.s0;
#pragma unroll
        for (int j = 0; j < 2 * kMaxNp0; ++j) {
          const int col = j * 8 + 2 * t;
          if (col >= p.c0p) continue;
          float v0 = 0.f, v1 = 0.f;
          if (inside && col < d.c0) {
            v0 = fmaxf(acc[j][2 * h] + __ldg(w + wo.b0 + col), 0.f);
            v1 = fmaxf(acc[j][2 * h + 1] + __ldg(w + wo.b0 + col + 1), 0.f);
          }
          mma::store_bf162(dst + col, v0, v1);
        }
      }
    }
  }
  phase_end(1);

  // Phase 2: L1 over r1h x r1w as an implicit GEMM, K = 9 taps x c0p.
  // Values outside the image are never read unmasked: they feed only expand
  // outputs, which are zeroed there.
  const FastDiv by_r1w(p.r1w);
  mma_phase<false, 2>(
      p.r1h * p.r1w, 9,
      [&](int s, int row) {
        int py, px;
        by_r1w.divmod(row, py, px);
        const int u = s / 3, v = s % 3;
        return s_l0 + ((size_t)((2 * py + u) * 2 + (v & 1)) * p.hw0 + px + (v >> 1)) * p.s0;
      },
      [&](int) { return p.c0p / 16; }, wm + wb.w1, p.c1p / 16,
      [&](int col) { return col < d.c1 ? __ldg(w + wo.b1 + col) : 0.f; }, p.c1p,
      [&](int row) { return ORow{s_l1 + (size_t)row * p.s1, false}; });
  phase_end(2);

  if constexpr (!kL2) {
    // Layers 0-1: the L1 grid is the tile. Its rows go out from shared
    // memory as 16-byte words (8 channels), a pixel's words and a tile row's
    // pixels next to each other in the output.
    const int nv = d.c1 / 8, items = p.th * p.tw * nv;
    const FastDiv by_nv(nv), by_tw(p.tw);
    for (int it = tid; it < items; it += nth) {
      int row, v, ry, rx;
      by_nv.divmod(it, row, v);
      by_tw.divmod(row, ry, rx);
      const int Y = ty * p.th + ry, X = tx * p.tw + rx;
      if (Y < H1 && X < W1)
        *reinterpret_cast<uint4*>(out + (((size_t)b * H1 + Y) * W1 + X) * d.c1 + v * 8) =
            *reinterpret_cast<const uint4*>(s_l1 + (size_t)row * p.s1 + v * 8);
    }
    if (prof) phase_end(7);
    return;
  }

  // Phase 3: x2 = silu(cv_in(L1)), stored [a | b], each half csp wide.
  mma_phase<true, 2>(
      p.r1h * p.r1w, 1, [&](int, int row) { return s_l1 + (size_t)row * p.s1; },
      [&](int) { return p.c1p / 16; }, wm + wb.win, 2 * p.csp / 16,
      [&](int col) {
        const int half = col >= p.csp, c = col - half * p.csp;
        return c < d.cs ? __ldg(w + wo.bin + half * d.cs + c) : 0.f;
      },
      2 * p.csp, [&](int row) { return ORow{s_x2 + (size_t)row * p.sx, false}; });
  phase_end(3);

  // Phase 4: the bottleneck chain. Bottleneck m reads the grid Ri = R1 - 2m
  // (offset m from the R1 grid) and writes y_m on Rn = Ri - 2.
  const __nv_bfloat16* y_prev = nullptr;
  int yoff = 0;
  for (int m = 0; m < D; ++m) {
    const int rih = p.r1h - 2 * m, riw = p.r1w - 2 * m, rnh = rih - 2, rnw = riw - 2;
    const float* bexp = w + wo.m0 + m * wo.mstride + d.cs * d.mid;
    const float* wdw = bexp + d.mid;
    const float* bdw = wdw + 9 * d.mid;
    const float* bproj = bdw + d.mid + d.mid * d.cs;
    const __nv_bfloat16* wexp = wm + wb.m0 + m * wb.mstride;
    const FastDiv by_riw(riw);
    mma_phase<true, 1>(
        rih * riw, 1,
        [&](int, int row) {
          return m == 0 ? s_x2 + (size_t)row * p.sx + p.csp : y_prev + (size_t)row * p.sy;
        },
        [&](int) { return p.csp / 16; }, wexp, p.midp / 16,
        [&](int col) { return col < d.mid ? __ldg(bexp + col) : 0.f; }, p.midp,
        [&](int row) {
          int ry, rx;
          by_riw.divmod(row, ry, rx);
          const int gy = y1o + m + ry, gx = x1o + m + rx;
          return ORow{s_t + (size_t)row * p.st, gy < 0 || gy >= H1 || gx < 0 || gx >= W1};
        });
    phase_end(4);
    {
      // one work item: 8 channels x a run of 2 pixels along W, so a tap and
      // its weights feed two outputs
      const int ncg = p.midp / 8, runs = (rnw + 1) / 2, items = rnh * runs * ncg;
      const FastDiv by_ncg(ncg), by_runs(runs);
      for (int it = tid; it < items; it += nth) {
        int pr, o, yy, xx;
        by_ncg.divmod(it, pr, o);
        by_runs.divmod(pr, yy, xx);
        o *= 8;
        xx *= 2;
        const bool two = xx + 1 < rnw;
        __nv_bfloat16* dst = s_dw + (size_t)(yy * rnw + xx) * p.st + o;
        if (o >= d.mid) {
          *reinterpret_cast<uint4*>(dst) = zero16;
          if (two) *reinterpret_cast<uint4*>(dst + p.st) = zero16;
          continue;
        }
        const __nv_bfloat16* src = s_t + (size_t)(yy * riw + xx) * p.st + o;
        float acc0[8], acc1[8];
        load8(acc0, bdw + o);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc1[e] = acc0[e];
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          float wk[3][8];
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) load8(wk[kx], wdw + (ky * 3 + kx) * d.mid + o);
#pragma unroll
          for (int j = 0; j < 4; ++j) {   // input columns xx .. xx + 3
            if (j == 3 && !two) continue;   // the last column of the Ri grid is xx + 2
            float x[8];
            mma::unpack8(*reinterpret_cast<const uint4*>(src + (ky * riw + j) * p.st), x);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              if (j < 3) acc0[e] = fmaf(wk[j][e], x[e], acc0[e]);
              if (j > 0) acc1[e] = fmaf(wk[j - 1][e], x[e], acc1[e]);
            }
          }
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          acc0[e] = mma::silu(acc0[e]);
          acc1[e] = mma::silu(acc1[e]);
        }
        *reinterpret_cast<uint4*>(dst) = mma::pack8(acc0);
        if (two) *reinterpret_cast<uint4*>(dst + p.st) = mma::pack8(acc1);
      }
    }
    phase_end(5);
    __nv_bfloat16* y = s_ys + yoff;
    mma_phase<true, 1>(
        rnh * rnw, 1, [&](int, int row) { return s_dw + (size_t)row * p.st; },
        [&](int) { return p.midp / 16; }, wexp + wb.wexp_len, p.csp / 16,
        [&](int col) { return col < d.cs ? __ldg(bproj + col) : 0.f; }, p.csp,
        [&](int row) { return ORow{y + (size_t)row * p.sy, false}; });
    phase_end(6);
    y_prev = y;
    yoff += rnh * rnw * p.sy;
  }

  // Phase 5: cv_out over the tile: one K segment for x2 = [a | b] and one
  // per y part, each read at the tile's offset inside its grid.
  const FastDiv by_tw(p.tw);
  mma_phase<true, 1>(
      p.th * p.tw, 1 + D,
      [&](int s, int row) {
        int ry, rx;
        by_tw.divmod(row, ry, rx);
        if (s == 0) return s_x2 + (size_t)((ry + D) * p.r1w + rx + D) * p.sx;
        int off = 0;
        for (int m = 0; m < s - 1; ++m)
          off += (p.r1h - 2 * (m + 1)) * (p.r1w - 2 * (m + 1)) * p.sy;
        const int rnw = p.r1w - 2 * s, e = D - s;
        return s_ys + off + (size_t)((ry + e) * rnw + rx + e) * p.sy;
      },
      [&](int s) { return (s == 0 ? 2 : 1) * p.csp / 16; }, wm + wb.wout, p.c2p / 16,
      [&](int col) { return col < d.c2 ? __ldg(w + wo.bout + col) : 0.f; }, d.c2,
      [&](int row) {
        int ry, rx;
        by_tw.divmod(row, ry, rx);
        const int Y = ty * p.th + ry, X = tx * p.tw + rx;
        return ORow{Y < H1 && X < W1 ? out + (((size_t)b * H1 + Y) * W1 + X) * d.c2 : nullptr,
                    false};
      });
  if (prof) phase_end(7);
}

// The largest tile of the list whose footprint fits the card's per-block
// shared memory: the larger the tile, the smaller the share of halo pixels
// that L0 and L1 compute again. 256 threads when two blocks share an SM,
// 512 when one block holds it alone.
cudaError_t pick_plan_b(const Dims& d, PlanB* out) {
  int dev = 0, max_smem = 0, sm_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err != cudaSuccess) return err;
  const int tiles[][2] = {{16, 16}, {8, 16}, {8, 8}, {4, 8}, {4, 4}};
  for (const auto& t : tiles) {
    *out = make_plan_b(d, t[0], t[1]);
    if (out->bytes <= (size_t)max_smem) {
      // a block also reserves 1 KB of the SM's shared memory
      out->threads = 2 * (out->bytes + 1024) <= (size_t)sm_smem ? 256 : 512;
      return cudaSuccess;
    }
  }
  return cudaErrorInvalidConfiguration;
}

template <bool kL2>
int launch_mma_t(const uint8_t* img, const float* w, const __nv_bfloat16* wm,
                 __nv_bfloat16* out, Dims d, const PlanB& p, unsigned long long* prof,
                 void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      frontend_mma_kernel<kL2>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.bytes);
  if (err != cudaSuccess) return (int)err;
  const int h1 = d.H / 4, w1 = d.W / 4;
  const int tiles_x = (w1 + p.tw - 1) / p.tw, tiles_y = (h1 + p.th - 1) / p.th;
  dim3 grid(tiles_x * tiles_y, d.B);
  frontend_mma_kernel<kL2><<<grid, p.threads, p.bytes, (cudaStream_t)stream>>>(
      img, w, wm, out, d, p, tiles_x, prof);
  return (int)cudaGetLastError();
}

int launch_mma(const uint8_t* img, const float* w, const __nv_bfloat16* wm,
               __nv_bfloat16* out, Dims d, const PlanB& p, unsigned long long* prof,
               void* stream) {
  // 16-byte activation vectors and weight rows: every width a multiple of 8
  // (all MAF-YOLO and YOLOv6 widths are); layer 0 keeps its B fragments in
  // registers, c0 <= 64.
  if (d.H % 4 || d.W % 4 || !layers01_ok(d) || d.B < 1 || d.c0 % 8 ||
      d.c1 % 8 || d.cs % 8 || d.mid % 8 || d.c2 % 8 || d.c0 > 16 * kMaxNp0)
    return (int)cudaErrorInvalidValue;
  return d.depth ? launch_mma_t<true>(img, w, wm, out, d, p, prof, stream)
                 : launch_mma_t<false>(img, w, wm, out, d, p, prof, stream);
}

}  // namespace

extern "C" int frontend_f32(const uint8_t* img, const float* w, float* out,
                            int B, int H, int W, int c0, int c1, int cs,
                            int mid, int depth, int c2, void* stream) {
  return launch<float>(img, w, out, Dims{B, H, W, c0, c1, cs, mid, depth, c2}, stream);
}

extern "C" int frontend_bf16(const uint8_t* img, const float* w, const void* wm, void* out,
                             int B, int H, int W, int c0, int c1, int cs,
                             int mid, int depth, int c2, void* stream) {
  const Dims d{B, H, W, c0, c1, cs, mid, depth, c2};
  PlanB p;
  const cudaError_t err = pick_plan_b(d, &p);
  if (err != cudaSuccess) return (int)err;
  return launch_mma(img, w, static_cast<const __nv_bfloat16*>(wm),
                    static_cast<__nv_bfloat16*>(out), d, p, nullptr, stream);
}

// The bf16 kernel with a given tile and block size, for tuning the plan
// (tools/tune_kernels.py); fails if the tile does not fit. prof: null, or 8
// counters that receive the clocks of each phase summed over the blocks (in
// the layers-0-1 mode the store of L1 counts as phase 7).
extern "C" int frontend_bf16_tile(const uint8_t* img, const float* w, const void* wm,
                                  void* out, int B, int H, int W, int c0, int c1, int cs,
                                  int mid, int depth, int c2, int th, int tw, int threads,
                                  unsigned long long* prof, void* stream) {
  const Dims d{B, H, W, c0, c1, cs, mid, depth, c2};
  if (th < 1 || tw < 1 || threads < 32 || threads > kMaxThreads || threads % 32)
    return (int)cudaErrorInvalidValue;
  PlanB p = make_plan_b(d, th, tw);
  p.threads = threads;
  return launch_mma(img, w, static_cast<const __nv_bfloat16*>(wm),
                    static_cast<__nv_bfloat16*>(out), d, p, prof, stream);
}

// Packed weight lengths, so the host can check its buffers: f32 elements,
// and bf16 elements of the MMA pack. At depth 0 (cs = mid = c2 = 0) the
// layer-2 parts have no length: w0, b0, w1, b1 alone.
extern "C" int frontend_weight_len(int c0, int c1, int cs, int mid, int depth, int c2) {
  Dims d{0, 0, 0, c0, c1, cs, mid, depth, c2};
  return weight_offsets(d).bout + c2;
}

extern "C" int frontend_mma_weight_len(int c0, int c1, int cs, int mid, int depth, int c2) {
  Dims d{0, 0, 0, c0, c1, cs, mid, depth, c2};
  return mma_offsets(d).total;
}

// Tile, shared-memory bytes and block size chosen for these widths by the
// bf16 kernel (bf16 != 0) or the f32 kernel.
extern "C" int frontend_plan(int c0, int c1, int cs, int mid, int depth, int c2, int bf16,
                             int* tile_h, int* tile_w, int* smem_bytes, int* threads) {
  Dims d{0, 0, 0, c0, c1, cs, mid, depth, c2};
  if (bf16) {
    PlanB p;
    cudaError_t err = pick_plan_b(d, &p);
    if (err != cudaSuccess) return (int)err;
    *tile_h = p.th;
    *tile_w = p.tw;
    *smem_bytes = (int)p.bytes;
    *threads = p.threads;
    return 0;
  }
  Plan p;
  cudaError_t err = pick_plan(d, &p);
  if (err != cudaSuccess) return (int)err;
  *tile_h = *tile_w = p.t;
  *smem_bytes = (int)p.bytes;
  *threads = p.threads;
  return 0;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
