// Fused MAF-YOLO front-end: deploy layers 0-2 in one kernel.
//
// Replaces: mafyolo_tpu/ops/frontend_pallas.py:frontend_forward (_kernel).
//
// Computes: uint8 BGR NHWC [B, H, W, 3] (H, W multiples of 4) -> NHWC
// [B, H/4, W/4, c2] in f32 or bf16:
//   L0  relu(conv3x3/s2(x) + b0), /255 and the BGR->RGB flip folded into w0
//   L1  relu(conv3x3/s2(L0) + b1)
//   L2  deploy RepHDW(k=3): x2 = silu(1x1(L1)) split into a | b; a chain of
//       `depth` bottlenecks on b, each expand 1x1+SiLU -> DW3x3+bias+SiLU ->
//       project 1x1+SiLU; cv_out = silu(1x1 over concat [a, b, y0..] ).
// Every conv pads with zeros: L0 values outside the image are 0 before L1
// reads them, and expand outputs outside the image are 0 before the DW
// stencil reads them.
//
// Bound on the H100: device-memory bandwidth and occupancy. The channel
// counts are small (N: 24/48/24/72), so as separate layers the 320- and
// 160-level maps would go to device memory and back several times (at bs32
// @640 the L0 map alone is 315 MB in f32) for little arithmetic each.
// Design: one thread block per T x T output tile at H/4 with all channels.
// It stages in shared memory the input window, L0 over the tile plus halo,
// L1 over the tile plus the DW halo (`depth` pixels a side), and the RepHDW
// intermediates; none of them reaches device memory. Each conv, the DW
// stencil and SiLU run with f32 accumulation; a thread's work item is a
// register tile of 2 pixels x 4 output channels, channel groups fastest, so
// one 16-byte weight read (HWIO, output channel fastest) feeds 8 FMAs and
// activation reads are shared-memory broadcasts. Regions are reused across
// phases (L0's region later holds the expand and DW outputs). T is the
// largest of 8, 4, 2 whose footprint fits the card's per-block shared
// memory (N and S: 8; M: 4). With the maps kept on chip, the work left is
// f32 FMAs on CUDA cores and the shared-memory reads that feed them.
// Tensor cores (wgmma), TMA and overlap of the phases are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v.x, v.y);
  q[1] = __floats2bfloat162_rn(v.z, v.w);
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

template <typename OutT>
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
#pragma unroll
      for (int j = 0; j < PX; ++j)
        if (p0 + j < P) st4(s_l1 + (p0 + j) * d.c1 + o, relu4(acc[j]));
    }
  }
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

template <typename OutT>
int launch(const uint8_t* img, const float* w, OutT* out, Dims d, void* stream) {
  // Every channel count is a multiple of 4 (16-byte weight rows and
  // activation vectors); all MAF-YOLO widths are.
  if (d.H % 4 || d.W % 4 || d.depth < 1 || d.B < 1 || d.c0 % 4 || d.c1 % 4 ||
      d.cs % 4 || d.mid % 4 || d.c2 % 4)
    return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = pick_plan(d, &p);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(frontend_kernel<OutT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.bytes);
  if (err != cudaSuccess) return (int)err;
  const int h1 = d.H / 4, w1 = d.W / 4;
  const int tiles_x = (w1 + p.t - 1) / p.t, tiles_y = (h1 + p.t - 1) / p.t;
  dim3 grid(tiles_x * tiles_y, d.B);
  frontend_kernel<OutT><<<grid, p.threads, p.bytes, (cudaStream_t)stream>>>(
      img, w, out, d, p, tiles_x);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int frontend_f32(const uint8_t* img, const float* w, float* out,
                            int B, int H, int W, int c0, int c1, int cs,
                            int mid, int depth, int c2, void* stream) {
  return launch<float>(img, w, out, Dims{B, H, W, c0, c1, cs, mid, depth, c2}, stream);
}

extern "C" int frontend_bf16(const uint8_t* img, const float* w, void* out,
                             int B, int H, int W, int c0, int c1, int cs,
                             int mid, int depth, int c2, void* stream) {
  return launch<__nv_bfloat16>(img, w, static_cast<__nv_bfloat16*>(out),
                               Dims{B, H, W, c0, c1, cs, mid, depth, c2}, stream);
}

// Packed weight length in floats, so the host can check its buffer.
extern "C" int frontend_weight_len(int c0, int c1, int cs, int mid, int depth, int c2) {
  Dims d{0, 0, 0, c0, c1, cs, mid, depth, c2};
  return weight_offsets(d).bout + c2;
}

// Tile size, shared-memory bytes and block size chosen for these widths.
extern "C" int frontend_plan(int c0, int c1, int cs, int mid, int depth, int c2,
                             int* tile, int* smem_bytes, int* threads) {
  Dims d{0, 0, 0, c0, c1, cs, mid, depth, c2};
  Plan p;
  cudaError_t err = pick_plan(d, &p);
  if (err != cudaSuccess) return (int)err;
  *tile = p.t;
  *smem_bytes = (int)p.bytes;
  *threads = p.threads;
  return 0;
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
