// P3 neck cluster: deploy layers 19-22 of the MAF graphs,
//   y20 = RepHDW20(Concat(x18, x4, x17u)),  y22 = RepHDW22(Concat(y20, x17u)),
// each RepHDW deploy form with k=5 depthwise bottlenecks (models/blocks.py):
//   x2 = silu(cv_in(x)); parts = [a, b] = split(x2)
//   for i < depth: parts += silu(project(silu(dw5(silu(expand(parts[-1]))) + bdw)))
//   y = silu(cv_out(parts))
//
// Replaces: mafyolo_tpu/ops/neck_pallas.py:neck80_forward (_kernel).
//
// Inputs NHWC [B, H, W, C_i] (x18, x4, x17u) in f32 or bf16; outputs y20 and
// y22 NHWC in the same type. Weights f32, packed by ops/neck.py:neck80_build
// in the order of neck80_weight_len below: for each layer, cv_in [Cin, 2c_]
// (rows in source order), its bias, then per bottleneck expand [c_, mid],
// bias, dw [25, mid], bias, project [mid, c_], bias, then cv_out
// [(2+depth)c_, cout] (rows in CSP order a, b, y0, ...), bias.
//
// One entry point per element type, a short chain of launches on the
// caller's stream:
//   * a 1x1 conv + bias + SiLU as a tiled GEMM over pixels, reading up to
//     three sources, each with its own block of weight rows. So neither
//     Concat (rows 19 and 21) is materialised: cv_in sums one partial
//     product per source. The CSP parts of a layer live in one buffer
//     [P, (2+depth)c_], each written into its slot by its producer (cv_in
//     writes a and b, each project its y_i), so the expands read their part
//     in place and cv_out reads all parts as one source.
//   * the biased 5x5 depthwise conv + SiLU on the whole expand output. That
//     output exists only inside the image, so the taps outside it read
//     zeros: the conv's zero padding, whatever the biases (the halo leak
//     that neck_pallas.py:233 guards with its inimg mask).
//
// Bound on the H100: the matrix-product rate. At S bs32 @ 640 (h = 80) the
// 1x1 convs are about 107 GFMA, while inputs plus outputs are about 330 MB.
//   * bf16 (pw_mma_kernel, dw5_bf16_kernel): the GEMM runs on the tensor
//     cores, bf16 mma.sync m16n8k16 with f32 accumulation
//     (csrc/mma_bf16.cuh): a block takes 256 pixels x 64 output channels,
//     its A tiles come by 16-byte cp.async into a ring of three 32-deep
//     stages (rows padded to 80 bytes: conflict-free ldmatrix), B comes
//     the same way as whole fragments of the host-packed bf16 weights, and
//     bias + SiLU
//     go from the accumulators into the CSP slot. The K loop walks the
//     sources in turn. The DW stages a 16 x 16 pixel tile's input window
//     for 32 channels in shared memory and gives a thread 8 channels (one
//     16-byte read a tap) and a run of 8 pixels along W, so a tap read
//     feeds up to 5 outputs from registers.
//   * f32 (pw_kernel, dw5_kernel): 64x64 tiles on the CUDA cores, 4x4
//     outputs a thread, operands staged in shared memory; one thread per
//     (pixel, channel) in the DW.
// Intermediates are stored in the input type, accumulation is always f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace {

constexpr int kBM = 64;        // pixels per tile
constexpr int kBN = 64;        // output channels per tile
constexpr int kBK = 16;        // reduction depth per stage
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kMaxSrc = 3;

struct Src {
  const void* x;   // first channel of the source; pixel p at x + p * stride
  int stride;      // elements between pixels
  int k;           // channels read
  const float* w;  // [k, n] weight rows of this source
};

struct Pw {
  Src src[kMaxSrc];
  int nsrc;
  const float* bias;   // [n]
  void* out;           // first channel of the destination
  int out_stride;
  int n;
  long long p;         // pixels
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

template <typename T>
__global__ void __launch_bounds__(kThreads) pw_kernel(const Pw a) {
  // +4: the transposed stores of the A tile fall on different banks, and
  // rows stay 16-byte aligned for the float4 reads
  __shared__ __align__(16) float As[kBK][kBM + 4];
  __shared__ __align__(16) float Bs[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long p0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  float acc[4][4] = {};

  for (int s = 0; s < a.nsrc; ++s) {
    const Src src = a.src[s];
    const T* x = static_cast<const T*>(src.x);
    for (int k0 = 0; k0 < src.k; k0 += kBK) {
#pragma unroll
      for (int j = 0; j < kBM * kBK / kThreads; ++j) {
        const int e = tid + j * kThreads;
        const int kk = e % kBK, pp = e / kBK;   // neighbouring threads, neighbouring channels
        const long long p = p0 + pp;
        const int k = k0 + kk;
        As[kk][pp] = (p < a.p && k < src.k) ? ld(x + p * src.stride + k) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kBN * kBK / kThreads; ++j) {
        const int e = tid + j * kThreads;
        const int nn = e % kBN, kk = e / kBN;
        const int n = n0 + nn, k = k0 + kk;
        Bs[kk][nn] = (n < a.n && k < src.k) ? src.w[(long long)k * a.n + n] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
        const float ar[4] = {av.x, av.y, av.z, av.w};
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long p = p0 + ty * 4 + i;
    if (p >= a.p) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < a.n) st(out + p * a.out_stride + n, silu(acc[i][j] + a.bias[n]));
    }
  }
}

// One thread per (pixel, channel); neighbouring threads read neighbouring
// channels, and the 25 taps of neighbouring pixels meet in L1.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dw5_kernel(const T* __restrict__ x, const float* __restrict__ w,
           const float* __restrict__ bias, T* __restrict__ y, int B, int H,
           int W, int C) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * H * W * C) return;
  const int c = (int)(i % C);
  const long long p = i / C;
  const int px = (int)(p % W);
  const int py = (int)((p / W) % H);
  const long long img = p / ((long long)W * H);
  float acc = bias[c];
#pragma unroll
  for (int dy = 0; dy < 5; ++dy) {
    const int iy = py + dy - 2;
    if (iy < 0 || iy >= H) continue;
#pragma unroll
    for (int dx = 0; dx < 5; ++dx) {
      const int ix = px + dx - 2;
      if (ix < 0 || ix >= W) continue;
      acc = fmaf(ld(x + ((img * H + iy) * W + ix) * C + c), __ldg(w + (dy * 5 + dx) * C + c), acc);
    }
  }
  st(y + i, silu(acc));
}

// ---- bf16: the GEMM on the tensor cores
constexpr int kMT = 4;               // 16-row M tiles per warp
constexpr int kMM = 4 * kMT * 16;    // pixels per block: 4 warps deep
constexpr int kMN = 64;              // output channels per block
constexpr int kMK = 32;              // reduction depth per stage
constexpr int kStages = 3;
constexpr int kAStride = kMK + 8;    // 80-byte rows: conflict-free ldmatrix
constexpr int kABytes = kStages * kMM * kAStride * 2;
constexpr int kPwSmem = kABytes + kStages * (kMK / 16) * (kMN / 16) * 32 * 16;

// Position in the K walk over the sources: source, offset in it, and the
// index of its K tile in the packed weights.
struct KPos {
  int s, k0, kt;
};

__device__ __forceinline__ void advance(KPos& q, const Pw& a) {
  const int left = a.src[q.s].k - q.k0;
  q.kt += min(left, kMK) / 16;
  q.k0 += kMK;
  if (q.k0 >= a.src[q.s].k) {
    ++q.s;
    q.k0 = 0;
  }
}

// 8 warps as 4 (pixels) x 2 (channels), a warp tile of 64 x 32: a B fragment
// feeds four M tiles, so the loads, the copies' address arithmetic and the
// barrier of a stage are spread over 32 MMAs a warp. Every source's k is a
// multiple of 16 and a.n one of 32 (checked by the caller).
__global__ void __launch_bounds__(kThreads)
pw_mma_kernel(const Pw a, const __nv_bfloat16* __restrict__ wm) {
  extern __shared__ __align__(16) unsigned char pw_smem[];
  __nv_bfloat16 (*As)[kMM][kAStride] =
      reinterpret_cast<__nv_bfloat16 (*)[kMM][kAStride]>(pw_smem);
  // the block's B fragments of a stage: [K tile][N-tile pair][lane]
  uint4 (*Bs)[kMK / 16][kMN / 16][32] =
      reinterpret_cast<uint4 (*)[kMK / 16][kMN / 16][32]>(pw_smem + kABytes);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp & 3, wc = warp >> 2;
  const long long p0 = (long long)blockIdx.y * kMM;
  const int npairs = a.n / 16;
  const int npb = blockIdx.x * (kMN / 16);   // the block's first N-tile pair
  const int np0 = npb + wc * 2;
  const int npv = max(0, min(2, npairs - np0));
  int total = 0;
  for (int s = 0; s < a.nsrc; ++s) total += (a.src[s].k + kMK - 1) / kMK;

  float acc[kMT][4][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  auto load = [&](const KPos& q, int slot) {
    const Src src = a.src[q.s];
    const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(src.x);
#pragma unroll
    for (int j = 0; j < kMM * (kMK / 8) / kThreads; ++j) {
      const int c = tid + j * kThreads, row = c / (kMK / 8), kc = (c % (kMK / 8)) * 8;
      const long long p = p0 + row;
      const bool valid = p < a.p && q.k0 + kc < src.k;
      const __nv_bfloat16* from = valid ? x + p * src.stride + q.k0 + kc : x;
      mma::cp_async16(mma::smem_u32(&As[slot][row][kc]), from, valid);
    }
    static_assert((kMK / 16) * (kMN / 16) * 32 == kThreads, "one B chunk a thread");
    const int kk = tid / (kMN / 16 * 32), pair = tid / 32 % (kMN / 16);
    const bool valid = q.k0 + kk * 16 < src.k && npb + pair < npairs;
    const uint4* from = reinterpret_cast<const uint4*>(wm) +
                        (valid ? ((size_t)(q.kt + kk) * npairs + npb + pair) * 32 + lane : 0);
    mma::cp_async16(mma::smem_u32(&Bs[slot][kk][pair][lane]), from, valid);
  };

  KPos ld = {0, 0, 0}, cp = {0, 0, 0};
  int issued = 0;
  for (; issued < kStages - 1; ++issued) {
    if (issued < total) {
      load(ld, issued % kStages);
      advance(ld, a);
    }
    mma::cp_async_commit();
  }
  for (int step = 0; step < total; ++step, ++issued) {
    mma::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (issued < total) {
      load(ld, issued % kStages);
      advance(ld, a);
    }
    mma::cp_async_commit();
    const int slot = step % kStages;
    const int kts = min(a.src[cp.s].k - cp.k0, kMK) / 16;
    for (int kk = 0; kk < kts; ++kk) {
      uint32_t a_addr[kMT];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
        a_addr[i] = mma::smem_u32(
            &As[slot][(wr * kMT + i) * 16 + (lane & 15)][kk * 16 + (lane >> 4) * 8]);
      mma::mma_ktile<kMT, 2>(acc, a_addr, &Bs[slot][kk][wc * 2][lane], npv);
    }
    advance(cp, a);
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long p = p0 + (wr * kMT + i) * 16 + h * 8 + g;
      if (p >= a.p) continue;
      // The packed weights' columns are interleaved (ops/_mma_pack.py), so
      // the lane's 8 values are the real columns 8t .. 8t + 7 of the warp
      // tile: one 16-byte store.
      if (npv < 2) continue;
      const int col = np0 * 16 + 8 * t;
      const float4 b0 = __ldg(reinterpret_cast<const float4*>(a.bias + col));
      const float4 b1 = __ldg(reinterpret_cast<const float4*>(a.bias + col + 4));
      const float v[8] = {
          mma::silu(acc[i][0][2 * h] + b0.x), mma::silu(acc[i][0][2 * h + 1] + b0.y),
          mma::silu(acc[i][1][2 * h] + b0.z), mma::silu(acc[i][1][2 * h + 1] + b0.w),
          mma::silu(acc[i][2][2 * h] + b1.x), mma::silu(acc[i][2][2 * h + 1] + b1.y),
          mma::silu(acc[i][3][2 * h] + b1.z), mma::silu(acc[i][3][2 * h + 1] + b1.w)};
      *reinterpret_cast<uint4*>(out + p * a.out_stride + col) = mma::pack8(v);
    }
}

// bf16 DW: a block stages the 20 x 20 input window of a 16 x 16 pixel tile
// for 32 channels in shared memory (zeros outside the image: the conv's
// padding), so each input is read from device memory once per tile. A
// thread then takes 8 channels (one 16-byte read a tap) and a run of 8
// pixels along W, so a tap read feeds up to 5 outputs from registers and a
// row of weights is loaded once for 8 outputs.
// Pixels are 80 bytes apart in the tile: the 16-byte reads of a quarter
// warp fall on different banks. C % 8 == 0.
constexpr int kDwTH = 16, kDwTW = 16, kDwCC = 32, kDwRun = 8;
constexpr int kDwPix = kDwCC + 8;
constexpr int kDwThreads = kDwTH * (kDwTW / kDwRun) * (kDwCC / 8);

__global__ void __launch_bounds__(kDwThreads)
dw5_bf16_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, __nv_bfloat16* __restrict__ y, int H, int W,
                int C) {
  __shared__ __align__(16) __nv_bfloat16 tile[(kDwTH + 4) * (kDwTW + 4) * kDwPix];
  const int tiles_x = (W + kDwTW - 1) / kDwTW;
  const int ty = blockIdx.x / tiles_x, tx = blockIdx.x % tiles_x;
  const int c0 = blockIdx.y * kDwCC;
  const long long img = blockIdx.z;
  const int y0 = ty * kDwTH - 2, x0 = tx * kDwTW - 2;
  for (int i = threadIdx.x; i < (kDwTH + 4) * (kDwTW + 4) * (kDwCC / 8); i += kDwThreads) {
    const int cg = i % (kDwCC / 8), px = i / (kDwCC / 8);
    const int gy = y0 + px / (kDwTW + 4), gx = x0 + px % (kDwTW + 4), c = c0 + cg * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < C)
      v = __ldg(reinterpret_cast<const uint4*>(x + ((img * H + gy) * W + gx) * C + c));
    *reinterpret_cast<uint4*>(tile + px * kDwPix + cg * 8) = v;
  }
  __syncthreads();
  const int cg = threadIdx.x % (kDwCC / 8);
  const int run = threadIdx.x / (kDwCC / 8) % (kDwTW / kDwRun);
  const int row = threadIdx.x / (kDwCC / 8 * (kDwTW / kDwRun));
  const int c = c0 + cg * 8, py = ty * kDwTH + row, px0 = tx * kDwTW + run * kDwRun;
  if (c >= C || py >= H || px0 >= W) return;
  float acc[kDwRun][8];
  {
    const float4 b0 = __ldg(reinterpret_cast<const float4*>(bias + c));
    const float4 b1 = __ldg(reinterpret_cast<const float4*>(bias + c + 4));
#pragma unroll
    for (int o = 0; o < kDwRun; ++o) {
      acc[o][0] = b0.x; acc[o][1] = b0.y; acc[o][2] = b0.z; acc[o][3] = b0.w;
      acc[o][4] = b1.x; acc[o][5] = b1.y; acc[o][6] = b1.z; acc[o][7] = b1.w;
    }
  }
#pragma unroll
  for (int dy = 0; dy < 5; ++dy) {
    float wr[5][8];
#pragma unroll
    for (int dx = 0; dx < 5; ++dx) {
      const float* wp = w + (long long)(dy * 5 + dx) * C + c;
      const float4 w0 = __ldg(reinterpret_cast<const float4*>(wp));
      const float4 w1 = __ldg(reinterpret_cast<const float4*>(wp + 4));
      wr[dx][0] = w0.x; wr[dx][1] = w0.y; wr[dx][2] = w0.z; wr[dx][3] = w0.w;
      wr[dx][4] = w1.x; wr[dx][5] = w1.y; wr[dx][6] = w1.z; wr[dx][7] = w1.w;
    }
    const __nv_bfloat16* trow = tile + ((row + dy) * (kDwTW + 4) + run * kDwRun) * kDwPix + cg * 8;
#pragma unroll
    for (int j = 0; j < kDwRun + 4; ++j) {
      float xv[8];
      mma::unpack8(*reinterpret_cast<const uint4*>(trow + j * kDwPix), xv);
#pragma unroll
      for (int o = 0; o < kDwRun; ++o) {
        const int dx = j - o;
        if (dx < 0 || dx >= 5) continue;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[o][e] = fmaf(xv[e], wr[dx][e], acc[o][e]);
      }
    }
  }
#pragma unroll
  for (int o = 0; o < kDwRun; ++o) {
    if (px0 + o >= W) continue;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[o][e] = mma::silu(acc[o][e]);
    *reinterpret_cast<uint4*>(y + ((img * H + py) * W + px0 + o) * C + c) = mma::pack8(acc[o]);
  }
}

// bf16 with packed weights `wm` takes the tensor-core GEMM; f32 the
// CUDA-core one.
template <typename T>
int pw(const Pw& a, const __nv_bfloat16* wm, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const dim3 grid((unsigned)((a.n + kMN - 1) / kMN), (unsigned)((a.p + kMM - 1) / kMM));
    const cudaError_t err = cudaFuncSetAttribute(
        pw_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kPwSmem);
    if (err != cudaSuccess) return (int)err;
    pw_mma_kernel<<<grid, kThreads, kPwSmem, stream>>>(a, wm);
  } else {
    const dim3 grid((unsigned)((a.p + kBM - 1) / kBM), (unsigned)((a.n + kBN - 1) / kBN));
    pw_kernel<T><<<grid, kThreads, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dw5(const T* x, const float* w, const float* b, T* y, int B, int H, int W,
        int C, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const dim3 grid((unsigned)(((W + kDwTW - 1) / kDwTW) * ((H + kDwTH - 1) / kDwTH)),
                    (unsigned)((C + kDwCC - 1) / kDwCC), (unsigned)B);
    dw5_bf16_kernel<<<grid, kDwThreads, 0, stream>>>(x, w, b, y, H, W, C);
  } else {
    const long long total = (long long)B * H * W * C;
    dw5_kernel<T><<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
        x, w, b, y, B, H, W, C);
  }
  return (int)cudaGetLastError();
}

long long layer_len(int cin, int c_, int mid, int depth, int cout) {
  return (long long)cin * 2 * c_ + 2 * c_ +
         (long long)depth * ((long long)c_ * mid + mid + 25 * mid + mid + (long long)mid * c_ + c_) +
         (long long)(2 + depth) * c_ * cout + cout;
}

// One deploy RepHDW from `nin` sources to `out` (stride cout); `w` walks the
// packed f32 weights and `wm` the bf16 GEMM weights (one [K, N] block in
// fragment order per 1x1 conv, in launch order; not read for f32). csp
// [P, (2+depth)c_], t and t2 [P, mid] are scratch.
template <typename T>
int rephdw(const Src* ins, int nin, const float*& w, const __nv_bfloat16*& wm, int B, int H,
           int W,
           int c_, int mid, int depth, int cout, T* csp, T* t, T* t2, T* out,
           cudaStream_t stream) {
  const long long P = (long long)B * H * W;
  const int cspw = (2 + depth) * c_;
  Pw a = {};
  int krows = 0;
  for (int s = 0; s < nin; ++s) {
    a.src[s] = ins[s];
    a.src[s].w = w + (long long)krows * 2 * c_;
    krows += ins[s].k;
  }
  w += (long long)krows * 2 * c_;
  a.nsrc = nin;
  a.bias = w;
  w += 2 * c_;
  a.out = csp;
  a.out_stride = cspw;
  a.n = 2 * c_;
  a.p = P;
  int err = pw<T>(a, wm, stream);
  if (wm) wm += (long long)krows * 2 * c_;
  for (int i = 0; i < depth && !err; ++i) {
    Pw e = {};                                   // expand the last part
    e.src[0] = {csp + (1 + i) * c_, cspw, c_, w};
    w += (long long)c_ * mid;
    e.nsrc = 1;
    e.bias = w;
    w += mid;
    e.out = t;
    e.out_stride = mid;
    e.n = mid;
    e.p = P;
    err = pw<T>(e, wm, stream);
    if (wm) wm += (long long)c_ * mid;
    if (!err) err = dw5<T>(t, w, w + 25 * mid, t2, B, H, W, mid, stream);
    w += 26 * mid;
    Pw pr = {};                                  // project into part 2 + i
    pr.src[0] = {t2, mid, mid, w};
    w += (long long)mid * c_;
    pr.nsrc = 1;
    pr.bias = w;
    w += c_;
    pr.out = csp + (2 + i) * c_;
    pr.out_stride = cspw;
    pr.n = c_;
    pr.p = P;
    if (!err) err = pw<T>(pr, wm, stream);
    if (wm) wm += (long long)mid * c_;
  }
  Pw o = {};
  o.src[0] = {csp, cspw, cspw, w};
  w += (long long)cspw * cout;
  o.nsrc = 1;
  o.bias = w;
  w += cout;
  o.out = out;
  o.out_stride = cout;
  o.n = cout;
  o.p = P;
  if (!err) err = pw<T>(o, wm, stream);
  if (wm) wm += (long long)cspw * cout;
  return err;
}

template <typename T>
int run(const void* x18, const void* x4, const void* x17u, const float* w,
        const __nv_bfloat16* wm, void* y20, void* y22, void* csp20, void* csp22, void* t, void* t2,
        int B, int H, int W, int c18, int c4, int c17, int c20, int c22, int d1,
        int d2, int c1_, int mid1, int c2_, int mid2, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || c18 <= 0 || c4 <= 0 || c17 <= 0 || c20 <= 0 ||
      c22 <= 0 || d1 < 0 || d2 < 0 || c1_ <= 0 || mid1 <= 0 || c2_ <= 0 || mid2 <= 0)
    return (int)cudaErrorInvalidValue;
  // the tensor-core GEMM walks K in tiles of 16 and stores 32-column warp
  // tiles (every MAF width allows it)
  if (std::is_same<T, __nv_bfloat16>::value &&
      (wm == nullptr || c18 % 16 || c4 % 16 || c17 % 16 || c20 % 32 || c22 % 32 ||
       c1_ % 32 || mid1 % 32 || c2_ % 32 || mid2 % 32))
    return (int)cudaErrorInvalidValue;
  const Src in20[3] = {{x18, c18, c18, nullptr}, {x4, c4, c4, nullptr},
                       {x17u, c17, c17, nullptr}};
  int err = rephdw<T>(in20, 3, w, wm, B, H, W, c1_, mid1, d1, c20, (T*)csp20, (T*)t,
                      (T*)t2, (T*)y20, stream);
  if (err) return err;
  const Src in22[2] = {{y20, c20, c20, nullptr}, {x17u, c17, c17, nullptr}};
  return rephdw<T>(in22, 2, w, wm, B, H, W, c2_, mid2, d2, c22, (T*)csp22, (T*)t,
                   (T*)t2, (T*)y22, stream);
}

}  // namespace

// Length of the packed f32 weights for these widths.
extern "C" int neck80_weight_len(int c18, int c4, int c17, int c20, int c22, int d1,
                                 int d2, int c1_, int mid1, int c2_, int mid2) {
  return (int)(layer_len(c18 + c4 + c17, c1_, mid1, d1, c20) +
               layer_len(c20 + c17, c2_, mid2, d2, c22));
}

// x18, x4, x17u: NHWC [B,H,W,c*] contiguous; y20 [B,H,W,c20], y22
// [B,H,W,c22]; scratch csp20 [B*H*W, (2+d1)c1_], csp22 [B*H*W, (2+d2)c2_],
// t and t2 [B*H*W, max(mid1, mid2)], all in the one element type; wm: the
// bf16 GEMM weights with interleaved columns (ops/neck.py:neck80_build,
// ops/_mma_pack.py:pack_b), read by the bf16 entry only.
// Returns the cudaError_t of the first launch that failed, else 0.
#define NECK80_ENTRY(NAME, T)                                                          \
  extern "C" int NAME(const void* x18, const void* x4, const void* x17u,               \
                      const float* w, const void* wm, void* y20, void* y22,            \
                      void* csp20, void* csp22,                                        \
                      void* t, void* t2, int B, int H, int W, int c18, int c4,         \
                      int c17, int c20, int c22, int d1, int d2, int c1_, int mid1,    \
                      int c2_, int mid2, void* stream) {                               \
    return run<T>(x18, x4, x17u, w, static_cast<const __nv_bfloat16*>(wm), y20, y22,   \
                  csp20, csp22, t, t2, B, H, W, c18, c4, c17, c20, c22, d1, d2, c1_,   \
                  mid1, c2_, mid2, (cudaStream_t)stream);                              \
  }

NECK80_ENTRY(neck80_f32, float)
NECK80_ENTRY(neck80_bf16, __nv_bfloat16)

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
