// Depthwise convolution of the deploy graphs in bf16 or f32: stride 1,
// dilation 1, odd k from 3 to 9, 'same' padding k / 2, with the folded bias and the
// activation that follows the conv in one epilogue (the UniRepLKNet DW convs
// of MAF-YOLO's RepHDW bottlenecks, SiLU after, and of its heads, none).
//
// Replaces: no Pallas kernel. The JAX package leaves this conv to XLA
// (mafyolo_tpu/ops/dwconv.py); on the card cuDNN's generic grouped direct
// kernel ran it, and a separate bias add and SiLU followed it.
//
// In: activations NHWC [B, H, W, C] in bf16 or f32 with a pixel pitch of
// `ldx` elements (>= C); weights [C, k, k] in the activation type; bias [C]
// in f32 or in the activation type (read exactly into f32); an
// activation code (0 none, 1 ReLU, 2 SiLU). Out: NHWC [B, H, W, C] in the
// input's type,
//   out = T( act( f32(sum over taps x * w) + bias[c] ) )
// with zeros outside the image, the taps summed in f32 by FMAs in (ky, kx)
// order, and one rounding to T. SiLU is x / (1 + exp(-x)) in f32: torch's
// (mma::silu_exact) to an f32 output, the fast intrinsics' to a bf16 one
// (activate). ops/dw_deploy.py:dw_conv_tiles_plain is this formulation tile
// by tile.
//
// Bound on the H100 (data sheet rates): bytes. A site moves its input and
// output once (4 bytes an element in bf16) and does 2 k^2 operations an
// output element: at k = 9 about 40 a byte, far below the tensor cores'
// ridge, and a depthwise conv has no reduction over channels for an MMA to
// use. So the multiply-adds run as f32 FMAs on the CUDA cores, whose rate
// (some 30 T FMA/s) makes the FMAs of N's sites about as long as their
// bytes; the design touches device memory once and spends as few other
// instructions as it can:
//
//   * An item is one th x tw tile of one image (the whole image at 20 px:
//     ops/dw_deploy.py:dw_tile) for CG = 32 channels. Its window (the tile
//     and its halo) is copied once into shared memory in T by 16-byte
//     asynchronous copies (cp.async, zero-filled outside the image; element
//     copies where C or the pitch is not a multiple of 16 bytes, as C =
//     341). A block is persistent: as many as fit on the card at once, each
//     walking items with two window buffers, so that the next item's copies
//     are in flight while it computes the current one. (A first version,
//     one block a tile that staged it through registers and then computed
//     it, took 1.25 ms a batch of N's 15 sites in the graph against this
//     one's 1.10: each block waited on device memory's latency; PERF.md.)
//   * A thread owns one channel and a register block of 4 x 4 outputs, the
//     channel's k^2 weights in registers. It walks the 4 + k - 1 window rows
//     once; each row's 4 + k - 1 values feed the 4 k FMAs of every output row
//     that reads it. A warp is 32 neighbouring channels of one pixel: its
//     shared loads are 32 consecutive elements (no bank conflict) and its
//     stores a pixel's 32 consecutive elements (whole 32-byte sectors). A
//     thread keeps its channel over the output groups of its tile; its
//     weights are loaded again only where the next item is another channel
//     group.
//   * Epilogue in registers: the bias, the activation, one rounding to T,
//     stored straight from registers (staging the outputs for 16-byte
//     stores would take a third shared tile or a barrier between a thread's
//     groups, for stores that already fill whole sectors).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_s8.cuh"

namespace {

constexpr int kCG = 32;          // channels an item, one a lane
constexpr int kR = 4;            // output rows a thread
constexpr int kX = 4;            // output columns a thread
constexpr int kMaxWarps = 8;
// The blocks of kMaxWarps warps an SM that the register budget is cut for
// at k <= 5 and at k >= 7: the k^2 weights, 16 sums and a window row live in
// registers (about 120 at k = 9). Rebuilt with 2 at k <= 5 or 1 at k >= 7,
// N's and M's sites ran no faster (PERF.md).
constexpr int kBlocksSmallK = 3, kBlocksLargeK = 2;

struct DwGeo {
  int B, H, W, C, ldx, th, tw, tiles, items;
  int nxg, groups;     // column groups (kX) of a tile; row x column groups
  int wh, ww;          // window rows and columns staged
  int vec;             // 16-byte asynchronous copies of a pixel's channels
  int act, bias_f32;
  mma::FastDiv d_tiles, d_cgroups, d_tiles_x, d_ww, d_nxg;
};

// The activation in f32. SiLU to an f32 output is torch's (expf and an IEEE
// division); to a bf16 output it takes the fast exponential and division
// (__expf, __fdividef), a few f32 ulps from torch's and far below the one
// bf16 rounding that follows, at a fraction of the instructions: at k = 5
// the exact SiLU cost about as much as the 25 FMAs of its output.
template <typename T>
__device__ __forceinline__ float activate(float y, int act) {
  if (act == 1) return y < 0.f ? 0.f : y;       // NaN stays NaN, as torch's ReLU
  if (act == 2)
    return sizeof(T) == 2 ? __fdividef(y, 1.0f + __expf(-y)) : mma::silu_exact(y);
  return y;
}

struct Item {
  int b, c0, y0, x0;
};

__device__ __forceinline__ Item item_of(int it, const DwGeo& g) {
  const int rest = g.d_tiles.div(it), tile = g.d_tiles.mod(it, rest);
  const int b = g.d_cgroups.div(rest), cgi = g.d_cgroups.mod(rest, b);
  const int ty = g.d_tiles_x.div(tile);
  return Item{b, cgi * kCG, ty * g.th, g.d_tiles_x.mod(tile, ty) * g.tw};
}

// An item's window (its tile, the halo, kCG channels) into buf [wh][ww][kCG]
// in T, zero outside the image and past C: 16-byte asynchronous copies
// where the channels allow (the caller commits them), else element copies.
template <typename T, int K>
__device__ __forceinline__ void stage(const T* __restrict__ x, const Item& m, T* buf,
                                      const DwGeo& g) {
  constexpr int P = K / 2, kPer = 16 / sizeof(T), kChunks = kCG / kPer;
  const T* xb = x + (size_t)m.b * g.H * g.W * g.ldx;
  const int units = g.wh * g.ww * kChunks;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const int q = u % kChunks, px = u / kChunks;
    const int wy = g.d_ww.div(px), wx = g.d_ww.mod(px, wy);
    const int iy = m.y0 - P + wy, ix = m.x0 - P + wx, cb = m.c0 + q * kPer;
    const bool in = iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
    T* dst = buf + (size_t)u * kPer;
    const T* src = xb + ((size_t)iy * g.W + ix) * g.ldx + cb;
    if (g.vec) {
      const bool valid = in && cb < g.C;
      mma::cp_async16(mma::smem_u32(dst), valid ? src : x, valid);
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        dst[j] = in && cb + j < g.C ? src[j] : mma::from_f32<T>(0.f);
    }
  }
}

// A persistent block walks items (tile fastest, then channel group, then
// image) gridDim.x apart, with two window buffers: while it computes one
// item, the next one's window is on its way.
template <typename T, int K>
__global__ void __launch_bounds__(32 * kMaxWarps, K <= 5 ? kBlocksSmallK : kBlocksLargeK)
dw_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const void* __restrict__ bias, T* __restrict__ out, DwGeo g) {
  constexpr int WX = kX + K - 1;           // window columns a thread reads
  extern __shared__ __align__(16) uint8_t smem[];
  T* const buf0 = reinterpret_cast<T*>(smem);
  const int stride = g.wh * g.ww * kCG;    // elements a buffer
  const int c = threadIdx.x % kCG;
  float wr[K * K];
  float bi = 0.f;
  int weights_of = -1;                     // the channel group wr holds

  const int step = gridDim.x;
  int it = blockIdx.x;
  if (it < g.items) stage<T, K>(x, item_of(it, g), buf0, g);
  mma::cp_async_commit();
  for (int n = 0; it < g.items; it += step, ++n) {
    const T* cur = buf0 + (n & 1) * stride;
    if (it + step < g.items)
      stage<T, K>(x, item_of(it + step, g), buf0 + ((n + 1) & 1) * stride, g);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    __syncthreads();

    // ---- compute: lane = channel, warp slot = output group (row group,
    // column group)
    const Item m = item_of(it, g);
    const int ch = m.c0 + c;
    if (ch < g.C) {
      if (m.c0 != weights_of) {
#pragma unroll
        for (int i = 0; i < K * K; ++i) wr[i] = mma::to_f32(__ldg(w + (size_t)ch * K * K + i));
        bi = g.bias_f32 ? __ldg(static_cast<const float*>(bias) + ch)
                        : mma::to_f32(__ldg(static_cast<const T*>(bias) + ch));
        weights_of = m.c0;
      }
      T* ob = out + (size_t)m.b * g.H * g.W * g.C + ch;
      for (int gi = threadIdx.x / kCG; gi < g.groups; gi += blockDim.x / kCG) {
        const int rg = g.d_nxg.div(gi), xg = g.d_nxg.mod(gi, rg);
        float acc[kR][kX];
#pragma unroll
        for (int r = 0; r < kR; ++r)
#pragma unroll
          for (int j = 0; j < kX; ++j) acc[r][j] = 0.f;
        const T* base = cur + ((size_t)(rg * kR) * g.ww + xg * kX) * kCG + c;
#pragma unroll
        for (int t = 0; t < kR + K - 1; ++t) {
          float v[WX];
          const T* row = base + (size_t)t * g.ww * kCG;
#pragma unroll
          for (int i = 0; i < WX; ++i) v[i] = mma::to_f32(row[i * kCG]);
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            const int ky = t - r;
            if (ky < 0 || ky >= K) continue;
#pragma unroll
            for (int kx = 0; kx < K; ++kx)
#pragma unroll
              for (int j = 0; j < kX; ++j)
                acc[r][j] = fmaf(v[j + kx], wr[ky * K + kx], acc[r][j]);
          }
        }
        // the group's columns inside the tile and the image; a row pointer
        // each, so that a store is one address add
        const int nx = min(kX, min(g.tw - xg * kX, g.W - m.x0 - xg * kX));
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const int py = rg * kR + r, oy = m.y0 + py;
          if (py >= g.th || oy >= g.H) continue;
          T* orow = ob + ((size_t)oy * g.W + m.x0 + xg * kX) * g.C;
#pragma unroll
          for (int j = 0; j < kX; ++j)
            if (j < nx)
              orow[j * g.C] = mma::from_f32<T>(activate<T>(__fadd_rn(acc[r][j], bi), g.act));
        }
      }
    }
    __syncthreads();     // cur is refilled two items on
  }
  mma::cp_async_wait<0>();
}

template <typename T, int K>
int launch_k(const T* x, const T* w, const void* bias, T* out, const DwGeo& g,
             cudaStream_t stream) {
  const size_t smem = 2 * (size_t)g.wh * g.ww * kCG * sizeof(T);
  static size_t allowed = 48 << 10;
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        dw_conv_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
      cudaGetLastError();   // not left behind for the next launch to report
      return (int)e;
    }
    allowed = smem;
  }
  // as many warps as output groups, up to kMaxWarps, cut so that every warp
  // takes the same number of groups; as many blocks as fit on the card at
  // once, each walking its items
  const int rounds = (g.groups + kMaxWarps - 1) / kMaxWarps;
  const int threads = 32 * ((g.groups + rounds - 1) / rounds);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dw_conv_kernel<T, K>, threads,
                                                      smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int blocks = g.items < per_sm * sms ? g.items : per_sm * sms;
  dw_conv_kernel<T, K><<<blocks, threads, smem, stream>>>(x, w, bias, out, g);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* x, const T* w, const void* bias, T* out, int B, int H, int W, int C,
           int ldx, int k, int th, int tw, int act, int bias_f32, cudaStream_t s) {
  if (th <= 0 || tw <= 0 || act < 0 || act > 2) return (int)cudaErrorInvalidValue;
  DwGeo g{};
  g.B = B; g.H = H; g.W = W; g.C = C; g.ldx = ldx; g.th = th; g.tw = tw;
  g.act = act; g.bias_f32 = bias_f32;
  const int tiles_y = (H + th - 1) / th, tiles_x = (W + tw - 1) / tw;
  const int cgroups = (C + kCG - 1) / kCG;
  g.tiles = tiles_y * tiles_x;
  g.items = B * cgroups * g.tiles;
  const int nrg = (th + kR - 1) / kR;
  g.nxg = (tw + kX - 1) / kX;
  g.groups = nrg * g.nxg;
  g.wh = nrg * kR + k - 1;
  g.ww = g.nxg * kX + k - 1;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  g.vec = C % (16 / sizeof(T)) == 0 && (ldx * sizeof(T)) % 16 == 0 && aligned;
  g.d_tiles = mma::make_div(g.tiles);
  g.d_cgroups = mma::make_div(cgroups);
  g.d_tiles_x = mma::make_div(tiles_x);
  g.d_ww = mma::make_div(g.ww);
  g.d_nxg = mma::make_div(g.nxg);
  switch (k) {
    case 3: return launch_k<T, 3>(x, w, bias, out, g, s);
    case 5: return launch_k<T, 5>(x, w, bias, out, g, s);
    case 7: return launch_k<T, 7>(x, w, bias, out, g, s);
    case 9: return launch_k<T, 9>(x, w, bias, out, g, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// bias: C values in f32 (bias_f32 = 1) or in the activation type
// (bias_f32 = 0).
extern "C" int dw_conv(const void* x, const void* w, const void* bias, void* out, int B, int H,
                       int W, int C, int ldx, int k, int th, int tw, int act, int bf16,
                       int bias_f32, void* stream) {
  if (bf16)
    return launch(static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
                  bias, static_cast<__nv_bfloat16*>(out), B, H, W, C, ldx, k, th, tw, act,
                  bias_f32, (cudaStream_t)stream);
  return launch(static_cast<const float*>(x), static_cast<const float*>(w), bias,
                static_cast<float*>(out), B, H, W, C, ldx, k, th, tw, act, bias_f32,
                (cudaStream_t)stream);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
