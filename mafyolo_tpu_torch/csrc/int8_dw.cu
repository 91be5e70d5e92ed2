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
// quantized once on the host (ops/quant_conv.py:pack): per channel, each
// row ky of k taps packed into G = ceil(k / 4) 32-bit words of 4 signed
// bytes (tap kx = 4g + j in byte j, zero past k), int32 [k, G, C]; f32
// scale[c] = xs * w_scale[c] and bias[c]. Out: NHWC [B, H, W, C] in the
// input's type,
//   out = bf16/f32( f32(sum_taps q(x) * w_q) * scale[c] + bias[c] )
// with q(x) = clip(round_half_even(x / xs), -127, 127) and ZERO outside the
// image (the halo is staged as 0, never as a quantized neighbour), equal
// bit for bit to ops/quant_conv.py:int8_conv_plain.
//
// Bound on the H100 (data sheet rates): bytes. A site moves its input and
// output once (4 bytes an element in bf16) and does 2 k^2 int8 operations an
// output element: at k = 9 about 40 operations a byte, and DW has no
// reduction over channels for an MMA to use. So the multiply-adds run on
// the CUDA cores, four taps an instruction:
//
//   * An item is a th x tw tile of one image (the whole image at 20 and 40
//     px: ops/quant_conv.py:dw_tile) for CG = 16 channels (8 where C is not
//     a multiple of 16: C = 72 fills every lane). A block stages one such
//     item: the tile and its halo with 16-byte loads, a pixel's 8 channels
//     a thread, each element quantized once into channel-planar bytes (4
//     horizontally neighbouring pixels of one channel make a word). Each
//     quantization is an IEEE division whose slow-path branch keeps the
//     compiler from overlapping two in one thread, so blocks take up to 512
//     threads and several share an SM.
//   * A thread owns 4 x 4 output pixels of one channel (a block has a
//     thread for each such item, up to 512). It walks the 4 + k -
//     1 window rows once; from each row's G + 1 words it forms the four
//     byte-shifted windows with funnel shifts and adds, with __dp4a, their
//     dot products with the weight words of every output row that reads
//     that window row. At k = 9 that is 27 dp4a an output where a tap a
//     multiply-add took 81 IMADs and 81 byte loads.
//   * Epilogue: __int2float_rn, __fmul_rn, __fadd_rn, one rounding to the
//     output type, into a shared tile, then 16-byte stores of each pixel's
//     channels.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_s8.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kR = 4;            // output rows a thread
constexpr int kX = 4;            // output columns a thread (a word of taps)

struct DwGeo {
  int B, H, W, C, ldx, th, tw, tiles_y, tiles_x;
  int nrg, nxg;        // row groups (kR) and column groups (kX) of a tile
  int wh, nwr;         // window rows; words a window row of one channel
  int plane;           // words between channel planes
  int vec, vec_out;    // 16-byte loads of 8 channels; 16-byte stores
  float xs;
  mma::FastDiv d_tiles_x, d_cols, d_nxg, d_tw, d_cgroups;
};

template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&f)[8]);
template <>
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  mma::unpack8(__ldg(reinterpret_cast<const uint4*>(p)), f);
}
template <>
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// Blocks of 512 threads an SM the register budget is cut for: 3 (42
// registers) for k 3 and 5, 2 (64) for k 7 and 9, whose weights alone take
// k * ceil(k / 4) registers. More warps, more quantizations side by side.
#ifndef INT8_DW_MIN_BLOCKS
#define INT8_DW_MIN_BLOCKS 3
#endif

template <typename T, int K, int CG, bool PROF>
__global__ void __launch_bounds__(kMaxThreads, K <= 5 ? INT8_DW_MIN_BLOCKS : 2)
int8_dw_kernel(const T* __restrict__ x, const int* __restrict__ wpk,
               const float* __restrict__ scale, const float* __restrict__ bias,
               T* __restrict__ out, DwGeo g, unsigned long long* prof) {
  constexpr int G = (K + 3) / 4;
  constexpr int P = K / 2;
  // thread 0's clocks by phase (stage, compute, store) when PROF
  long long clk[3] = {0, 0, 0}, last = PROF ? clock64() : 0;
  auto mark = [&](int phase) {
    if (PROF) {
      const long long now = clock64();
      clk[phase] += now - last;
      last = now;
    }
  };
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* planes = reinterpret_cast<uint32_t*>(smem);
  T* stage = reinterpret_cast<T*>(smem + (size_t)CG * g.plane * 4);
  // the channel groups of a tile are neighbouring blocks: they read the
  // same pixels' bytes at about the same time, so a 32-byte sector fetched
  // for one group is in L2 for the next
  const int tile = g.d_cgroups.div(blockIdx.x);
  const int b = blockIdx.y, c0 = g.d_cgroups.mod(blockIdx.x, tile) * CG;
  const int ty = g.d_tiles_x.div(tile);
  const int y0 = ty * g.th, x0 = g.d_tiles_x.mod(tile, ty) * g.tw;
  const int ylo = y0 - P, xlo = x0 - P;
  const T* xb = x + (size_t)b * g.H * g.W * g.ldx;

  // ---- stage: unit = (window row, window column, 8-channel half), one
  // pixel's 8 channels; each quantized byte lands in its channel's plane
  uint8_t* pb = reinterpret_cast<uint8_t*>(planes);
  const int cols = 4 * g.nwr;
  const int units = g.wh * cols * (CG / 8);
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const int h = u % (CG / 8), px = u / (CG / 8);
    const int wy = g.d_cols.div(px), wx = g.d_cols.mod(px, wy);
    const int iy = ylo + wy, ix = xlo + wx, cb = c0 + 8 * h;
    const bool in = iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
    float f[8];
    if (g.vec) {
      if (in) {
        load8(xb + ((size_t)iy * g.W + ix) * g.ldx + cb, f);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) f[j] = 0.f;
      }
    } else {
      const T* p = xb + ((size_t)iy * g.W + ix) * g.ldx + cb;
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = in && cb + j < g.C ? mma::to_f32(p[j]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      pb[((size_t)(8 * h + j) * g.plane + wy * g.nwr) * 4 + wx] =
          (uint8_t)mma::quantize_s8(f[j], g.xs);
  }
  __syncthreads();
  mark(0);

  // ---- compute: item = (channel, column group, row group), channel fastest
  const int items = CG * g.nxg * g.nrg;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int c = it % CG, rest = it / CG;
    const int rg = g.d_nxg.div(rest), xg = g.d_nxg.mod(rest, rg);
    const int ch = c0 + c;
    if (ch >= g.C) continue;
    int wr[K][G];
#pragma unroll
    for (int ky = 0; ky < K; ++ky)
#pragma unroll
      for (int gg = 0; gg < G; ++gg) wr[ky][gg] = __ldg(wpk + (ky * G + gg) * g.C + ch);
    int acc[kR][kX];
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int j = 0; j < kX; ++j) acc[r][j] = 0;
    const uint32_t* pl = planes + c * g.plane + rg * kR * g.nwr + xg;
#pragma unroll
    for (int t = 0; t < kR + K - 1; ++t) {
      uint32_t wv[G + 1];
#pragma unroll
      for (int gg = 0; gg <= G; ++gg) wv[gg] = pl[t * g.nwr + gg];
      int sh[kX][G];
#pragma unroll
      for (int gg = 0; gg < G; ++gg) {
        sh[0][gg] = (int)wv[gg];
#pragma unroll
        for (int j = 1; j < kX; ++j) sh[j][gg] = (int)__funnelshift_r(wv[gg], wv[gg + 1], 8 * j);
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int ky = t - r;
        if (ky < 0 || ky >= K) continue;
#pragma unroll
        for (int j = 0; j < kX; ++j)
#pragma unroll
          for (int gg = 0; gg < G; ++gg) acc[r][j] = __dp4a(sh[j][gg], wr[ky][gg], acc[r][j]);
      }
    }
    const float sc = scale[ch], bi = bias[ch];
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int j = 0; j < kX; ++j) {
        const int oy = rg * kR + r, ox = xg * kX + j;
        if (oy < g.th && ox < g.tw)
          stage[(oy * g.tw + ox) * CG + c] = mma::from_f32<T>(mma::dequant(acc[r][j], sc, bi));
      }
  }
  __syncthreads();
  mark(1);

  // ---- store: each pixel's CG channels
  T* ob = out + (size_t)b * g.H * g.W * g.C;
  if (g.vec_out) {
    constexpr int kPer = 16 / sizeof(T), kChunks = CG / kPer;
    for (int u = threadIdx.x; u < g.th * g.tw * kChunks; u += blockDim.x) {
      const int pix = u / kChunks, k = u % kChunks;
      const int py = g.d_tw.div(pix);
      const int oy = y0 + py, ox = x0 + g.d_tw.mod(pix, py);
      if (oy < g.H && ox < g.W)
        *reinterpret_cast<uint4*>(ob + ((size_t)oy * g.W + ox) * g.C + c0 + k * kPer) =
            *reinterpret_cast<const uint4*>(stage + pix * CG + k * kPer);
    }
  } else {
    for (int u = threadIdx.x; u < g.th * g.tw * CG; u += blockDim.x) {
      const int pix = u / CG, c = u % CG;
      const int py = g.d_tw.div(pix);
      const int oy = y0 + py, ox = x0 + g.d_tw.mod(pix, py);
      if (oy < g.H && ox < g.W && c0 + c < g.C)
        ob[((size_t)oy * g.W + ox) * g.C + c0 + c] = stage[pix * CG + c];
    }
  }
  if (PROF) {
    mark(2);
    if (threadIdx.x == 0)
      for (int i = 0; i < 3; ++i) atomicAdd(prof + i, (unsigned long long)clk[i]);
  }
}

template <typename T, int K, int CG, bool PROF>
int launch_k(const T* x, const int* w, const float* scale, const float* bias, T* out,
             const DwGeo& g, unsigned long long* prof, cudaStream_t stream) {
  const dim3 grid(g.tiles_y * g.tiles_x * g.d_cgroups.d, g.B);
  const size_t smem = (size_t)CG * g.plane * 4 + (size_t)g.th * g.tw * CG * sizeof(T);
  static size_t allowed = 48 << 10;
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        int8_dw_kernel<T, K, CG, PROF>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
      cudaGetLastError();   // not left behind for the next launch to report
      return (int)e;
    }
    allowed = smem;
  }
  // a thread for each 4 x 4 outputs of a channel or each pixel's 8 channels
  // of the window, whichever are more, up to kMaxThreads: a quantization is
  // a chain of dependent instructions (an IEEE division), so the staging
  // goes as fast as there are threads to run such chains side by side
  const int items = CG * g.nxg * g.nrg, units = g.wh * 4 * g.nwr * (CG / 8);
  const int threads = min(kMaxThreads, (max(items, units) + 31) / 32 * 32);
  int8_dw_kernel<T, K, CG, PROF><<<grid, threads, smem, stream>>>(x, w, scale, bias, out, g,
                                                                   prof);
  return (int)cudaGetLastError();
}

template <typename T, int CG, bool PROF>
int launch_cg(const T* x, const int* w, const float* scale, const float* bias, T* out,
              const DwGeo& g, int k, unsigned long long* pr, cudaStream_t s) {
  switch (k) {
    case 3: return launch_k<T, 3, CG, PROF>(x, w, scale, bias, out, g, pr, s);
    case 5: return launch_k<T, 5, CG, PROF>(x, w, scale, bias, out, g, pr, s);
    case 7: return launch_k<T, 7, CG, PROF>(x, w, scale, bias, out, g, pr, s);
    case 9: return launch_k<T, 9, CG, PROF>(x, w, scale, bias, out, g, pr, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch(const T* x, const int* w, const float* scale, const float* bias, T* out, int B,
           int H, int W, int C, int ldx, int k, int th, int tw, float xs,
           unsigned long long* pr, cudaStream_t s) {
  if (th <= 0 || tw <= 0) return (int)cudaErrorInvalidValue;
  const int cg = C % 16 == 0 ? 16 : 8;
  DwGeo g{};
  g.B = B; g.H = H; g.W = W; g.C = C; g.ldx = ldx; g.th = th; g.tw = tw; g.xs = xs;
  g.tiles_y = (H + th - 1) / th;
  g.tiles_x = (W + tw - 1) / tw;
  g.nrg = (th + kR - 1) / kR;
  g.nxg = (tw + kX - 1) / kX;
  g.wh = g.nrg * kR + k - 1;
  // bytes a row reads: kX * nxg outputs, k - 1 halo, and the words the
  // funnel shifts of the last group read past them
  g.nwr = (kX * g.nxg + k - 1 + 3) / 4 + 1;
  const int target = 32 / cg;      // planes of neighbouring channels on distinct banks
  g.plane = g.wh * g.nwr + ((target - g.wh * g.nwr) % 32 + 32) % 32;
  const size_t es = sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  g.vec = C % cg == 0 && (ldx * es) % 16 == 0 && aligned;
  g.vec_out = (C * es) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0 && C % cg == 0;
  g.d_tiles_x = mma::make_div(g.tiles_x);
  g.d_cols = mma::make_div(4 * g.nwr);
  g.d_nxg = mma::make_div(g.nxg);
  g.d_tw = mma::make_div(tw);
  g.d_cgroups = mma::make_div((C + cg - 1) / cg);
  if (pr)
    return cg == 16 ? launch_cg<T, 16, true>(x, w, scale, bias, out, g, k, pr, s)
                    : launch_cg<T, 8, true>(x, w, scale, bias, out, g, k, pr, s);
  return cg == 16 ? launch_cg<T, 16, false>(x, w, scale, bias, out, g, k, pr, s)
                  : launch_cg<T, 8, false>(x, w, scale, bias, out, g, k, pr, s);
}

}  // namespace

// prof: null, or 3 u64 that gather thread 0's clocks by phase (stage,
// compute, store) over the blocks.
extern "C" int int8_dw(const void* x, const void* w, const float* scale, const float* bias,
                       void* out, int B, int H, int W, int C, int ldx, int k, int th, int tw,
                       float xs, int bf16, void* prof, void* stream) {
  auto* pr = static_cast<unsigned long long*>(prof);
  if (bf16)
    return launch(static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(w), scale, bias,
                  static_cast<__nv_bfloat16*>(out), B, H, W, C, ldx, k, th, tw, xs, pr,
                  (cudaStream_t)stream);
  return launch(static_cast<const float*>(x), static_cast<const int*>(w), scale, bias,
                static_cast<float*>(out), B, H, W, C, ldx, k, th, tw, xs, pr,
                (cudaStream_t)stream);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
