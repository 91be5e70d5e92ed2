// Stem conv: deploy layer 0 of the MAF graphs, relu(conv3x3/s2(rgb(u8)/255) + b).
//
// Replaces: mafyolo_tpu/ops/stem_pallas.py:stem_conv_s2 (_stem_kernel).
//
// Input uint8 BGR NHWC [B, H, W, 3] as the loader gives it (H, W even);
// weights: ops/stem.py:stem_build's f32 [3, 3, 3, O] HWIO (input channels in
// BGR order, /255 folded in) and bias [O], and the fp16 tensor-core pack the
// wrapper derives from them (ops/stem.py:stem_pack). Output NHWC
// [B, H/2, W/2, O] in f32 or bf16, O a multiple of 8 up to 256:
//   out[b, y, x, o] = relu(bias[o] + sum_{dy,dx,c} in[b, 2y+dy-1, 2x+dx-1, c]
//                                                  * w[dy, dx, c, o])
// with zeros read outside the image: output row/col 0 reads input row/col -1
// (the rolled-and-masked tap of stem_pallas.py:84-86); with H and W even the
// bottom and right taps are always inside.
//
// Bound on the H100 (data sheet rates): device memory. At S bs32@640 the
// kernel reads 39 MB and writes 210 MB (bf16) for 2.8 G multiply-adds: 0.074
// ms at 3.35 TB/s. The multiply-adds alone would take 0.096 ms on the CUDA
// cores at the boost clock, so they go to the tensor cores, and the design is
// about keeping the stores streaming:
//
//   * A GEMM per 16 output pixels: rows are pixels, K = 32, columns are
//     output channels, on mma.sync m16n8k16 (fp16 operands, f32
//     accumulation, csrc/mma_bf16.cuh). The taps of input row dy of pixel x
//     are the 9 bytes 6x - 3 .. 6x + 5 of that row; K holds them as 15 byte
//     pairs (dy, i) = bytes 6x - 4 + 2i, 6x - 3 + 2i, i = 0..4, so that one
//     aligned 16-bit shared load gives a lane one A register (the first
//     byte of pair i = 0 and pair 15 carry zero weights). A byte is exact in
//     fp16: one byte permute makes 1024 + byte of each, one half2 subtract
//     removes the 1024.
//   * f32 accuracy from 16-bit operands: the weights are scaled by 2^s (the
//     largest just under 2^15, so no part is subnormal but the tiny ones)
//     and each is split into two fp16 parts, hi and lo (22 significant
//     bits), two MMAs a fragment; hi accumulates onto the scaled bias and lo
//     beside it, the sum is scaled back by 2^-s. The f32 output is as
//     accurate as an f32 convolution and the bf16 output is one rounding of
//     that sum. (bf16 parts would need three MMAs a fragment for the same
//     accuracy.) The B fragments stay in registers (32 for a 32-column
//     group), loaded once a band and group.
//   * Input by bands: a block owns a band of `rows` output rows by `cols`
//     output columns (a whole 640-px image row) and stages its 2*rows + 1
//     input rows with 16-byte cp.async into a two-stage ring, so that the
//     next band's bytes arrive while this one runs; a zero chunk stands for
//     row -1 and column -1. Rows that no 16-byte copy covers (3W % 16 != 0
//     or an unaligned base, e.g. W = 130) are staged byte by byte.
//   * Output straight from registers, contiguous: the pack permutes each
//     group of 32 columns (16 when O % 32 == 16) so that a lane's
//     accumulators are 8 (4) neighbouring channels, and a warp's store
//     instruction writes whole 32-byte sectors (512 contiguous bytes at O =
//     32 in bf16). A last group of 8 or 24 channels is computed 32 wide and
//     its empty lanes store nothing (N's O = 24: 384 contiguous bytes a
//     store). A staging copy through shared memory would move the same
//     bytes once more.
//   * A persistent grid of `blocks` blocks walks the bands in index order;
//     (b, y0, x0) is computed once a band.
//
// Measured (`python -m mafyolo_tpu_torch.tools.tune_kernels stem`, NVIDIA
// H100 80GB HBM3, 700.00 W): 62-75% of the bytes bound for N, S and M; what
// is left is the MMA phase (operand building, MMAs, epilogue: about 60% of
// a warp's clocks), not waiting for bytes (3%).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSplits = 2;    // hi, lo fp16 parts of each scaled weight
constexpr int kPairs = 15;    // byte pairs that carry taps; K = 2 * 16
constexpr int kMaxO = 256;
constexpr int kPhases = 4;    // input wait, MMA, store, barriers (tune_kernels stem)

struct Geo {
  int H, W, O, H2, W2;
  int rows, cols;            // a band: rows x cols output pixels (cols % 16 == 0)
  int pitch;                 // bytes of a staged input row: 16 + 6 * cols
  int in_rows;               // 2 * rows + 1
  int bands_x, bands_img, nbands;
  int np;                    // N-tile pairs of one split's pack
  int aligned;               // rows staged by 16-byte copies
  float scale, unscale;      // 2^s, 2^-s
};

__device__ __forceinline__ void band_origin(const Geo& g, int band, int& b, int& y0, int& x0) {
  b = band / g.bands_img;
  const int r = band - b * g.bands_img;
  const int by = r / g.bands_x;
  y0 = by * g.rows;
  x0 = (r - by * g.bands_x) * g.cols;
}

// Staged row r is input row 2*y0 - 1 + r; staged byte s is byte 6*x0 - 16 + s
// of that row; zero outside the image.
__device__ __forceinline__ void stage_band(const Geo& g, const uint8_t* __restrict__ img,
                                           uint8_t* dst, int band) {
  int b, y0, x0;
  band_origin(g, band, b, y0, x0);
  const int row_bytes = 3 * g.W, iy0 = 2 * y0 - 1, byte0 = 6 * x0 - 16;
  const uint8_t* im = img + (size_t)b * g.H * row_bytes;
  if (g.aligned) {
    const int chunks = g.pitch / 16, total = g.in_rows * chunks;
    for (int i = threadIdx.x; i < total; i += kThreads) {
      const int r = i / chunks, c = i - r * chunks;
      const int iy = iy0 + r, off = byte0 + 16 * c;
      const bool ok = iy >= 0 && iy < g.H && off >= 0 && off < row_bytes;
      mma::cp_async16(mma::smem_u32(dst + r * g.pitch + 16 * c),
                      ok ? im + (size_t)iy * row_bytes + off : img, ok);
    }
  } else {
    const int total = g.in_rows * g.pitch;
    for (int i = threadIdx.x; i < total; i += kThreads) {
      const int r = i / g.pitch, c = i - r * g.pitch;
      const int iy = iy0 + r, off = byte0 + c;
      dst[i] = (iy >= 0 && iy < g.H && off >= 0 && off < row_bytes)
                   ? __ldg(im + (size_t)iy * row_bytes + off) : (uint8_t)0;
    }
  }
}

// Two bytes (low, high) -> fp16x2 of their values, exactly.
__device__ __forceinline__ uint32_t bytes_f16x2(uint32_t v) {
  uint32_t x = __byte_perm(v, 0x6464u, 0x4140u);   // 0x64hh64ll: 1024 + byte each
  const __half2 h = __hsub2(*reinterpret_cast<const __half2*>(&x),
                            __halves2half2(__ushort_as_half(0x6400), __ushort_as_half(0x6400)));
  return *reinterpret_cast<const uint32_t*>(&h);
}

// A lane's N = 8 or 4 neighbouring channels of one pixel.
template <int N>
__device__ __forceinline__ void store_run(__nv_bfloat16* p, const float (&v)[N]) {
  uint32_t h[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) h[i] = mma::pack_bf162(v[2 * i], v[2 * i + 1]);
  if constexpr (N == 8) {
    *reinterpret_cast<uint4*>(p) = make_uint4(h[0], h[1], h[2], h[3]);
  } else {
    *reinterpret_cast<uint2*>(p) = make_uint2(h[0], h[1]);
  }
}

template <int N>
__device__ __forceinline__ void store_run(float* p, const float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}

struct Clock {   // thread 0's clocks by phase, when profiling
  long long acc[kPhases];
  long long last;
};

template <bool kProf>
__device__ __forceinline__ void tick(Clock& c, int phase) {
  if (kProf && threadIdx.x == 0) {
    const long long now = clock64();
    c.acc[phase] += now - c.last;
    c.last = now;
  }
}

// MMA columns c0 .. c0 + 8*NT - 1 of this warp's 16-pixel tiles of a band;
// lane t stores channels c0 + 2*NT*t .. + 2*NT - 1 where they exist.
template <typename T, int NT, bool kProf>
__device__ __forceinline__ void band_group(const Geo& g, const uint8_t* s_in,
                                           const uint4* __restrict__ pack,
                                           const float* __restrict__ bias, T* __restrict__ out,
                                           int b, int y0, int x0, int c0,
                                           const int (&koff)[2][2], Clock& clk) {
  constexpr int NP = NT / 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, gq = lane >> 2, t = lane & 3;
  const int ch = c0 + 2 * NT * t;
  const bool live = ch < g.O;
  uint4 bf[kSplits][2][NP];
#pragma unroll
  for (int s = 0; s < kSplits; ++s)
#pragma unroll
    for (int kt = 0; kt < 2; ++kt)
#pragma unroll
      for (int j = 0; j < NP; ++j)
        bf[s][kt][j] = __ldg(pack + ((s * 2 + kt) * g.np + c0 / 16 + j) * 32 + lane);
  float bs[2 * NT];
#pragma unroll
  for (int i = 0; i < 2 * NT; ++i) bs[i] = live ? __ldg(bias + ch + i) * g.scale : 0.f;

  const int tiles_x = g.cols / 16, tiles = g.rows * tiles_x;
  for (int mt = warp; mt < tiles; mt += kWarps) {
    const int yl = mt / tiles_x, xl = (mt - yl * tiles_x) * 16;
    const int y = y0 + yl;
    if (y >= g.H2 || x0 + xl >= g.W2) continue;   // warp-uniform
    const uint8_t* p0 = s_in + 2 * yl * g.pitch + 6 * (xl + gq) + 12;
    uint32_t a[2][4];
#pragma unroll
    for (int kt = 0; kt < 2; ++kt)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        a[kt][2 * q] = bytes_f16x2(*reinterpret_cast<const uint16_t*>(p0 + koff[kt][q]));
        a[kt][2 * q + 1] =
            bytes_f16x2(*reinterpret_cast<const uint16_t*>(p0 + 48 + koff[kt][q]));
      }
    float hi[NT][4], lo[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hi[j][e] = bs[2 * j + (e & 1)];
        lo[j][e] = 0.f;
      }
#pragma unroll
    for (int kt = 0; kt < 2; ++kt)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint4& h = bf[0][kt][j / 2];
        const uint4& l = bf[1][kt][j / 2];
        mma::mma_16816_f16(hi[j], a[kt], j & 1 ? h.z : h.x, j & 1 ? h.w : h.y);
        mma::mma_16816_f16(lo[j], a[kt], j & 1 ? l.z : l.x, j & 1 ? l.w : l.y);
      }
    float v[2][2 * NT];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          v[h][2 * j + e] = fmaxf((hi[j][2 * h + e] + lo[j][2 * h + e]) * g.unscale, 0.f);
    if (kProf) asm volatile("" ::"f"(v[0][0]), "f"(v[1][2 * NT - 1]));
    tick<kProf>(clk, 1);
    T* o = out + (((size_t)b * g.H2 + y) * g.W2 + x0 + xl + gq) * g.O + ch;
    if constexpr (sizeof(T) == 4 && NT == 4) {
      // A lane's 8 floats are 32 bytes, two 16-byte stores: lanes t and t^1
      // swap halves so that each store instruction fills whole sectors
      // (first store: the even lane's run, second: the odd lane's).
      const bool odd = t & 1;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float first[4], second[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float theirs = __shfl_xor_sync(0xffffffffu, odd ? v[h][i] : v[h][4 + i], 1);
          first[i] = odd ? theirs : v[h][i];
          second[i] = odd ? v[h][4 + i] : theirs;
        }
        const int c1 = odd ? -4 : 0, c2 = odd ? 4 : 8;
        if (x0 + xl + gq + 8 * h < g.W2) {
          if (ch + c1 < g.O) store_run(o + 8 * h * g.O + c1, first);
          if (ch + c2 < g.O) store_run(o + 8 * h * g.O + c2, second);
        }
      }
    } else if (live) {
      if (x0 + xl + gq < g.W2) store_run(o, v[0]);
      if (x0 + xl + gq + 8 < g.W2) store_run(o + 8 * g.O, v[1]);
    }
    tick<kProf>(clk, 2);
  }
}

template <typename T, bool kProf>
__global__ void __launch_bounds__(kThreads, 2)
stem_kernel(const uint8_t* __restrict__ img, const uint4* __restrict__ pack,
            const float* __restrict__ bias, T* __restrict__ out, const Geo g,
            unsigned long long* __restrict__ prof) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int stage_bytes = g.in_rows * g.pitch;
  // this lane's byte offsets of its four pairs: K tile kt, pair kt*8 + 4q + t
  int koff[2][2];
#pragma unroll
  for (int kt = 0; kt < 2; ++kt)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int p = kt * 8 + 4 * q + (threadIdx.x & 3);
      koff[kt][q] = p < kPairs ? (p / 5) * g.pitch + 2 * (p % 5) : 0;
    }
  Clock clk = {};
  if (kProf) clk.last = clock64();

  int band = blockIdx.x;
  if (band < g.nbands) stage_band(g, img, smem, band);
  mma::cp_async_commit();
  for (int k = 0; band < g.nbands; band += gridDim.x, ++k) {
    const int next = band + gridDim.x;
    if (next < g.nbands) stage_band(g, img, smem + ((k + 1) & 1) * stage_bytes, next);
    mma::cp_async_commit();
    tick<kProf>(clk, 3);
    mma::cp_async_wait<1>();
    tick<kProf>(clk, 0);
    __syncthreads();
    tick<kProf>(clk, 3);
    const uint8_t* s_in = smem + (k & 1) * stage_bytes;
    int b, y0, x0;
    band_origin(g, band, b, y0, x0);
    for (int c0 = 0; c0 < g.O; c0 += 32) {
      if (g.O - c0 == 16)
        band_group<T, 2, kProf>(g, s_in, pack, bias, out, b, y0, x0, c0, koff, clk);
      else
        band_group<T, 4, kProf>(g, s_in, pack, bias, out, b, y0, x0, c0, koff, clk);
    }
    tick<kProf>(clk, 3);
    __syncthreads();   // the next band's copies overwrite this stage
    tick<kProf>(clk, 3);
  }
  if (kProf && threadIdx.x == 0)
    for (int i = 0; i < kPhases; ++i) atomicAdd(prof + i, (unsigned long long)clk.acc[i]);
}

template <typename T, bool kProf>
int launch(const void* img, const void* pack, const float* wts, void* out, const Geo& g,
           int blocks, unsigned long long* prof, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)g.in_rows * g.pitch;
  auto kern = stem_kernel<T, kProf>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<blocks, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(img), static_cast<const uint4*>(pack), wts + 27 * g.O,
      static_cast<T*>(out), g, prof);
  return (int)cudaGetLastError();
}

}  // namespace

// img: uint8 [B,H,W,3]; pack: fp16 [2 * 32 * columns] (ops/stem.py:stem_pack:
// the hi and lo parts of the weights scaled by 2^scale_exp); wts: f32 [28*O]
// (ops/stem.py:stem_build; the bias is read from it); out: NHWC
// [B,H/2,W/2,O], bf16 if `bf16` else f32. A band is `rows` output rows by
// `cols` output columns (a multiple of 16); `blocks` blocks walk the bands.
// prof: null, or 4 u64 that gather thread 0's clocks by phase (input wait,
// MMA, store, barriers) over all blocks. Returns the cudaError_t of the launch.
extern "C" int stem_run(const void* img, const void* pack, const float* wts, void* out,
                        int B, int H, int W, int O, int bf16, int scale_exp, int rows, int cols,
                        int blocks, unsigned long long* prof, void* stream) {
  if (B <= 0 || H < 2 || W < 2 || (H | W) & 1 || O <= 0 || O % 8 || O > kMaxO || rows < 1 ||
      cols < 16 || cols % 16 || blocks < 1 || scale_exp < -100 || scale_exp > 100)
    return (int)cudaErrorInvalidValue;
  Geo g;
  g.H = H, g.W = W, g.O = O, g.H2 = H / 2, g.W2 = W / 2;
  g.rows = rows, g.cols = cols;
  g.pitch = 16 + 6 * cols;
  g.in_rows = 2 * rows + 1;
  g.bands_x = (g.W2 + cols - 1) / cols;
  g.bands_img = (g.H2 + rows - 1) / rows * g.bands_x;
  g.nbands = B * g.bands_img;
  g.np = O / 32 * 2 + (O % 32 == 0 ? 0 : O % 32 == 16 ? 1 : 2);   // groups of 32, or 16
  g.scale = ldexpf(1.f, scale_exp);
  g.unscale = ldexpf(1.f, -scale_exp);
  g.aligned = (3 * W) % 16 == 0 && reinterpret_cast<uintptr_t>(img) % 16 == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return prof ? launch<__nv_bfloat16, true>(img, pack, wts, out, g, blocks, prof, s)
                : launch<__nv_bfloat16, false>(img, pack, wts, out, g, blocks, prof, s);
  return prof ? launch<float, true>(img, pack, wts, out, g, blocks, prof, s)
              : launch<float, false>(img, pack, wts, out, g, blocks, prof, s);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
