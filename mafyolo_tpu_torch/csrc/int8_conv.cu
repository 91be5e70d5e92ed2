// Real-int8 dense convolution (groups 1) of the quantized deploy graph:
// 1x1 stride 1 and 3x3 stride 2 in MAF-YOLO, any k, stride and pad here but
// 3x3 stride 1 pad 1 (the office graphs' class, csrc/int8_conv3x3.cuh,
// included at the end), with the activation that follows (none, ReLU or
// SiLU) fused.
//
// Replaces: the INT8_INFER branch of mafyolo_tpu/models/blocks.py:_RawConv
// (306-321), an XLA conv with int8 operands and int32 accumulation (no
// Pallas kernel; PyTorch has no int8 convolution on the card).
//
// In: activations NHWC [B, H, W, C] in bf16 or f32 with a pixel pitch of
// `ldx` elements (>= C: a channel slice of a wider tensor reads in place);
// the per-tensor activation scale xs; the weights quantized and packed once
// on the host (ops/quant_conv.py:pack): int8 [K, O] with K = (ky, kx, c),
// the channels of each tap padded with zero rows to cp (a multiple of 16)
// and K to Kp (a multiple of 32), in mma.m16n8k32 fragment order
// (csrc/mma_s8.cuh); f32 scale[o] = xs * w_scale[o] and bias[o].
// Out: NHWC [B, Ho, Wo, O] in the input's type,
//   y = bf16/f32( f32(sum_k q(x) * w_q) * scale[o] + bias[o] ),  out = act(y)
// with q(x) = clip(round_half_even(x / xs), -127, 127), zeros outside the
// image, and act computed in f32 from y as torch computes it (ReLU, or SiLU
// y / (1 + exp(-y)) with an IEEE division), then one rounding to the output
// type: equal bit for bit to ops/quant_conv.py:int8_conv_plain followed by
// torch's activation.
//
// Bound on the H100 (data sheet rates): bytes. At N's sites (bs32@640) a
// pixel does 2 * K * O int8 operations against 2 * (C + O) bytes of bf16 in
// and out, below the ~590 operations a byte where the int8 tensor cores
// would set the pace. So the design moves each byte once and keeps loads in
// flight:
//
//   * A block owns 64 output pixels and all output channels. It quantizes
//     its input once, into a window in shared memory, then loops over the
//     output channels 64 at a time: the input is read and divided once per
//     block, not once per 64 output channels. Where the windows are too few
//     to give about four blocks an SM (the 20 and 40 px sites), 2-6 blocks
//     share a window's passes, each staging the window itself. Blocks are
//     small (128 threads, 72-115 registers) so that several share an SM and
//     one's loads overlap another's arithmetic.
//   * The window: for a 1x1 stride-1 conv the block's 64 pixels (rows of
//     the GEMM); otherwise the input under a th x tw tile of output pixels
//     of one image (ops/quant_conv.py:conv_tile picks it from the site's
//     shape), its columns stored by parity of the stride so that the pixels
//     of neighbouring outputs are neighbouring slots. Each pixel holds its C
//     quantized bytes at a pitch that is an odd multiple of 16 bytes.
//   * Loads: 16 bytes a thread, four in flight before the first is used:
//     per pixel where a pixel is a whole number of 16-byte words (C of 24,
//     48, 72, ... in bf16); along contiguous image rows where the pitch is C
//     and a pixel is not (C = 3: the stem); element by element otherwise.
//     The index arithmetic divides by the launch's widths with multiply-shift
//     divisors (mma_s8.cuh:FastDiv), not the ~20-instruction integer
//     division.
//   * The MMA operand A comes straight from the window: ldmatrix takes one
//     row address a lane, so each lane points at its pixel's tap and channel
//     offset (no im2col copy). B (the packed weights) from L1/L2, one
//     16-byte read a lane feeding two m16n8k32 MMAs, issued ahead of its
//     MMAs; each warp owns 32 pixels x kBN / 2 channels of a pass.
//   * Epilogue: __int2float_rn, __fmul_rn, __fadd_rn, one rounding to the
//     output type, the activation, then through shared memory to 16-byte
//     stores of whole output rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_s8.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBM = 64;          // output pixels a block
constexpr int kBN = 64;          // output channels a pass of the O loop
constexpr int kNP = kBN / 32;    // 16-column pairs a warp takes in a pass
constexpr int kInFlight = 4;     // 16-byte loads a thread issues before using one
// The register budget (INT8_CONV_MIN_BLOCKS blocks an SM: 64 registers a
// thread at 8) and the B lookahead are compile-time knobs:
// tools/tune_kernels.py int8_caps rebuilds the kernel with each and times it. A
// quantization or a SiLU is a chain of dependent instructions whose
// slow-path branch keeps the compiler from overlapping two in one thread,
// so what sets the pace is warps an SM: 8 blocks of 4 warps beat 4 blocks
// with the registers to look two K steps ahead (PERF.md §6, the int8
// kernels' entry).
#ifndef INT8_CONV_AHEAD
#define INT8_CONV_AHEAD 1
#endif
constexpr int kAhead = INT8_CONV_AHEAD;   // K steps whose B fragments are in flight
constexpr int kPhases = 4;       // profiled phases: stage, MMA, epilogue, store

struct Geo {
  int B, H, W, C, ldx, Ho, Wo, O, k, stride, pad;
  int cp, kp;      // bytes of one tap in K (C padded to 16); K padded to 32
  int P;           // bytes between window slots: cp or cp + 16, an odd multiple of 16
  int th, tw;      // output tile; th == 0: the flat 1x1 mode (64 consecutive pixels)
  int wh, ww;      // window rows and columns, in pixels
  int wws;         // slots of one parity class in a window row: ceil(ww / stride)
  int tiles_y, tiles_x;
  int slots;       // window slots: 64 (flat) or wh * stride * wws
  int osplit;      // neighbouring blocks sharing one window's output channels
  int load;        // 0: 16-byte words a pixel; 1: along contiguous rows; 2: by element
  int act;         // 0: none; 1: ReLU; 2: SiLU (the kernel's template argument)
  int vec_out;     // output rows stored as 16-byte words
  float xs;
  mma::FastDiv d_nchk, d_ww, d_s, d_tw, d_chunks, d_c, d_per_row, d_tiles_x, d_ncols, d_osplit;
};

template <typename T> struct Elem;
template <> struct Elem<__nv_bfloat16> {
  static constexpr int kPer16 = 8;
  // 16 loaded bytes -> their 8 quantized bytes
  static __device__ __forceinline__ uint2 quantize(uint4 v, float xs) {
    float f[8];
    mma::unpack8(v, f);
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < 8; ++j)
      w[j >> 2] |= (uint32_t)(mma::quantize_s8(f[j], xs) & 0xff) << (8 * (j & 3));
    return make_uint2(w[0], w[1]);
  }
  static __device__ __forceinline__ float element(uint4 v, int j) {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(&v)[j]);
  }
};
template <> struct Elem<float> {
  static constexpr int kPer16 = 4;
  static __device__ __forceinline__ uint32_t quantize(uint4 v, float xs) {
    const float4 f = *reinterpret_cast<const float4*>(&v);
    return (uint32_t)(mma::quantize_s8(f.x, xs) & 0xff) |
           (uint32_t)(mma::quantize_s8(f.y, xs) & 0xff) << 8 |
           (uint32_t)(mma::quantize_s8(f.z, xs) & 0xff) << 16 |
           (uint32_t)(mma::quantize_s8(f.w, xs) & 0xff) << 24;
  }
  static __device__ __forceinline__ float element(uint4 v, int j) {
    return reinterpret_cast<const float*>(&v)[j];
  }
};

__device__ __forceinline__ void store_q(int8_t* p, uint2 w) { *reinterpret_cast<uint2*>(p) = w; }
__device__ __forceinline__ void store_q(int8_t* p, uint32_t w) {
  *reinterpret_cast<uint32_t*>(p) = w;
}

// Slot of window pixel (wy, wx) in tile mode: columns grouped by parity.
__device__ __forceinline__ int slot_of(const Geo& g, int wy, int wx) {
  const int q = g.d_s.div(wx);
  return (wy * g.stride + (wx - q * g.stride)) * g.wws + q;
}

// A block's window: image b, the input pixel under window pixel (0, 0) and
// the output pixel of tile row 0, column 0 (tile mode); flat mode: pixels
// m0 .. m0 + npix - 1.
struct Win {
  int b, iy0, ix0, oy0, ox0, m0, npix;
};

// The window's quantized bytes into shared memory.
template <typename T>
__device__ void stage_window(const T* __restrict__ x, const Geo& g, const Win& w,
                             int8_t* win) {
  constexpr int kPer = Elem<T>::kPer16;
  const bool flat = g.th == 0;
  const int tid = threadIdx.x;
  if (g.load == 0) {
    // whole 16-byte words of each pixel; out-of-image pixels get zero bytes
    const int npix = flat ? kBM : g.wh * g.ww;
    const int units = npix * g.d_nchk.d;
    for (int u0 = tid; u0 < units; u0 += kThreads * kInFlight) {
      uint4 v[kInFlight];
      int slot[kInFlight], ch[kInFlight];
#pragma unroll
      for (int i = 0; i < kInFlight; ++i) {
        const int u = u0 + i * kThreads;
        v[i] = make_uint4(0u, 0u, 0u, 0u);
        slot[i] = -1;
        if (u < units) {
          const int pi = g.d_nchk.div(u);
          ch[i] = g.d_nchk.mod(u, pi);
          bool ok;
          size_t pix;
          if (flat) {
            ok = pi < w.npix;
            pix = (size_t)w.m0 + pi;
            slot[i] = pi;
          } else {
            const int wy = g.d_ww.div(pi), wx = g.d_ww.mod(pi, wy);
            const int iy = w.iy0 + wy, ix = w.ix0 + wx;
            ok = iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
            pix = ((size_t)w.b * g.H + iy) * g.W + ix;
            slot[i] = slot_of(g, wy, wx);
          }
          if (ok)
            v[i] = __ldg(reinterpret_cast<const uint4*>(x + pix * g.ldx + ch[i] * kPer));
        }
      }
#pragma unroll
      for (int i = 0; i < kInFlight; ++i)   // out-of-image pixels: v is zero, and q(0) = 0
        if (slot[i] >= 0)
          store_q(win + slot[i] * g.P + ch[i] * kPer, Elem<T>::quantize(v[i], g.xs));
    }
    return;
  }
  // zero the window first: only in-image bytes are written below
  for (int i = tid; i < g.slots * g.P / 16; i += kThreads)
    reinterpret_cast<uint4*>(win)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  if (g.load == 1) {
    // pitch C: the in-image pixels of a window row are one run of elements;
    // load its aligned 16-byte words and place each element
    const int rows = flat ? 1 : g.wh;
    for (int u = tid; u < rows * g.d_per_row.d; u += kThreads) {
      const int wy = g.d_per_row.div(u), j = g.d_per_row.mod(u, wy);
      long long e0, e1, base;   // the row's in-image elements [e0, e1); window column 0 at base
      if (flat) {
        base = (long long)w.m0 * g.C;
        e0 = base;
        e1 = base + (long long)w.npix * g.C;
      } else {
        const int iy = w.iy0 + wy;
        if (iy < 0 || iy >= g.H) continue;
        const long long row = ((long long)w.b * g.H + iy) * g.W;
        const int ixa = max(w.ix0, 0), ixb = min(w.ix0 + g.ww, g.W);
        if (ixa >= ixb) continue;
        base = (row + w.ix0) * g.C;
        e0 = (row + ixa) * g.C;
        e1 = (row + ixb) * g.C;
      }
      const long long ew = (e0 / kPer + j) * kPer;   // first element of this word
      if (ew >= e1) continue;
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(x + ew));
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const long long e = ew + i;
        if (e < e0 || e >= e1) continue;
        const int rel = (int)(e - base), wx = g.d_c.div(rel), c = g.d_c.mod(rel, wx);
        const int slot = flat ? wx : slot_of(g, wy, wx);
        win[slot * g.P + c] = (int8_t)mma::quantize_s8(Elem<T>::element(v, i), g.xs);
      }
    }
  } else {
    const int npix = flat ? w.npix : g.wh * g.ww;
    for (int u = tid; u < npix * g.C; u += kThreads) {
      const int pi = g.d_c.div(u), c = g.d_c.mod(u, pi);
      size_t pix;
      int slot = pi;
      if (flat) {
        pix = (size_t)w.m0 + pi;
      } else {
        const int wy = g.d_ww.div(pi), wx = g.d_ww.mod(pi, wy);
        const int iy = w.iy0 + wy, ix = w.ix0 + wx;
        if (iy < 0 || iy >= g.H || ix < 0 || ix >= g.W) continue;
        pix = ((size_t)w.b * g.H + iy) * g.W + ix;
        slot = slot_of(g, wy, wx);
      }
      win[slot * g.P + c] = (int8_t)mma::quantize_s8(mma::to_f32(x[pix * g.ldx + c]), g.xs);
    }
  }
}

// y rounded to T, then the activation ACT (0 none, 1 ReLU, 2 SiLU) in f32;
// the caller rounds the result to T once more (a no-op but for SiLU).
template <typename T, int ACT>
__device__ __forceinline__ float activate(float y) {
  if (ACT == 0) return y;
  const float r = mma::round_to<T>(y);
  if (ACT == 1) return r < 0.f ? 0.f : r;
  return mma::silu_exact(r);
}

// Thread 0's clocks by phase, gathered when PROF (tools/tune_kernels.py int8).
template <bool PROF>
struct Clock {
  long long last = 0, acc[kPhases] = {0, 0, 0, 0};
  __device__ void start() {
    if (PROF) last = clock64();
  }
  __device__ void mark(int phase) {
    if (PROF) {
      const long long now = clock64();
      acc[phase] += now - last;
      last = now;
    }
  }
  __device__ void flush(unsigned long long* prof) {
    if (PROF && threadIdx.x == 0)
      for (int i = 0; i < kPhases; ++i) atomicAdd(prof + i, (unsigned long long)acc[i]);
  }
};

#ifndef INT8_CONV_MIN_BLOCKS
#define INT8_CONV_MIN_BLOCKS 8   // blocks an SM the register budget is cut for
#endif

template <typename T, int ACT, bool PROF>
__global__ void __launch_bounds__(kThreads, INT8_CONV_MIN_BLOCKS)
int8_conv_kernel(const T* __restrict__ x, const uint4* __restrict__ wfrag,
                 const float* __restrict__ scale, const float* __restrict__ bias,
                 T* __restrict__ out, Geo g, unsigned long long* prof) {
  Clock<PROF> clk;
  clk.start();
  extern __shared__ __align__(16) uint8_t smem[];
  int8_t* win = reinterpret_cast<int8_t*>(smem);
  constexpr int kSP = kBN + 16 / sizeof(T);     // stage pitch, elements
  T* stage = reinterpret_cast<T*>(smem + g.slots * g.P);
  const bool flat = g.th == 0;

  // the blocks sharing a window are neighbours: the ones after the first
  // find its bytes in L2
  const int tile = g.d_osplit.div(blockIdx.x), oslice = g.d_osplit.mod(blockIdx.x, tile);
  Win w{0, 0, 0, 0, 0, 0, 0};
  if (flat) {
    w.m0 = tile * kBM;
    w.npix = min(kBM, g.B * g.Ho * g.Wo - w.m0);
  } else {
    const int per_img = g.tiles_y * g.tiles_x;
    w.b = tile / per_img;
    const int t = tile - w.b * per_img;
    const int ty = g.d_tiles_x.div(t);
    w.oy0 = ty * g.th;
    w.ox0 = g.d_tiles_x.mod(t, ty) * g.tw;
    w.iy0 = w.oy0 * g.stride - g.pad;
    w.ix0 = w.ox0 * g.stride - g.pad;
  }
  stage_window(x, g, w, win);
  __syncthreads();
  clk.mark(0);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;   // 32-pixel half, 32-channel half of a pass
  const int srow = g.stride * g.wws;         // slots between window rows (tile mode)
  // the window slot of tap (0, 0) for this lane's row of each m16 tile
  int base[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r = 32 * wm + 16 * mt + (lane & 15);
    if (flat) {
      base[mt] = r;
    } else if (r < g.th * g.tw) {
      const int ry = g.d_tw.div(r);
      base[mt] = ry * g.stride * srow + g.d_tw.mod(r, ry);
    } else {
      base[mt] = 0;                           // a row past the tile: computed, never stored
    }
  }
  const uint32_t win_u32 = mma::smem_u32(win);
  const int npairs = (g.O + 15) >> 4, ksteps = g.kp >> 5, taps = g.k * g.k;
  const int gr = lane >> 2, t4 = lane & 3;

  for (int n0 = oslice * kBN; n0 < g.O; n0 += g.osplit * kBN) {
    int acc[2][2 * kNP][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 2 * kNP; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0;

    // this lane's 16 bytes of each 32-byte K step: tap (ky, kx), channel c
    int tap = (16 * (lane >> 4)) / g.cp, c = (16 * (lane >> 4)) % g.cp;
    int ky = tap / g.k, kx = tap % g.k;
    // B fragments kAhead K steps ahead of their MMAs (the weights come from
    // L1/L2)
    const int pair0 = (n0 >> 4) + kNP * wn;
    bool has[kNP];
#pragma unroll
    for (int j = 0; j < kNP; ++j) has[j] = pair0 + j < npairs;
    const uint4* bp = wfrag + (size_t)pair0 * 32 + lane;
    const size_t bstep = (size_t)npairs * 32;
    uint4 bq[kAhead][kNP];
#pragma unroll
    for (int d = 0; d < kAhead; ++d)
#pragma unroll
      for (int j = 0; j < kNP; ++j)
        bq[d][j] = has[j] && d < ksteps ? __ldg(bp + d * bstep + j * 32) : make_uint4(0, 0, 0, 0);
    for (int ks0 = 0; ks0 < ksteps; ks0 += kAhead) {
#pragma unroll
      for (int d = 0; d < kAhead; ++d) {
        const int ks = ks0 + d;
        if (ks >= ksteps) break;
        // past the last tap (K padding): any address, the weights are zero
        const bool real = tap < taps;
        const int toff = real ? ky * srow + (kx % g.stride) * g.wws + kx / g.stride : 0;
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          mma::ldmatrix_x4(a[mt], win_u32 + (real ? (base[mt] + toff) * g.P + c : 0));
        uint4 bb[kNP];
#pragma unroll
        for (int j = 0; j < kNP; ++j) bb[j] = bq[d][j];
        const int ahead = ks + kAhead;
#pragma unroll
        for (int j = 0; j < kNP; ++j)
          if (has[j] && ahead < ksteps) bq[d][j] = __ldg(bp + ahead * bstep + j * 32);
#pragma unroll
        for (int j = 0; j < kNP; ++j) {
          if (!has[j]) continue;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma::mma_16832_s8(acc[mt][2 * j], a[mt], bb[j].x, bb[j].y);
            mma::mma_16832_s8(acc[mt][2 * j + 1], a[mt], bb[j].z, bb[j].w);
          }
        }
        c += 32;
        while (c >= g.cp) {
          c -= g.cp;
          ++tap;
          if (++kx == g.k) {
            kx = 0;
            ++ky;
          }
        }
      }
    }
    clk.mark(1);

    // ---- epilogue: dequantize, round, activate into the stage tile
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 2 * kNP; ++j) {
        const int col = (kBN / 2) * wn + 8 * j + 2 * t4, gcol = n0 + col;
        if (gcol >= g.O) continue;
        const float s0 = scale[gcol], b0 = bias[gcol];
        const float s1 = gcol + 1 < g.O ? scale[gcol + 1] : 0.f;
        const float b1 = gcol + 1 < g.O ? bias[gcol + 1] : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 32 * wm + 16 * mt + gr + 8 * h;
          mma::store2(stage + row * kSP + col,
                      activate<T, ACT>(mma::dequant(acc[mt][j][2 * h], s0, b0)),
                      activate<T, ACT>(mma::dequant(acc[mt][j][2 * h + 1], s1, b1)));
        }
      }
    __syncthreads();
    clk.mark(2);

    // ---- whole rows of the pass to the output
    const int ncols = min(kBN, g.O - n0);
    const int nvalid = flat ? w.npix : g.th * g.tw;
    auto out_row = [&](int r) -> T* {
      if (r >= nvalid) return nullptr;
      if (flat) return out + (size_t)(w.m0 + r) * g.O + n0;
      const int ry = g.d_tw.div(r);
      const int oy = w.oy0 + ry, ox = w.ox0 + g.d_tw.mod(r, ry);
      if (oy >= g.Ho || ox >= g.Wo) return nullptr;
      return out + (((size_t)w.b * g.Ho + oy) * g.Wo + ox) * g.O + n0;
    };
    if (g.vec_out) {
      constexpr int kPer = 16 / sizeof(T);
      // a full pass is kBN / kPer words a row; the last may be narrower
      const mma::FastDiv& dv = ncols == kBN ? g.d_chunks : g.d_ncols;
      for (int u = threadIdx.x; u < kBM * dv.d; u += kThreads) {
        const int r = dv.div(u), ch = dv.mod(u, r);
        T* dst = out_row(r);
        if (dst)
          *reinterpret_cast<uint4*>(dst + ch * kPer) =
              *reinterpret_cast<const uint4*>(stage + r * kSP + ch * kPer);
      }
    } else {
      for (int u = threadIdx.x; u < kBM * ncols; u += kThreads) {
        const int r = u / ncols, cc = u - r * ncols;
        T* dst = out_row(r);
        if (dst) dst[cc] = stage[r * kSP + cc];
      }
    }
    __syncthreads();
    clk.mark(3);
  }
  clk.flush(prof);
}

template <typename T, int ACT, bool PROF>
int launch(const T* x, const uint4* wfrag, const float* scale, const float* bias, T* out,
           Geo g, unsigned long long* prof, cudaStream_t stream) {
  const int M = g.B * g.Ho * g.Wo;
  const int blocks = g.th == 0 ? (M + kBM - 1) / kBM : g.B * g.tiles_y * g.tiles_x;
  // Few windows (a 20 px site has 200): blocks share a window's passes of
  // 64 output channels, each quantizing the window itself, so that the card
  // holds about four blocks an SM.
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int passes = (g.O + kBN - 1) / kBN;
  g.osplit = max(1, min(passes, (4 * sms + blocks - 1) / blocks));
  g.d_osplit = mma::make_div(g.osplit);
  const size_t smem = (size_t)g.slots * g.P + kBM * (kBN * sizeof(T) + 16);
  static size_t allowed = 48 << 10;
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        int8_conv_kernel<T, ACT, PROF>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
      cudaGetLastError();   // not left behind for the next launch to report
      return (int)e;
    }
    allowed = smem;
  }
  int8_conv_kernel<T, ACT, PROF><<<blocks * g.osplit, kThreads, smem, stream>>>(
      x, wfrag, scale, bias, out, g, prof);
  return (int)cudaGetLastError();
}

// The activation and the profiling switch are template arguments: no branch
// an element.
template <typename T>
int by_act(const T* x, const uint4* wf, const float* scale, const float* bias, T* out,
           const Geo& g, unsigned long long* pr, cudaStream_t s) {
  switch (g.act + 3 * (pr != nullptr)) {
    case 0: return launch<T, 0, false>(x, wf, scale, bias, out, g, pr, s);
    case 1: return launch<T, 1, false>(x, wf, scale, bias, out, g, pr, s);
    case 2: return launch<T, 2, false>(x, wf, scale, bias, out, g, pr, s);
    case 3: return launch<T, 0, true>(x, wf, scale, bias, out, g, pr, s);
    case 4: return launch<T, 1, true>(x, wf, scale, bias, out, g, pr, s);
    default: return launch<T, 2, true>(x, wf, scale, bias, out, g, pr, s);
  }
}

}  // namespace

// th == 0 asks for the flat 1x1 mode (k 1, stride 1, pad 0); otherwise the
// output tile th x tw (th * tw <= 64) that ops/quant_conv.py:conv_tile chose.
// prof: null, or 4 u64 that gather thread 0's clocks by phase (stage, MMA,
// epilogue, store) over the blocks.
extern "C" int int8_conv(const void* x, const void* wfrag, const float* scale,
                         const float* bias, void* out, int B, int H, int W, int C,
                         int ldx, int Ho, int Wo, int O, int k, int stride, int pad,
                         int cp, int kp, int th, int tw, float xs, int act, int bf16,
                         void* prof, void* stream) {
  const int es = bf16 ? 2 : 4, kper = 16 / es;
  if (cp % 16 || cp < C || kp % 32 || kp < k * k * cp || th * tw > kBM || act < 0 || act > 2 ||
      (th == 0 && (k != 1 || stride != 1 || pad != 0 || Ho != H || Wo != W)) ||
      (th != 0 && tw <= 0))
    return (int)cudaErrorInvalidValue;
  Geo g{};
  g.B = B; g.H = H; g.W = W; g.C = C; g.ldx = ldx; g.Ho = Ho; g.Wo = Wo; g.O = O;
  g.k = k; g.stride = stride; g.pad = pad; g.cp = cp; g.kp = kp; g.th = th; g.tw = tw;
  g.xs = xs; g.act = act;
  g.P = (cp / 16) % 2 ? cp : cp + 16;
  if (th == 0) {
    g.slots = kBM;
    g.ww = kBM;
  } else {
    g.wh = (th - 1) * stride + k;
    g.ww = (tw - 1) * stride + k;
    g.wws = (g.ww + stride - 1) / stride;
    g.slots = g.wh * stride * g.wws;
    g.tiles_y = (Ho + th - 1) / th;
    g.tiles_x = (Wo + tw - 1) / tw;
  }
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  g.load = (C * es) % 16 == 0 && (ldx * es) % 16 == 0 && aligned ? 0
           : ldx == C && aligned                                  ? 1
                                                                  : 2;
  g.vec_out = (O * es) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  g.d_nchk = mma::make_div(max(1, C / kper));
  g.d_ww = mma::make_div(g.ww);
  g.d_s = mma::make_div(stride);
  g.d_tw = mma::make_div(max(tw, 1));
  g.d_chunks = mma::make_div(kBN / kper);
  g.d_ncols = mma::make_div(max(1, (O % kBN ? O % kBN : kBN) / kper));
  g.d_c = mma::make_div(C);
  g.d_per_row = mma::make_div(g.ww * C / kper + 2);
  g.d_tiles_x = mma::make_div(max(g.tiles_x, 1));
  if (bf16)
    return by_act(static_cast<const __nv_bfloat16*>(x), static_cast<const uint4*>(wfrag), scale,
                  bias, static_cast<__nv_bfloat16*>(out), g,
                  static_cast<unsigned long long*>(prof), (cudaStream_t)stream);
  return by_act(static_cast<const float*>(x), static_cast<const uint4*>(wfrag), scale, bias,
                static_cast<float*>(out), g, static_cast<unsigned long long*>(prof),
                (cudaStream_t)stream);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The 3x3 stride-1 class (the office graphs' RepVGG and head convs): its own
// kernel, built into this library.
#include "int8_conv3x3.cuh"
