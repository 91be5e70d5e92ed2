// Real-int8 dense 3x3 convolution, stride 1, pad 1, groups 1: the RepVGG
// deploy convs and Head_Effide's cls and reg convs of the YOLOv6 office
// graphs, with the activation that follows (none, ReLU or SiLU) fused. Built
// into the int8_conv library (included at the end of csrc/int8_conv.cu);
// ops/quant_conv.py routes every such site here and every other dense site
// to int8_conv.cu's kernel.
//
// Replaces no Pallas kernel: the JAX package computes this conv with XLA,
// the INT8_INFER branch of mafyolo_tpu/models/blocks.py:_RawConv (306-321).
// The contract is int8_conv.cu's, bit for bit: q(x) = clip(round_half_even(
// x / xs), -127, 127) by an IEEE division, exact s32 sums, then
// bf16/f32(f32(sum) * scale[o] + bias[o]) and the activation in f32 as torch
// computes it (ops/quant_conv.py:int8_conv_plain, then torch's activation).
//
// In: activations NHWC [B, H, W, C] in bf16 or f32 with a pixel pitch of
// `ldx` elements; the weights packed once on the host (ops/quant_conv.py:
// pack_3x3): int8 [K / 16, O, 16] with K = (ky, kx, c), c padded with zeros
// to cp (a multiple of 32): for each 16-byte chunk of K, every output
// channel's 16 bytes of it. Out: NHWC [B, H, W, O] in the input's type.
//
// Bound on the H100 (data sheet rates): operations at office M's and L's
// sites (a pixel does 18 C O int8 operations against 2 (C + O) bytes in and
// out: 2.0 and 3.6 int8 TOP a bs32@640 predict), bytes at office N's (C and O
// of 32-256). The windowed kernel (int8_conv.cu, built for bytes-bound 1x1 and
// stride-2 sites) reads its weights from L1/L2 for every 64 pixels through
// mma.sync and reached 7-9% of this class's bound. What the design does:
//
//   * Warpgroup MMA. Two consumer warpgroups issue
//     wgmma.mma_async.m64nNk32.s32.s8.s8 (N = BNW of 32, 64 or 128) with
//     both operands in shared memory and the s32 sums in registers, each on
//     MG sub-tiles of 8 x 8 output pixels (M = 64 rows of a wgmma), at most
//     64 sums a thread (BNW * MG <= 128: beyond it the epilogue spills).
//   * The window, quantized once. A block owns a th x tw tile of one image's
//     output pixels (multiples of 8) and quantizes the input under it plus a
//     one-pixel halo once (zeros outside the image), channel-blocked in
//     shared memory: [cp / 16][window pixel][16 bytes]. An 8-pixel run of a
//     window row is then one 128-byte core matrix, so the A operand of tap
//     (ky, kx) over channels 32 s .. 32 s + 31 of a sub-tile is a descriptor
//     with start (2 s) * LBO + (8 sy + ky) * (tw + 2) * 16 + (8 sx + kx) * 16,
//     LBO = one channel block ((th + 2) (tw + 2) * 16 bytes) and SBO = one
//     window row ((tw + 2) * 16 bytes): the 9 taps are 9 cp / 32 K steps over
//     the one window, with no im2col copy, and every offset is a multiple
//     of 16 bytes. Neighbouring threads write neighbouring words (no bank
//     conflict), and the quantizer (Quant below) has the IEEE division's
//     bits in fewer instructions, without a branch.
//   * Weights by TMA through a ring. B moves in K slices of kc 16-byte chunks
//     x nb output channels: one tensor copy a slice ([kc][nb][16] in shared
//     memory: core matrices of 8 channels x 16 bytes, SBO 128, LBO nb * 16),
//     issued by one producer warp into a ring of `stages` slots, each with
//     a full and an empty mbarrier. A consumer warpgroup waits for a slot's
//     bytes, issues its wgmmas, commits, and releases the slot it used one
//     slice earlier once wgmma.wait_group 1 says its MMAs are done, so one
//     slice's MMAs overlap the next one's wait and copy.
//   * The window is kept for all of the block's output channels: the block
//     walks its N tiles (nb = BNW, or 2 BNW when the two warpgroups split N
//     instead of pixels), so each input byte is quantized about (th + 2)
//     (tw + 2) / (th tw) times, not once per N tile. Where the pixel tiles
//     alone leave SMs idle (20 and 40 px), n_split blocks share a pixel
//     tile's N tiles, each quantizing the window itself.
//   * Epilogue: exactly int8_conv.cu's (__int2float_rn, __fmul_rn,
//     __fadd_rn, one rounding, the activation), a sub-tile at a time into a
//     shared-memory stage, then 16-byte stores of whole pixel runs of the N
//     tile.
// Measured (PERF.md §6, tools/tune_kernels.py int8_3x3): the MMAs take a
// tenth to a quarter of a block's clocks; what sets the pace is the exact
// contract's CUDA-core work on 8 warps an SM, the window's quantization and
// above all the SiLU epilogue (an expf and an IEEE division an output, whose
// slow-path branch serialises a thread's elements). Branch-free SiLU forms,
// bit-exact on every bf16 value, were not kept: on the accumulators they
// spilled; as a second pass over the stage their gain on office L was
// inside the spread between card runs (PERF.md §6).
//
// The tile, BNW, the split and the ring come from ops/quant_conv.py:plan3x3
// (its table TABLE3 from tools/tune_kernels.py int8_3x3's sweep).
#include <string.h>

#include "wgmma_s8.cuh"

namespace {
namespace c3 {

constexpr int kConsumers = 256;              // two warpgroups
constexpr int kThreads = kConsumers + 32;    // and one producer warp
constexpr int kMaxStages = 8;
constexpr int kBarBytes = 128;               // full[kMaxStages], then empty[kMaxStages]
constexpr int kInFlight = 4;                 // 16-byte loads a thread issues before using one
constexpr int kPhases = 5;                   // window, B wait, MMA, epilogue, store
constexpr int kSmemLimit = 232448;           // bytes a block may ask for on the H100
// Blocks an SM the register budget of a block with 64 accumulators a thread
// (BNW * MG = 128) is cut for.
constexpr int kMinBlocks128 = 2;

struct Geo {
  int B, H, W, C, ldx, O;
  int cp, cs, ksteps;        // C padded to 32; K steps (32 bytes) a tap; 9 * cs
  int th, tw, ww, wp;        // output tile; window row tw + 2; window pixels (th + 2) * ww
  int sx;                    // 8 x 8 sub-tiles in a tile row: tw / 8
  int split_n;               // the warpgroups split the N tile (else the pixels)
  int nb, ntn, n_split;      // channels of a block's N tile; N tiles; blocks a pixel tile
  int stages, kc, kss, nst;  // ring slots; 16-byte K chunks a slot; K steps a slot; slots a tile
  int tiles_y, tiles_x;
  int ring_off, win_off, out_off, sbytes;   // shared-memory offsets; bytes of a slot
  int opitch;                // elements between the output stage's pixels
  int load, vec_out, act;
  float xs;
  mma::FastDiv d_ww, d_blk, d_cp, d_tiles_x, d_nsplit;   // d_blk: 16-byte words of a channel block
};

// y rounded to T, then the activation (0 none, 1 ReLU, 2 SiLU) in f32; the
// caller rounds the result to T once more (a no-op but for SiLU). The same
// steps as int8_conv.cu's activate, the activation a uniform argument.
template <typename T>
__device__ __forceinline__ float activate(float y, int act) {
  if (act == 0) return y;
  const float r = mma::round_to<T>(y);
  if (act == 1) return r < 0.f ? 0.f : r;
  return mma::silu_exact(r);
}

// q(x) = clip(round_half_even(x / xs), -127, 127) as a byte, with the bits of
// mma::quantize_s8 in fewer instructions (the window's quantization is what
// sets this kernel's pace):
//   * x is first clamped to +-lim, lim = RN(127 xs): beyond it q is +-127
//     either way, and RN(lim / xs) rounds to 127, so no clamp is needed
//     after the division and no quotient can overflow;
//   * the IEEE quotient RN(x / xs) by Markstein's correction with the
//     correctly rounded reciprocal rcp = RN(1 / xs), computed once: q0 =
//     RN(x rcp), r = x - q0 xs (exact, one FMA), RN(q0 + r rcp) = RN(x / xs)
//     for every quotient in the normal range (below it, q is 0 either way);
//   * round half to even by adding 1.5 * 2^23 (one rounded add), whose low
//     byte is the integer: no quarter-rate float-to-int convert.
// It serves the 16-byte loads (load path 0, every office site); the
// element-wise loads of other shapes keep mma::quantize_s8. chip_smoke.py and
// tests/test_torch_gpu.py hold it to the plain version on every finite bf16
// value and on f32 values at the rounding's edges, at several scales, through
// a 16-channel probe that takes the 16-byte loads
// (utils/sample.py:int8_quant_every_bf16).
struct Quant {
  float xs, rcp, lim;
  __device__ __forceinline__ uint32_t byte(float x) const {
    const float c = fminf(fmaxf(x, -lim), lim);
    const float q0 = __fmul_rn(c, rcp);
    const float q = __fmaf_rn(__fmaf_rn(-q0, xs, c), rcp, q0);
    return __float_as_uint(__fadd_rn(q, 12582912.f)) & 0xffu;
  }
};
__device__ __forceinline__ Quant make_quant(float xs) {
  return Quant{xs, __frcp_rn(xs), __fmul_rn(127.f, xs)};
}
__device__ __forceinline__ void quant_store(uint8_t* dst, uint4 v, const Quant& qz,
                                            __nv_bfloat16*) {
  float f[8];
  mma::unpack8(v, f);
  uint32_t w[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    w[h] = qz.byte(f[4 * h]) | qz.byte(f[4 * h + 1]) << 8 | qz.byte(f[4 * h + 2]) << 16 |
           qz.byte(f[4 * h + 3]) << 24;
  *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
}
__device__ __forceinline__ void quant_store(uint8_t* dst, uint4 v, const Quant& qz, float*) {
  const float4 f = *reinterpret_cast<const float4*>(&v);
  *reinterpret_cast<uint32_t*>(dst) =
      qz.byte(f.x) | qz.byte(f.y) << 8 | qz.byte(f.z) << 16 | qz.byte(f.w) << 24;
}

// The window's quantized bytes, channel-blocked, by the 256 consumer threads.
// Neighbouring threads take the neighbouring 16-byte words of a channel
// block: 8 (bf16) or 4 (f32) bytes apart in shared memory, no bank conflict;
// in device memory each pixel's 32 (or 64) bytes of the block are one
// sector.
template <typename T>
__device__ void stage_window(const T* __restrict__ x, const Geo& g, int b, int iy0, int ix0,
                             uint8_t* win, int tid) {
  if (g.load == 0) {
    // padding channels and pixels outside the image quantize zeros
    constexpr int kPer = Elem<T>::kPer16, kParts = 16 / kPer;   // words of a block's pixel
    const int units = g.wp * g.cp / kPer;
    const Quant qz = make_quant(g.xs);
    for (int u0 = tid; u0 < units; u0 += kConsumers * kInFlight) {
      uint4 v[kInFlight];
      int dst[kInFlight];
#pragma unroll
      for (int i = 0; i < kInFlight; ++i) {
        const int u = u0 + i * kConsumers;
        v[i] = make_uint4(0u, 0u, 0u, 0u);
        dst[i] = -1;
        if (u < units) {
          const int cb = g.d_blk.div(u), r = g.d_blk.mod(u, cb);
          const int pix = r / kParts, c = 16 * cb + (r % kParts) * kPer;
          const int wy = g.d_ww.div(pix), wx = g.d_ww.mod(pix, wy);
          const int iy = iy0 + wy, ix = ix0 + wx;
          dst[i] = cb * g.wp * 16 + r * kPer;
          if (c < g.C && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W)
            v[i] = __ldg(reinterpret_cast<const uint4*>(
                x + (((size_t)b * g.H + iy) * g.W + ix) * g.ldx + c));
        }
      }
#pragma unroll
      for (int i = 0; i < kInFlight; ++i)
        if (dst[i] >= 0) quant_store(win + dst[i], v[i], qz, static_cast<T*>(nullptr));
    }
    return;
  }
  for (int u = tid; u < g.wp * g.cp; u += kConsumers) {
    const int pix = g.d_cp.div(u), c = g.d_cp.mod(u, pix);
    const int wy = g.d_ww.div(pix), wx = g.d_ww.mod(pix, wy);
    const int iy = iy0 + wy, ix = ix0 + wx;
    int q = 0;
    if (c < g.C && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W)
      q = mma::quantize_s8(mma::to_f32(x[(((size_t)b * g.H + iy) * g.W + ix) * g.ldx + c]),
                           g.xs);
    win[(c >> 4) * g.wp * 16 + pix * 16 + (c & 15)] = (uint8_t)(q & 0xff);
  }
}

template <typename T, int BNW, int MG>
__global__ void __launch_bounds__(kThreads, BNW * MG <= 64 ? 3 : kMinBlocks128)
conv3x3_kernel(const __grid_constant__ CUtensorMap wmap, const T* __restrict__ x,
               const float* __restrict__ scale, const float* __restrict__ bias,
               T* __restrict__ out, const Geo g, unsigned long long* __restrict__ prof) {
  extern __shared__ __align__(128) uint8_t smem3[];
  uint8_t* smem = smem3;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  // blocks sharing a pixel tile are neighbours: the later ones find its
  // input in L2
  const int tile = g.d_nsplit.div(blockIdx.x), ns = g.d_nsplit.mod(blockIdx.x, tile);
  const int per_img = g.tiles_y * g.tiles_x;
  const int b = tile / per_img, t = tile - b * per_img;
  const int ty = g.d_tiles_x.div(t), tx = g.d_tiles_x.mod(t, ty);
  const int oy0 = ty * g.th, ox0 = tx * g.tw;
  if (threadIdx.x == 0) {
    for (int s = 0; s < g.stages; ++s) {
      wg::mbar_init(full + s, 1);
      wg::mbar_init(empty + s, 2);     // one arrival a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    wg::fence_proxy_async();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- the producer: one lane keeps the ring's copies in flight
    if (threadIdx.x == kConsumers) {
      int slot = 0, use = 0;
      for (int nt = ns; nt < g.ntn; nt += g.n_split)
        for (int s = 0; s < g.nst; ++s) {
          wg::mbar_wait(empty + slot, (use & 1) ^ 1);
          wg::mbar_expect_tx(full + slot, (uint32_t)g.sbytes);
          wg::tma_load_3d(smem + g.ring_off + slot * g.sbytes, &wmap, full + slot, 0, nt * g.nb,
                          s * g.kc);
          if (++slot == g.stages) {
            slot = 0;
            ++use;
          }
        }
    }
    return;
  }

  // ---- the consumers
  const int tid = threadIdx.x, wgi = tid >> 7, wt = tid & 127, wl = (tid >> 5) & 3;
  const int lane = tid & 31, gq = lane >> 2, t4 = lane & 3;
  // thread 0's clocks by phase, gathered when prof (tools/tune_kernels.py)
  long long clk[kPhases] = {0, 0, 0, 0, 0};
  long long mark = prof ? clock64() : 0;
  auto lap = [&](int phase) {
    if (prof) {
      const long long now = clock64();
      clk[phase] += now - mark;
      mark = now;
    }
  };
  uint8_t* win = smem + g.win_off;
  stage_window<T>(x, g, b, oy0 - 1, ox0 - 1, win, tid);
  wg::fence_proxy_async();
  wg::bar_sync(1, kConsumers);
  lap(0);

  // this warpgroup's 8 x 8 sub-tiles: their offsets in the tile, and the
  // window pixel under each one's first output pixel for tap (0, 0)
  int suby[MG], subx[MG], sub[MG];
#pragma unroll
  for (int m = 0; m < MG; ++m) {
    const int idx = g.split_n ? m : wgi * MG + m;
    const int sy = idx / g.sx;
    suby[m] = 8 * sy;
    subx[m] = 8 * (idx - sy * g.sx);
    sub[m] = suby[m] * g.ww + subx[m];
  }
  const int n_wg = g.split_n ? wgi * BNW : 0;
  const uint32_t win_u32 = mma::smem_u32(win), ring_u32 = mma::smem_u32(smem + g.ring_off);
  const uint32_t lbo_a = g.wp * 16, sbo_a = g.ww * 16, lbo_b = g.nb * 16;
  T* stage = reinterpret_cast<T*>(smem + g.out_off) + (size_t)wgi * 64 * g.opitch;
  int slot = 0, use = 0;
  for (int nt = ns; nt < g.ntn; nt += g.n_split) {
    int acc[MG][BNW / 2];
#pragma unroll
    for (int m = 0; m < MG; ++m)
#pragma unroll
      for (int i = 0; i < BNW / 2; ++i) acc[m][i] = 0;
    int ks = 0, c32 = 0, ky = 0, kx = 0, prev = -1;
    for (int s = 0; s < g.nst; ++s) {
      wg::mbar_wait(full + slot, use & 1);
      lap(1);
#pragma unroll
      for (int m = 0; m < MG; ++m)
#pragma unroll
        for (int i = 0; i < BNW / 2; ++i) wg::fence_reg(acc[m][i]);
      wg::fence();
      const uint32_t bslot = ring_u32 + slot * g.sbytes + n_wg * 16;
      for (int kk = 0; kk < g.kss && ks < g.ksteps; ++kk, ++ks) {
        const uint64_t db = wg::desc(bslot + 2 * kk * lbo_b, lbo_b, 128);
        const uint32_t a0 = win_u32 + 2 * c32 * lbo_a + (ky * g.ww + kx) * 16;
#pragma unroll
        for (int m = 0; m < MG; ++m)
          wg::Wgmma<BNW>::mma(acc[m], wg::desc(a0 + sub[m] * 16, lbo_a, sbo_a), db, 1);
        if (++c32 == g.cs) {
          c32 = 0;
          if (++kx == 3) {
            kx = 0;
            ++ky;
          }
        }
      }
      wg::commit();
      if (prev >= 0) {   // the slot one slice back: its MMAs are done
        wg::wait<1>();
        if (wt == 0) wg::mbar_arrive(empty + prev);
      }
      prev = slot;
      if (++slot == g.stages) {
        slot = 0;
        ++use;
      }
      lap(2);
    }
    wg::wait<0>();
#pragma unroll
    for (int m = 0; m < MG; ++m)
#pragma unroll
      for (int i = 0; i < BNW / 2; ++i) wg::fence_reg(acc[m][i]);
    if (wt == 0) wg::mbar_arrive(empty + prev);
    lap(2);

    // ---- epilogue, a sub-tile at a time: dequantize, round, activate into
    // the stage, then whole pixel runs of the N tile to the output
    const int n0 = nt * g.nb + n_wg;
    const int ncols = min(BNW, g.O - n0);
    constexpr int kPer = 16 / sizeof(T);
    const int per_px = g.vec_out ? ncols / kPer : ncols;
#pragma unroll
    for (int m = 0; m < MG; ++m) {
      wg::bar_sync(2 + wgi, 128);   // the stage's last reads are done
#pragma unroll
      for (int j = 0; j < BNW / 8; ++j) {
        const int col = 8 * j + 2 * t4, n = n0 + col;
        const float s0 = n < g.O ? scale[n] : 0.f, b0 = n < g.O ? bias[n] : 0.f;
        const float s1 = n + 1 < g.O ? scale[n + 1] : 0.f, b1 = n + 1 < g.O ? bias[n + 1] : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int px = 16 * wl + gq + 8 * h;
          mma::store2(stage + px * g.opitch + col,
                      activate<T>(mma::dequant(acc[m][4 * j + 2 * h], s0, b0), g.act),
                      activate<T>(mma::dequant(acc[m][4 * j + 2 * h + 1], s1, b1), g.act));
        }
      }
      wg::bar_sync(2 + wgi, 128);
      lap(3);
      for (int u = wt; u < 64 * per_px; u += 128) {
        const int px = u / per_px, e = u - px * per_px;
        const int oy = oy0 + suby[m] + (px >> 3), ox = ox0 + subx[m] + (px & 7);
        if (ncols <= 0 || oy >= g.H || ox >= g.W) continue;
        T* dst = out + (((size_t)b * g.H + oy) * g.W + ox) * g.O + n0;
        if (g.vec_out)
          *reinterpret_cast<uint4*>(dst + e * kPer) =
              *reinterpret_cast<const uint4*>(stage + px * g.opitch + e * kPer);
        else
          dst[e] = stage[px * g.opitch + e];
      }
      lap(4);
    }
  }
  if (prof && tid == 0)
    for (int i = 0; i < kPhases; ++i) atomicAdd(prof + i, (unsigned long long)clk[i]);
}

// cuTensorMapEncodeTiled, looked up in libcuda once at run time (no link against it).
using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeFn encoder() {
  static EncodeFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess || q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeFn>(p);
  }();
  return fn;
}

template <typename T, int BNW, int MG>
int launch(const CUtensorMap& map, const void* x, const float* scale, const float* bias,
           void* out, const Geo& g, size_t smem, int blocks, unsigned long long* prof,
           cudaStream_t stream) {
  // the attribute belongs to an instantiation: raised once per size, not per launch
  static size_t allowed = 48 << 10;
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv3x3_kernel<T, BNW, MG>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
      cudaGetLastError();   // not left behind for the next launch to report
      return (int)e;
    }
    allowed = smem;
  }
  conv3x3_kernel<T, BNW, MG><<<blocks, kThreads, smem, stream>>>(
      map, static_cast<const T*>(x), scale, bias, static_cast<T*>(out), g, prof);
  return (int)cudaGetLastError();
}

template <typename T>
int by_shape(int bnw, int mg, const CUtensorMap& map, const void* x, const float* scale,
             const float* bias, void* out, const Geo& g, size_t smem, int blocks,
             unsigned long long* prof, cudaStream_t s) {
  switch (bnw * 4 + mg) {
    case 32 * 4 + 1: return launch<T, 32, 1>(map, x, scale, bias, out, g, smem, blocks, prof, s);
    case 32 * 4 + 2: return launch<T, 32, 2>(map, x, scale, bias, out, g, smem, blocks, prof, s);
    case 64 * 4 + 1: return launch<T, 64, 1>(map, x, scale, bias, out, g, smem, blocks, prof, s);
    case 64 * 4 + 2: return launch<T, 64, 2>(map, x, scale, bias, out, g, smem, blocks, prof, s);
    case 128 * 4 + 1:
      return launch<T, 128, 1>(map, x, scale, bias, out, g, smem, blocks, prof, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace c3
}  // namespace

// Shared memory of one block of the 3x3 stride-1 kernel (mirrors
// ops/quant_conv.py:smem3x3): the barriers, the ring, the window and two
// warpgroups' output stages (a sub-tile's 64 pixels each).
static int int8_conv3x3_smem(int cp, int th, int tw, int bnw, int split_n, int stages, int kc,
                             int esize) {
  const int nb = bnw * (split_n ? 2 : 1);
  const int win = ((th + 2) * (tw + 2) * cp + 127) / 128 * 128;
  return c3::kBarBytes + stages * nb * kc * 16 + win + 2 * 64 * (bnw * esize + 16);
}

// How the 3x3 stride-1 kernel stages a window of x: 0 by 16-byte loads
// quantized by c3::Quant (C and the pixel pitch ldx whole 16-byte words, x
// 16-byte aligned), 1 element by element through mma::quantize_s8.
extern "C" int int8_conv3x3_load_path(const void* x, int C, int ldx, int bf16) {
  const int kper = bf16 ? 8 : 4;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  return C % kper == 0 && ldx % kper == 0 && aligned ? 0 : 1;
}

// One launch of the 3x3 stride-1 kernel: th x tw output tiles (multiples of
// 8; th * tw / 64 sub-tiles of 8 x 8, shared by the two warpgroups, or each
// warpgroup all of them when split_n), wgmma N = bnw, n_split blocks a pixel
// tile, a ring of `stages` slots of kc 16-byte K chunks. Every such choice
// comes from ops/quant_conv.py:plan3x3. prof: null, or 5 u64 that gather
// thread 0's clocks by phase (window, B wait, MMA, epilogue, store) over the
// blocks.
extern "C" int int8_conv3x3(const void* x, const void* wk, const float* scale,
                            const float* bias, void* out, int B, int H, int W, int C, int ldx,
                            int O, int cp, int th, int tw, int bnw, int split_n, int n_split,
                            int stages, int kc, float xs, int act, int bf16, void* prof,
                            void* stream) {
  using c3::kBarBytes;
  using c3::kMaxStages;
  using c3::kSmemLimit;
  const int es = bf16 ? 2 : 4, kper = 16 / es;
  const int nsub = th > 0 && tw > 0 ? th * tw / 64 : 0;
  const int mg = split_n ? nsub : nsub / 2, nb = bnw * (split_n ? 2 : 1);
  if (cp % 32 || cp < C || C < 1 || O < 1 || th % 8 || tw % 8 || nsub < 1 ||
      (!split_n && nsub % 2) || mg < 1 || mg > 2 || bnw * mg > 128 || act < 0 || act > 2 ||
      stages < 2 ||
      stages > kMaxStages || kc < 2 || kc % 2 || kc > 256 || nb > 256 || n_split < 1 ||
      reinterpret_cast<uintptr_t>(wk) % 16)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)int8_conv3x3_smem(cp, th, tw, bnw, split_n, stages, kc, es);
  // descriptor fields are 14 bits of 16-byte units: LBO of the window below 256 KB
  if (smem > (size_t)kSmemLimit || (th + 2) * (tw + 2) >= (1 << 14))
    return (int)cudaErrorInvalidValue;
  c3::Geo g{};
  g.B = B; g.H = H; g.W = W; g.C = C; g.ldx = ldx; g.O = O;
  g.cp = cp; g.cs = cp / 32; g.ksteps = 9 * g.cs;
  g.th = th; g.tw = tw; g.ww = tw + 2; g.wp = (th + 2) * g.ww; g.sx = tw / 8;
  g.split_n = split_n; g.nb = nb; g.ntn = (O + nb - 1) / nb; g.n_split = min(n_split, g.ntn);
  g.stages = stages; g.kc = kc; g.kss = kc / 2; g.nst = (g.ksteps + g.kss - 1) / g.kss;
  g.tiles_y = (H + th - 1) / th; g.tiles_x = (W + tw - 1) / tw;
  g.sbytes = nb * kc * 16;
  g.ring_off = kBarBytes;
  g.win_off = kBarBytes + stages * g.sbytes;
  g.out_off = g.win_off + (g.wp * cp + 127) / 128 * 128;
  g.opitch = bnw + kper;
  g.xs = xs; g.act = act;
  g.load = int8_conv3x3_load_path(x, C, ldx, bf16);
  g.vec_out = O % kper == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  g.d_ww = mma::make_div(g.ww);
  g.d_blk = mma::make_div(g.wp * 16 / kper);
  g.d_cp = mma::make_div(cp);
  g.d_tiles_x = mma::make_div(g.tiles_x);
  g.d_nsplit = mma::make_div(g.n_split);
  const long long blocks = (long long)B * g.tiles_y * g.tiles_x * g.n_split;
  if (blocks >= (1ll << 31) || (long long)g.wp * cp >= (1ll << 31))
    return (int)cudaErrorInvalidValue;

  // the weights' map: [K / 16][O][16] bytes, a box of [kc][nb][16]; rows
  // past O and chunks past K arrive as zeros
  c3::EncodeFn encode = c3::encoder();
  if (!encode) return (int)cudaErrorInvalidValue;
  alignas(64) CUtensorMap map;
  memset(&map, 0, sizeof map);
  const cuuint64_t dims[3] = {16, (cuuint64_t)O, (cuuint64_t)(9 * cp / 16)};
  const cuuint64_t strides[2] = {16, (cuuint64_t)O * 16};
  const cuuint32_t box[3] = {16, (cuuint32_t)nb, (cuuint32_t)kc};
  const cuuint32_t ones[3] = {1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(wk), dims, strides, box,
             ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  auto* pr = static_cast<unsigned long long*>(prof);
  const cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? c3::by_shape<__nv_bfloat16>(bnw, mg, map, x, scale, bias, out, g, smem, (int)blocks,
                                         pr, s)
              : c3::by_shape<float>(bnw, mg, map, x, scale, bias, out, g, smem, (int)blocks, pr, s);
}
