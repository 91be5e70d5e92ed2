// Depthwise-conv weight gradient: register-tiled taps over a staged tile,
// a streaming product for k = 1, and a fixed-order sum of the splits.
//
// Replaces: mafyolo_tpu/ops/dw_grad_pallas.py:dw_grad_planar (_planar_kernel)
// and :dw_grad_kernel (_dk_kernel), the two Pallas forms of the same sum.
//
// Computes, for a stride-1 depthwise conv with kernel k, padding pad and
// dilation d:
//   dk[c, ky, kx] = sum_{b, ho, wo} x[b, ho + ky*d - pad, wo + kx*d - pad, c]
//                                   * g[b, ho, wo, c]
// with x [B, H, W, C] and g [B, Ho, Wo, C] in channels-last memory (f32 or
// bf16), zeros read outside the image, and f32 accumulation. Output f32
// [C, 1, k, k] (the torch depthwise weight layout). Any H, W and C.
//
// Bound on the H100. By the roofline the work is bound by bytes (x and g
// read once: 3.5 GB over the 53 sites of MAF-YOLO-N's train step against
// 13.9 G multiply-adds). In practice a CUDA-core stencil is bound by the
// instructions it issues beside its FMAs (an SM issues 4 a clock, and an FMA
// is one of them): shared-memory loads, bf16 -> f32 converts and whatever
// copies the tile. k = 3 at 80 and 160 px and k = 1 are near the memory
// rate; everything else is bound by issue slots. What the design does:
//   - Register tiling along W (dk_tile). A block owns 32 * CPT channels
//     (lane l of every warp has channels CPT l .. CPT l + CPT - 1, so every
//     access is contiguous along C) and walks a fixed, strided list of
//     output tiles (b, row band, column band). A warp takes runs of R = 10
//     consecutive output columns: g's 10 values go to registers once, and
//     the 10 + (k-1) staged x values of a row are read once each and feed up
//     to k FMAs from registers: (R + k - 1) / (R k) shared loads per FMA,
//     0.2 at k = 9, against 1 for a tap-by-tap walk. The k*k sums live in
//     registers for the whole walk.
//   - Bands of two output rows (k <= 7): a staged row is tap ky of one
//     output row and ky - 1 of the next, so k + 1 row reads serve 2 k row
//     taps, and the loads and converts per FMA nearly halve again.
//   - Two channels a lane (CPT = 2) at k = 3, whose 18 sums a lane leave the
//     registers for it: one 32-bit load brings a bf16 pair, and a pixel's
//     copy is a whole 128-byte line. (At k = 5 and 7 that form was measured
//     no faster than one channel a lane, and is not built.)
//   - Tiles arrive by tensor copies (TMA, cp.async.bulk.tensor): one thread
//     asks for the x box (halo included) and the g box of a tile, the copy
//     engine writes them to shared memory in the source type and fills what
//     lies outside the image or beyond C with zeros, and an mbarrier counts
//     the bytes. No warp spends issue slots or waits in a copy loop (16-byte
//     cp.async by all warps took 30-55% of a block's clocks, most of it
//     stalled on its own copies). Two stages: tile t + 1 arrives while tile t
//     is multiplied. C that is no multiple of 8 (4 for f32), or an unaligned
//     base, takes an element-wise staging loop into one stage.
//   - The tile (rows x columns, whole runs), CPT and the number of splits
//     come from the wrapper's planner (ops/dw_grad.py:plan): one tile per
//     kernel size, taken from a sweep on the card.
//   - k = 1 without padding (dk_stream) needs no shared tile: a thread owns
//     8 channels, streams 16-byte loads of x and g and keeps 8 sums.
//   - The warps' sums meet in shared memory behind one barrier, each tap
//     summed over the warps in index order; a second launch (dk_reduce)
//     sums the splits, 8 interleaved partial sums in index order and then
//     those 8 in order. No atomics: the same inputs on the same card give
//     the same bits.
#include <atomic>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kNW = 8;         // warps per block
constexpr int kThreads = 32 * kNW;

__device__ __forceinline__ void set_zero(float& v) { v = 0.f; }
__device__ __forceinline__ void set_zero(__nv_bfloat16& v) { v = __float2bfloat16(0.f); }

// One lane's CPT consecutive channels of a staged pixel, as floats.
__device__ __forceinline__ void ld_vals(const float* p, float (&v)[1]) { v[0] = *p; }
__device__ __forceinline__ void ld_vals(const float* p, float (&v)[2]) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  v[0] = t.x; v[1] = t.y;
}
__device__ __forceinline__ void ld_vals(const __nv_bfloat16* p, float (&v)[1]) {
  v[0] = __bfloat162float(*p);
}
__device__ __forceinline__ void ld_vals(const __nv_bfloat16* p, float (&v)[2]) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  v[0] = __uint_as_float(w << 16);
  v[1] = __uint_as_float(w & 0xffff0000u);
}

// Element-wise staging, for C or a base address that the tensor copy
// cannot take: a [rows, cols] window of one image (pixel (y0, x0) at its
// corner, zeros outside [0, H) x [0, W) and beyond channel C) into dst
// [rows][cols][CT], a warp a row.
template <int CT, typename T>
__device__ __forceinline__ void stage(T* dst, const T* img, int rows, int cols,
                                      int y0, int x0, int H, int W, int C, int c0,
                                      int warp, int lane) {
  for (int sy = warp; sy < rows; sy += kNW) {
    const int y = y0 + sy;
    const bool yin = y >= 0 && y < H;
    const T* srow = img + (size_t)(yin ? y : 0) * W * C;
    T* drow = dst + (size_t)sy * cols * CT;
    for (int q = lane; q < cols * CT; q += 32) {
      const int sx = q / CT, cc = q % CT;
      const int xx = x0 + sx;
      T v;
      set_zero(v);
      if (yin && xx >= 0 && xx < W && c0 + cc < C) v = srow[(size_t)xx * C + c0 + cc];
      drow[q] = v;
    }
  }
}

// ---- the tensor copy (TMA) and its barrier, in PTX
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(mma::smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(mma::smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(mma::smem_u32(bar)), "r"(parity)
        : "memory");
  }
}
// One box of a 4-d tensor (coordinates innermost first: channel, column, row,
// image; anything outside the tensor arrives as zeros) into shared memory.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c, int x, int y, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(mma::smem_u32(dst)),
      "l"(map), "r"(mma::smem_u32(bar)), "r"(c), "r"(x), "r"(y), "r"(b)
      : "memory");
}

constexpr int kStages = 2;       // staged tiles a block holds
constexpr int kBarBytes = 128;   // the stages' barriers, ahead of the first tile
__host__ __device__ constexpr size_t round128(size_t n) { return (n + 127) / 128 * 128; }

// A block owns CT = 32 * CPT channels: lane l of every warp has channels
// CPT * l .. CPT * l + CPT - 1, read from the staged tile in one load. R is
// the register run, in output columns, and divides TW. D1: dilation 1, the
// register window along W, over bands of RT output rows that share their
// staged rows (a staged row feeds tap ky of one row and ky - 1 of the next);
// else one load per FMA and RT = 1. tma: the tiles arrive by
// tensor copies through mx and mg, two stages; else element-wise, one stage.
template <int K, typename T, bool D1, int CPT, int R, int RT>
__global__ void __launch_bounds__(kThreads, K * K * CPT >= 49 ? 2 : 3)
dk_tile(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mg,
        const T* __restrict__ x, const T* __restrict__ g,
        float* __restrict__ part, int H, int W, int C, int Ho, int Wo, int pad,
        int dil, int TH, int TW, int tiles_h, int tiles_w, int n_tiles, int tma,
        long long* __restrict__ prof) {
  constexpr int CT = 32 * CPT;
  // prof (the tuning tool's; null otherwise): clocks of warp 0 in each phase
  long long clk[4] = {0, 0, 0, 0}, mark = prof ? clock64() : 0;
  auto lap = [&](int phase) {
    if (prof) {
      const long long now = clock64();
      clk[phase] += now - mark;
      mark = now;
    }
  };
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int halo = (K - 1) * dil;
  const int runs = TW / R;
  const int SH = TH + halo, SW = TW + halo;
  const size_t x_elems = (size_t)SH * SW * CT, g_elems = (size_t)TH * TW * CT;
  const size_t x_bytes = round128(x_elems * sizeof(T));
  const size_t stage_bytes = x_bytes + round128(g_elems * sizeof(T));
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * CT;
  const int per_image = tiles_h * tiles_w;

  // tile t -> stage s: x [SH][SW][CT] at the stage's base, g [TH][TW][CT] behind it
  auto issue = [&](int t, int s) {
    const int b = t / per_image, r = t - b * per_image;
    const int h0 = (r / tiles_w) * TH, w0 = (r % tiles_w) * TW;
    unsigned char* base = smem_raw + kBarBytes + s * stage_bytes;
    mbar_expect_tx(&bar[s], (uint32_t)((x_elems + g_elems) * sizeof(T)));
    tma_load_4d(base, &mx, &bar[s], c0, w0 - pad, h0 - pad, b);
    tma_load_4d(base + x_bytes, &mg, &bar[s], c0, w0, h0, b);
  };
  if (tma) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) mbar_init(&bar[s], 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0 && (int)blockIdx.y < n_tiles) issue(blockIdx.y, 0);
  }

  float acc[CPT][K * K];
#pragma unroll
  for (int u = 0; u < CPT; ++u)
#pragma unroll
    for (int j = 0; j < K * K; ++j) acc[u][j] = 0.f;

  int it = 0;
  for (int t = blockIdx.y; t < n_tiles; t += gridDim.y, ++it) {
    const int b = t / per_image, r = t - b * per_image;
    const int h0 = (r / tiles_w) * TH;
    const int w0 = (r % tiles_w) * TW;
    const int s = tma ? it & 1 : 0;
    const T* xs = reinterpret_cast<const T*>(smem_raw + kBarBytes + s * stage_bytes);
    const T* gs = reinterpret_cast<const T*>(smem_raw + kBarBytes + s * stage_bytes + x_bytes);
    __syncthreads();   // the previous tile's reads are done: its stage is free
    if (tma) {
      if (threadIdx.x == 0 && t + (int)gridDim.y < n_tiles) issue(t + gridDim.y, s ^ 1);
      lap(0);
      mbar_wait(&bar[s], (it >> 1) & 1);
    } else {
      stage<CT>(const_cast<T*>(xs), x + (size_t)b * H * W * C, SH, SW, h0 - pad, w0 - pad,
                H, W, C, c0, warp, lane);
      stage<CT>(const_cast<T*>(gs), g + (size_t)b * Ho * Wo * C, TH, TW, h0, w0, Ho, Wo, C,
                c0, warp, lane);
      lap(0);
      __syncthreads();
    }
    lap(1);

    const int bands = (TH + RT - 1) / RT;
    for (int n = warp; n < bands * runs; n += kNW) {
      const int ty = (n / runs) * RT;
      const int col = (n - (n / runs) * runs) * R;
      if (h0 + ty >= Ho || w0 + col >= Wo) continue;   // g is all zero there
      // rows of the band that the tile has (g of a row past Ho arrived as zeros)
      const int live = min(RT, TH - ty);
      float gv[RT][R][CPT];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        if (r == 0 || r < live) {
          const T* gp = gs + ((size_t)(ty + r) * TW + col) * CT + lane * CPT;
#pragma unroll
          for (int i = 0; i < R; ++i) ld_vals(gp + i * CT, gv[r][i]);
        }
      }
      if (D1) {
        // staged row ty + yy feeds tap ky = yy - r of the band's row r
#pragma unroll
        for (int yy = 0; yy < K + RT - 1; ++yy) {
          if (yy - (K - 1) >= live) break;
          const T* row = xs + ((size_t)(ty + yy) * SW + col) * CT + lane * CPT;
#pragma unroll
          for (int j = 0; j < R + K - 1; ++j) {
            float xv[CPT];
            ld_vals(row + j * CT, xv);
#pragma unroll
            for (int r = 0; r < RT; ++r) {
              const int ky = yy - r;
              if (ky >= 0 && ky < K && (r == 0 || r < live)) {
#pragma unroll
                for (int kx = 0; kx < K; ++kx) {
                  const int i = j - kx;
                  if (i >= 0 && i < R) {
#pragma unroll
                    for (int u = 0; u < CPT; ++u)
                      acc[u][ky * K + kx] = fmaf(xv[u], gv[r][i][u], acc[u][ky * K + kx]);
                  }
                }
              }
            }
          }
        }
      } else {
#pragma unroll
        for (int ky = 0; ky < K; ++ky) {
#pragma unroll
          for (int kx = 0; kx < K; ++kx) {
            const T* row =
                xs + ((size_t)(ty + ky * dil) * SW + col + kx * dil) * CT + lane * CPT;
#pragma unroll
            for (int i = 0; i < R; ++i) {
              float xv[CPT];
              ld_vals(row + i * CT, xv);
#pragma unroll
              for (int u = 0; u < CPT; ++u)
                acc[u][ky * K + kx] = fmaf(xv[u], gv[0][i][u], acc[u][ky * K + kx]);
            }
          }
        }
      }
    }
    lap(2);
  }
  __syncthreads();   // the last tile's reads are done before the sums overwrite it

  // the warps' sums meet in shared memory; each tap is summed over the warps
  // in index order
  float* red = reinterpret_cast<float*>(smem_raw);   // [kNW][K*K][CT]
#pragma unroll
  for (int j = 0; j < K * K; ++j)
#pragma unroll
    for (int u = 0; u < CPT; ++u) red[(warp * K * K + j) * CT + lane * CPT + u] = acc[u][j];
  __syncthreads();
  for (int idx = threadIdx.x; idx < K * K * CT; idx += kThreads) {
    const int j = idx / CT, cl = idx % CT;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kNW; ++i) s += red[(i * K * K + j) * CT + cl];
    if (c0 + cl < C) part[((size_t)blockIdx.y * K * K + j) * C + c0 + cl] = s;
  }
  lap(3);
  if (prof && threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) atomicAdd(reinterpret_cast<unsigned long long*>(prof) + i,
                                          (unsigned long long)clk[i]);
  }
}

__device__ __forceinline__ void load_chunk(const float* p, float (&f)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p, float (&f)[8]) {
  mma::unpack8(__ldg(reinterpret_cast<const uint4*>(p)), f);
}

// k = 1, no padding: dk[c] = sum over all pixels of x * g. x and g are
// [P, C]; thread (pr, cq) owns chunk cq of the channels and every PR-th
// pixel of its block's range.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dk_stream(const T* __restrict__ x, const T* __restrict__ g,
          float* __restrict__ part, long long P, int C, long long px_per_block) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float red[kThreads * V];
  const int CQ = C / V, PR = kThreads / CQ;
  const int tid = threadIdx.x;
  const int cq = tid % CQ, pr = tid / CQ;
  const long long p0 = blockIdx.x * px_per_block;
  const long long p1 = p0 + px_per_block < P ? p0 + px_per_block : P;
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
  if (pr < PR) {
#pragma unroll 4
    for (long long p = p0 + pr; p < p1; p += PR) {
      float xv[V], gv[V];
      load_chunk(x + p * C + cq * V, xv);
      load_chunk(g + p * C + cq * V, gv);
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = fmaf(xv[i], gv[i], acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) red[tid * V + i] = acc[i];   // [pr][C] for pr < PR
  __syncthreads();
  for (int c = tid; c < C; c += kThreads) {
    float s = 0.f;
    for (int i = 0; i < PR; ++i) s += red[i * C + c];
    part[(size_t)blockIdx.x * C + c] = s;
  }
}

// out[c][j] = sum over the splits of part[t][j][c]: 32 outputs a block, 8
// warps that each sum every 8th split in index order, then the 8 in order.
constexpr int kRedWarps = 8;

__global__ void __launch_bounds__(32 * kRedWarps)
dk_reduce(const float* __restrict__ part, float* __restrict__ out,
          int n_split, int kk, int C) {
  __shared__ float sm[kRedWarps][32];
  const int o = threadIdx.x & 31, l = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + o;                     // j * C + c
  float s = 0.f;
  if (i < kk * C) {
#pragma unroll 4
    for (int t = l; t < n_split; t += kRedWarps) s += part[(size_t)t * kk * C + i];
  }
  sm[l][o] = s;
  __syncthreads();
  if (l == 0 && i < kk * C) {
    float r = 0.f;
#pragma unroll
    for (int q = 0; q < kRedWarps; ++q) r += sm[q][o];
    const int j = i / C, c = i - j * C;
    out[(size_t)c * kk + j] = r;
  }
}

// Shared memory per block: the barriers and kStages staged x and g tiles, or
// the warps' sums at the end. A request over the card's limit fails in
// cudaFuncSetAttribute, and that error is returned to the caller.
size_t smem_bytes(int k, int dil, int th, int tw, size_t elem, int cpt) {
  const int halo = (k - 1) * dil;
  const size_t ct = 32 * cpt;
  const size_t stage = round128((size_t)(th + halo) * (tw + halo) * ct * elem) +
                       round128((size_t)th * tw * ct * elem);
  const size_t red = (size_t)kNW * k * k * ct * sizeof(float);
  return kBarBytes + kStages * stage > red ? kBarBytes + kStages * stage : red;
}

// The register run, in output columns ...
constexpr int kRun = 10;
// ... and the rows of an instantiation's band: 2 where the sums and two rows
// of g fit in the registers.
constexpr __host__ __device__ int rows_of(int k, int cpt, bool d1) {
  return d1 && k > 1 && k * k * cpt <= 50 ? 2 : 1;
}

struct Shape {
  int B, H, W, C, Ho, Wo, pad, dil, th, tw, n_split, vec;
  long long* prof;
};

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

// The map of a channels-last [B, H, W, C] tensor whose box is [1, bh, bw, ct].
template <typename T>
int tensor_map(CUtensorMap* map, const void* base, int B, int H, int W, int C, int bh,
               int bw, int ct) {
  EncodeFn encode = encoder();
  if (!encode || bh > 256 || bw > 256) return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * sizeof(T), (cuuint64_t)W * C * sizeof(T),
                                 (cuuint64_t)H * W * C * sizeof(T)};
  const cuuint32_t box[4] = {(cuuint32_t)ct, (cuuint32_t)bw, (cuuint32_t)bh, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      4, const_cast<void*>(base), dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int K, typename T, bool D1, int CPT>
int launch(const void* x, const void* g, float* part, const Shape& s,
           cudaStream_t stream) {
  constexpr int R = kRun, RT = rows_of(K, CPT, D1);
  if (s.tw % R) return (int)cudaErrorInvalidValue;
  const int halo = (K - 1) * s.dil;
  alignas(64) CUtensorMap mx, mg;
  memset(&mx, 0, sizeof mx);
  memset(&mg, 0, sizeof mg);
  if (s.vec) {
    int err = tensor_map<T>(&mx, x, s.B, s.H, s.W, s.C, s.th + halo, s.tw + halo, 32 * CPT);
    if (err == 0) err = tensor_map<T>(&mg, g, s.B, s.Ho, s.Wo, s.C, s.th, s.tw, 32 * CPT);
    if (err != 0) return err;
  }
  const size_t smem = smem_bytes(K, s.dil, s.th, s.tw, sizeof(T), CPT);
  // the attribute belongs to a device: raised once per device and size, not per launch
  constexpr int kDevices = 64;
  static std::atomic<size_t> allowed[kDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  const bool cached = dev >= 0 && dev < kDevices;
  if (smem > 48 * 1024 && !(cached && smem <= allowed[dev].load(std::memory_order_relaxed))) {
    cudaError_t err = cudaFuncSetAttribute(
        dk_tile<K, T, D1, CPT, R, RT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();               // returned here, not by the next launch's check
      return (int)err;
    }
    if (cached) allowed[dev].store(smem, std::memory_order_relaxed);
  }
  const int tiles_h = (s.Ho + s.th - 1) / s.th, tiles_w = (s.Wo + s.tw - 1) / s.tw;
  const dim3 grid((s.C + 32 * CPT - 1) / (32 * CPT), s.n_split);
  dk_tile<K, T, D1, CPT, R, RT><<<grid, kThreads, smem, stream>>>(
      mx, mg, static_cast<const T*>(x), static_cast<const T*>(g), part, s.H, s.W, s.C,
      s.Ho, s.Wo, s.pad, s.dil, s.th, s.tw, tiles_h, tiles_w,
      s.B * tiles_h * tiles_w, s.vec, s.prof);
  return (int)cudaGetLastError();
}

// Two channels a thread exist for dilation 1 and k = 3; k = 1 has no
// dilation to speak of.
template <int K, typename T>
int by_form(int cpt, const void* x, const void* g, float* part, const Shape& s,
            cudaStream_t stream) {
  if (cpt == 1) {
    if constexpr (K > 1) {
      if (s.dil != 1) return launch<K, T, false, 1>(x, g, part, s, stream);
    }
    return launch<K, T, true, 1>(x, g, part, s, stream);
  }
  if constexpr (K == 3) {
    if (cpt == 2 && s.dil == 1) return launch<K, T, true, 2>(x, g, part, s, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch(int k, int cpt, const void* x, const void* g, float* part,
             const Shape& s, cudaStream_t stream) {
  switch (k) {
    case 1: return by_form<1, T>(cpt, x, g, part, s, stream);
    case 3: return by_form<3, T>(cpt, x, g, part, s, stream);
    case 5: return by_form<5, T>(cpt, x, g, part, s, stream);
    case 7: return by_form<7, T>(cpt, x, g, part, s, stream);
    case 9: return by_form<9, T>(cpt, x, g, part, s, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int stream_launch(const void* x, const void* g, float* part, const Shape& s,
                  cudaStream_t stream) {
  const long long P = (long long)s.B * s.H * s.W;
  const long long per = (P + s.n_split - 1) / s.n_split;
  dk_stream<T><<<s.n_split, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), part, P, s.C, per);
  return (int)cudaGetLastError();
}

}  // namespace

// The shared memory the tile kernel asks for (the wrapper's planner mirrors it).
extern "C" int dw_grad_smem(int k, int dil, int th, int tw, int bf16, int cpt) {
  return (int)smem_bytes(k, dil, th, tw, bf16 ? 2 : 4, cpt);
}

// The second launch alone: out [C, kk] = the n_split partial sums part
// [n_split, kk, C] added in a fixed order.
extern "C" int dw_grad_reduce(const float* part, float* out, int n_split, int kk, int C,
                              void* stream) {
  const int n = kk * C;
  dk_reduce<<<(n + 31) / 32, 32 * kRedWarps, 0, (cudaStream_t)stream>>>(part, out, n_split,
                                                                        kk, C);
  return (int)cudaGetLastError();
}

// x, g channels-last [B,H,W,C] / [B,Ho,Wo,C]; bf16 != 0 means __nv_bfloat16
// elements, else float. part: f32 scratch [n_split, k*k, C]; out: f32
// [C, k*k]. streaming != 0 (k = 1, pad = 0, C a multiple of the 16-byte
// chunk and at most 256 chunks) takes dk_stream over n_split blocks; else
// dk_tile with th x tw output tiles, cpt (1 or 2) channels a thread, split
// over n_split blocks a group of 32 * cpt channels. Returns the cudaError_t
// of the launches. dw_grad_prof, the tuning tool's: the same, and the tile
// kernel adds warp 0's clocks to the 4 int64 counters at prof (issuing
// copies, waiting for them, multiplying, the epilogue).
extern "C" int dw_grad_prof(const void* x, const void* g, float* part, float* out,
                            int bf16, int B, int H, int W, int C, int Ho, int Wo,
                            int k, int pad, int dil, int streaming, int th, int tw,
                            int cpt, int n_split, void* stream, void* prof) {
  cudaStream_t st = (cudaStream_t)stream;
  const int chunk = bf16 ? 8 : 4;
  const bool vec = C % chunk == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)g % 16 == 0;
  const Shape s{B, H, W, C, Ho, Wo, pad, dil, th, tw, n_split, vec ? 1 : 0,
                static_cast<long long*>(prof)};
  if (n_split < 1 || th < 1 || tw < 1) return (int)cudaErrorInvalidValue;
  int err;
  if (streaming) {
    if (k != 1 || pad != 0 || !vec || C / chunk > kThreads) return (int)cudaErrorInvalidValue;
    err = bf16 ? stream_launch<__nv_bfloat16>(x, g, part, s, st)
               : stream_launch<float>(x, g, part, s, st);
  } else {
    err = bf16 ? dispatch<__nv_bfloat16>(k, cpt, x, g, part, s, st)
               : dispatch<float>(k, cpt, x, g, part, s, st);
  }
  if (err != 0) return err;
  return dw_grad_reduce(part, out, n_split, k * k, C, stream);
}

extern "C" int dw_grad(const void* x, const void* g, float* part, float* out,
                       int bf16, int B, int H, int W, int C, int Ho, int Wo,
                       int k, int pad, int dil, int streaming, int th, int tw,
                       int cpt, int n_split, void* stream) {
  return dw_grad_prof(x, g, part, out, bf16, B, H, W, C, Ho, Wo, k, pad, dil, streaming, th,
                      tw, cpt, n_split, stream, nullptr);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
