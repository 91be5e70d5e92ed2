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
// One entry point, a short chain of launches on the caller's stream:
//   * pw_kernel: a 1x1 conv + bias + SiLU as a tiled f32 GEMM over pixels,
//     reading up to three sources, each with its own block of weight rows.
//     So neither Concat (rows 19 and 21) is materialised: cv_in sums one
//     partial product per source. The CSP parts of a layer live in one
//     buffer [P, (2+depth)c_], each written into its slot by its producer
//     (cv_in writes a and b, each project its y_i), so the expands read
//     their part in place and cv_out reads all parts as one source.
//   * dw5_kernel: the biased 5x5 depthwise conv + SiLU on the whole expand
//     output. That output exists only inside the image, so the taps outside
//     it read zeros: the conv's zero padding, whatever the biases (the halo
//     leak that neck_pallas.py:233 guards with its inimg mask).
//
// Bound on the H100: the FMA rate. At S bs32 @ 640 (h = 80) the 1x1 convs
// are about 107 GFMA, while every intermediate together is under 1 GB of
// traffic. This first version computes them on the CUDA cores in f32
// (64x64 pixel-by-channel tiles, 4x4 outputs a thread, operands staged in
// shared memory); tensor cores are the next step. Intermediates are stored
// in the input type, accumulation is always f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
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

template <typename T>
int pw(const Pw& a, cudaStream_t stream) {
  const dim3 grid((unsigned)((a.p + kBM - 1) / kBM), (unsigned)((a.n + kBN - 1) / kBN));
  pw_kernel<T><<<grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dw5(const T* x, const float* w, const float* b, T* y, int B, int H, int W,
        int C, cudaStream_t stream) {
  const long long total = (long long)B * H * W * C;
  dw5_kernel<T><<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      x, w, b, y, B, H, W, C);
  return (int)cudaGetLastError();
}

long long layer_len(int cin, int c_, int mid, int depth, int cout) {
  return (long long)cin * 2 * c_ + 2 * c_ +
         (long long)depth * ((long long)c_ * mid + mid + 25 * mid + mid + (long long)mid * c_ + c_) +
         (long long)(2 + depth) * c_ * cout + cout;
}

// One deploy RepHDW from `nin` sources to `out` (stride cout); `w` walks the
// packed weights. csp [P, (2+depth)c_], t and t2 [P, mid] are scratch.
template <typename T>
int rephdw(const Src* ins, int nin, const float*& w, int B, int H, int W,
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
  int err = pw<T>(a, stream);
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
    err = pw<T>(e, stream);
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
    if (!err) err = pw<T>(pr, stream);
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
  if (!err) err = pw<T>(o, stream);
  return err;
}

template <typename T>
int run(const void* x18, const void* x4, const void* x17u, const float* w,
        void* y20, void* y22, void* csp20, void* csp22, void* t, void* t2,
        int B, int H, int W, int c18, int c4, int c17, int c20, int c22, int d1,
        int d2, int c1_, int mid1, int c2_, int mid2, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || c18 <= 0 || c4 <= 0 || c17 <= 0 || c20 <= 0 ||
      c22 <= 0 || d1 < 0 || d2 < 0 || c1_ <= 0 || mid1 <= 0 || c2_ <= 0 || mid2 <= 0)
    return (int)cudaErrorInvalidValue;
  const Src in20[3] = {{x18, c18, c18, nullptr}, {x4, c4, c4, nullptr},
                       {x17u, c17, c17, nullptr}};
  int err = rephdw<T>(in20, 3, w, B, H, W, c1_, mid1, d1, c20, (T*)csp20, (T*)t,
                      (T*)t2, (T*)y20, stream);
  if (err) return err;
  const Src in22[2] = {{y20, c20, c20, nullptr}, {x17u, c17, c17, nullptr}};
  return rephdw<T>(in22, 2, w, B, H, W, c2_, mid2, d2, c22, (T*)csp22, (T*)t,
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
// t and t2 [B*H*W, max(mid1, mid2)], all in the one element type. Returns
// the cudaError_t of the first launch that failed, else 0.
#define NECK80_ENTRY(NAME, T)                                                          \
  extern "C" int NAME(const void* x18, const void* x4, const void* x17u,               \
                      const float* w, void* y20, void* y22, void* csp20, void* csp22,  \
                      void* t, void* t2, int B, int H, int W, int c18, int c4,         \
                      int c17, int c20, int c22, int d1, int d2, int c1_, int mid1,    \
                      int c2_, int mid2, void* stream) {                               \
    return run<T>(x18, x4, x17u, w, y20, y22, csp20, csp22, t, t2, B, H, W, c18, c4,   \
                  c17, c20, c22, d1, d2, c1_, mid1, c2_, mid2, (cudaStream_t)stream);  \
  }

NECK80_ENTRY(neck80_f32, float)
NECK80_ENTRY(neck80_bf16, __nv_bfloat16)

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
