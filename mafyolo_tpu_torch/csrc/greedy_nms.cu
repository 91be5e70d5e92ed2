// Greedy NMS keep mask: a suppression bit matrix built by the whole card,
// then one warp an image that walks it 64 boxes at a time.
//
// Replaces: mafyolo_tpu/ops/pallas_nms.py:pallas_greedy_nms (_nms_kernel),
// and in the main path the XLA fixpoint mafyolo_tpu/ops/nms.py:_greedy_nms_mask
// that _blocked_greedy_select runs.
//
// Computes: boxes f32 [B, M, 4] (xyxy, score-descending, class offset
// applied) and valid u8 [B, M] -> keep u8 [B, M]. Walking i in score order,
// a kept box i suppresses every j > i with IoU(i, j) > thr, where
// IoU = inter / (((area_i + area_j) - inter) + 1e-7) and area = clip(w,0) *
// clip(h,0): the operation order of ops/boxes.py:box_iou_pairwise, in
// round-to-nearest intrinsics, and this file is built with -fmad=false, so
// the keep set equals the plain version's exactly.
//
// Bound on the H100: latency, not bytes or operations. The greedy walk is a
// chain of M dependent decisions; everything else (M^2/2 IoUs with a
// division each, 16 M bytes) is parallel. A walk that pays a block barrier
// and a division's latency per kept box takes about 0.5 us a box. The design
// takes every IoU out of the chain:
//   phase A (nms_bitmatrix): 64 x 64 tiles of (i, j), one block each over
//     the upper triangle of every image, 64 threads a block, the tile's
//     column boxes in shared memory. Thread t owns row i and writes one
//     64-bit word: bit j set when j > i and IoU(i, j) > thr; the division is
//     made only for the pairs within 1e-5 of the threshold. The matrix is
//     stored word-major, sup[b][word][i], so that these writes and phase B's
//     reads are both contiguous over i. All SMs work and the divisions
//     overlap.
//   phase B (nms_scan): one warp an image, no block barrier. For chunk c of
//     64 boxes it first ORs word c of every earlier kept row (lanes stride
//     over the rows, loads independent of the chain, one warp OR-reduce),
//     adds the invalid boxes, and then resolves the chunk in registers: 64
//     unrolled steps of "if bit t is clear, OR in row t's diagonal word",
//     the diagonal words held two a lane and broadcast by shuffle. The
//     dependent chain is a bit test and a predicated OR per box (about a
//     dozen clocks), and a chunk costs one L2 round trip.
// Two launches on one stream; the scratch matrix (M * ceil(M/64) * 8 bytes an
// image: 32 KB at M = 512, 500 KB at M = 2000) comes from the wrapper and
// stays in L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;
constexpr unsigned kFull = 0xffffffffu;

// sup: [B][nw][mp] words, mp = nw * 64. Grid (nw (nw + 1) / 2, B): the
// tiles of the upper triangle, row by row.
__global__ void __launch_bounds__(kTile)
nms_bitmatrix_kernel(const float* __restrict__ boxes,
                     unsigned long long* __restrict__ sup, int m, int nw,
                     float thr) {
  int r = 0, c = blockIdx.x;
  while (c >= nw - r) { c -= nw - r; ++r; }
  c += r;
  const int b = blockIdx.y;
  __shared__ float sx1[kTile], sy1[kTile], sx2[kTile], sy2[kTile], sar[kTile];
  const int t = threadIdx.x;
  const float4* bx = reinterpret_cast<const float4*>(boxes) + (size_t)b * m;
  const int j0 = c * kTile, i = r * kTile + t;
  {
    const int j = j0 + t;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j < m) v = bx[j];
    sx1[t] = v.x; sy1[t] = v.y; sx2[t] = v.z; sy2[t] = v.w;
    sar[t] = __fmul_rn(fmaxf(__fsub_rn(v.z, v.x), 0.f), fmaxf(__fsub_rn(v.w, v.y), 0.f));
  }
  __syncthreads();
  unsigned long long word = 0ull;
  if (i < m) {
    const float4 a = bx[i];
    const float ai = __fmul_rn(fmaxf(__fsub_rn(a.z, a.x), 0.f), fmaxf(__fsub_rn(a.w, a.y), 0.f));
    // inter / denom > thr is decided without the division wherever inter is
    // further than 1e-5 (relative) from thr * denom: the quotient's and the
    // product's roundings move either side by at most 2^-23. Below 1e-6 thr
    // * denom loses its relative precision, and every pair is divided.
    const bool fast = thr > 1e-6f;
    unsigned long long hits = 0ull, unsure = 0ull;
#pragma unroll
    for (int jj = 0; jj < kTile; ++jj) {       // straight-line: 64 independent chains
      const float w = fmaxf(__fsub_rn(fminf(a.z, sx2[jj]), fmaxf(a.x, sx1[jj])), 0.f);
      const float h = fmaxf(__fsub_rn(fminf(a.w, sy2[jj]), fmaxf(a.y, sy1[jj])), 0.f);
      const float inter = __fmul_rn(w, h);
      const float denom = __fadd_rn(__fsub_rn(__fadd_rn(ai, sar[jj]), inter), 1e-7f);
      const float cut = __fmul_rn(thr, denom);
      const bool hit = fast && inter > __fmul_rn(cut, 1.00001f);
      const bool miss = fast && inter < __fmul_rn(cut, 0.99999f);
      if (hit) hits |= 1ull << jj;
      if (!hit && !miss) unsure |= 1ull << jj;
    }
    while (unsure) {                            // rare: the pairs near the threshold
      const int jj = __ffsll((long long)unsure) - 1;
      unsure &= unsure - 1;
      const float w = fmaxf(__fsub_rn(fminf(a.z, sx2[jj]), fmaxf(a.x, sx1[jj])), 0.f);
      const float h = fmaxf(__fsub_rn(fminf(a.w, sy2[jj]), fmaxf(a.y, sy1[jj])), 0.f);
      const float inter = __fmul_rn(w, h);
      const float denom = __fadd_rn(__fsub_rn(__fadd_rn(ai, sar[jj]), inter), 1e-7f);
      if (__fdiv_rn(inter, denom) > thr) hits |= 1ull << jj;
    }
    // keep the bits j > i of real boxes
    const int n = m - j0;
    const unsigned long long real = n >= kTile ? ~0ull : (1ull << n) - 1ull;
    const unsigned long long later = c > r ? ~0ull : (t == kTile - 1 ? 0ull : ~0ull << (t + 1));
    word = hits & real & later;
  }
  sup[((size_t)b * nw + c) * ((size_t)nw * kTile) + i] = word;
}

__device__ __forceinline__ unsigned long long shfl64(unsigned long long v, int src) {
  const unsigned lo = __shfl_sync(kFull, (unsigned)v, src);
  const unsigned hi = __shfl_sync(kFull, (unsigned)(v >> 32), src);
  return ((unsigned long long)hi << 32) | lo;
}

// One warp an image. Shared: keepw[nw] words of the chunks resolved so far.
__global__ void __launch_bounds__(32)
nms_scan_kernel(const unsigned long long* __restrict__ sup,
                const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep,
                int m, int nw) {
  extern __shared__ unsigned long long keepw[];
  const int b = blockIdx.x, lane = threadIdx.x;
  const size_t mp = (size_t)nw * kTile;
  const unsigned long long* mat = sup + (size_t)b * nw * mp;
  const uint8_t* vb = valid + (size_t)b * m;
  uint8_t* kb = keep + (size_t)b * m;

  for (int c = 0; c < nw; ++c) {
    const unsigned long long* col = mat + (size_t)c * mp;
    const int i0 = c * kTile;
    // the chunk's diagonal words and validity: loads that do not wait on the chain
    const unsigned long long d0 = col[i0 + lane];
    const unsigned long long d1 = col[i0 + 32 + lane];
    const bool v0 = i0 + lane < m && vb[i0 + lane] != 0;
    const bool v1 = i0 + 32 + lane < m && vb[i0 + 32 + lane] != 0;
    // word c of every earlier kept row
    unsigned long long acc = 0ull;
#pragma unroll 8
    for (int i = lane; i < i0; i += 32) {
      const unsigned long long w = col[i];
      if ((keepw[i >> 6] >> (i & 63)) & 1ull) acc |= w;
    }
    const unsigned lo = __reduce_or_sync(kFull, (unsigned)acc);
    const unsigned hi = __reduce_or_sync(kFull, (unsigned)(acc >> 32));
    const unsigned inv_lo = ~__ballot_sync(kFull, v0);
    const unsigned inv_hi = ~__ballot_sync(kFull, v1);
    unsigned long long rem = (((unsigned long long)(hi | inv_hi)) << 32) | (lo | inv_lo);
    // resolve the chunk: row t's word holds only bits above t, so bit t of
    // rem is final when step t reads it
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      const unsigned long long d = shfl64(d0, t);
      if (!((rem >> t) & 1ull)) rem |= d;
    }
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      const unsigned long long d = shfl64(d1, t);
      if (!((rem >> (t + 32)) & 1ull)) rem |= d;
    }
    const unsigned long long kept = ~rem;
    if (lane == 0) keepw[c] = kept;
    if (i0 + lane < m) kb[i0 + lane] = (uint8_t)((kept >> lane) & 1ull);
    if (i0 + 32 + lane < m) kb[i0 + 32 + lane] = (uint8_t)((kept >> (lane + 32)) & 1ull);
    __syncwarp();
  }
}

}  // namespace

// Phase A alone: sup is u64 scratch [batch, nw, nw * 64], nw = ceil(m / 64).
extern "C" int nms_bitmatrix(const float* boxes, void* sup, int batch, int m,
                             float thr, void* stream) {
  const int nw = (m + kTile - 1) / kTile;
  nms_bitmatrix_kernel<<<dim3(nw * (nw + 1) / 2, batch), kTile, 0, (cudaStream_t)stream>>>(
      boxes, static_cast<unsigned long long*>(sup), m, nw, thr);
  return (int)cudaGetLastError();
}

// Phase B alone, on a matrix that nms_bitmatrix wrote.
extern "C" int nms_scan(const void* sup, const uint8_t* valid, uint8_t* keep,
                        int batch, int m, void* stream) {
  const int nw = (m + kTile - 1) / kTile;
  nms_scan_kernel<<<batch, 32, nw * sizeof(unsigned long long), (cudaStream_t)stream>>>(
      static_cast<const unsigned long long*>(sup), valid, keep, m, nw);
  return (int)cudaGetLastError();
}

extern "C" int greedy_nms(const float* boxes, const uint8_t* valid, void* sup,
                          uint8_t* keep, int batch, int m, float thr,
                          void* stream) {
  const int err = nms_bitmatrix(boxes, sup, batch, m, thr, stream);
  if (err != 0) return err;
  return nms_scan(sup, valid, keep, batch, m, stream);
}

extern "C" const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
