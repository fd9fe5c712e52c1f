// One level of the Farnebäck image pyramid, for Hopper (sm_90a): the
// Gaussian blur of a frame batch and its bilinear resize, fused.
//
// Replaces no Pallas kernel: the JAX package leaves the pyramid to XLA,
// which fuses the blur and the resize itself. The port built it from
// PyTorch ops (ops/image.py), about 46 launches an image at 256 px, each
// blur tap a full-resolution multiply or add, and the level at the end a
// gather of a few of those pixels; that took about half of the card's time
// in a Farnebäck window. Plain twin: funscript_flow_tpu_torch/ops/image.py
// resize_bilinear(gaussian_blur(x, ksize, sigma), lh, lw); wrapper:
// ops/cuda/pyramid.py.
//
// What it computes: for x [N,H,W] f32, the separable correlation with the
// k Gaussian taps (reflect-101 border), the vertical pass first, then the
// cv2.INTER_LINEAR resize to [N,lh,lw] through the twin's tables: output
// (oy, ox) lerps the blurred image at rows ry0/ry1[oy] and columns
// cx0/cx1[ox], first over the rows, then over the columns.
//
// What bounds it on this card: the frames are read once and the level
// written once, 4 B per source pixel and 4 B per level pixel (0.039 ms at
// 256 px, N=252, at the full-size level, 0.020-0.025 ms at the others).
// The resize reads the blurred image only at 2 rows and 2 columns per
// level pixel, so the blur is computed at those points and nowhere else,
// and no intermediate image goes to device memory. What limits it is the
// traffic from L2 (a source row is read by each output row whose taps
// reach it) and the instructions per level pixel.
//
// Design: one block of 32 x 8 threads per (image, th x tw output tile),
// tile sizes from the wrapper (8 output rows, about 256 source columns).
// The tap count rounds up to a template bucket (3, 5, 9, 19, 39, 79), so
// every tap loop unrolls and each tap is a constant operand of its
// multiply; where k fills its bucket and ry1 = ry0 + 1 (the default plan's
// 3, 9 and 19 taps, every row but the last) no tap is tested, else taps
// past k are skipped by a warp-uniform test.
// - Vertical pass from device memory: a warp takes one output row and CH
//   chunks of 32 adjacent source columns at a time (coalesced loads; the
//   tile's first column rounded down to a multiple of 32). Since ry1 is
//   ry0 or ry0 + 1, a lane loads the k + 1 rows both sums need once, all
//   CH * (k + 1) loads before the first sum, and forms both, written to
//   shared memory as two rows [2*th][sw].
// - One barrier, then per output pixel the horizontal sums at cx0 and cx1
//   (cx1 is cx0 or cx0 + 1, so k + 1 shared loads per row serve both) of
//   both rows, the row lerp and the column lerp, and one store.
// A staged variant (each tile's source rows copied once into shared
// memory with cp.async, then both passes from there) read less from L2
// but ran 1.4x slower on this card: its blocks wait on their copies with
// nothing to overlap.
// Any frame size is taken (the border index reflects as often as needed)
// and any tap count up to MAX_K, which covers every plan of up to 5 levels
// at a scale of 0.5 or more (79 taps at 1/32).
//
// Numerics: the twin's order throughout, built with --fmad=false: tap 0 a
// product, each later tap acc + x*t; the vertical pass first; then
// a*(1-wy) + b*wy with 1-wy rounded in float32, over the rows and then the
// columns (also at the identity level, as the twin does). Bitwise equal to
// the twin on the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_K = 79;
constexpr int TX = 32;  // block: 32 x 8 threads
constexpr int TY = 8;
constexpr int MAX_SMEM = 48 * 1024;

struct Taps {
  float t[MAX_K];
};

// Reflect-101 (cv2 BORDER_REFLECT_101, torch's "reflect") index of p in
// [0, n), bounced as often as needed.
__device__ __forceinline__ int reflect101(int p, int n) {
  if ((unsigned)p < (unsigned)n) return p;
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  p = abs(p) % period;
  return p < n ? p : period - p;
}

// Both vertical sums of CH columns (col[], the last clamped, its sums
// unused): rows top + t (v0) and top + d + t (v1), t < k, d in {0, 1};
// REFLECT when a row lies outside [0, H); EXACT when k == KB and d == 1.
// Every load goes out before the first sum.
template <int KB, int CH, bool REFLECT, bool EXACT>
__device__ __forceinline__ void vertical(const float* __restrict__ img,
                                         const int (&col)[CH], int top, int d,
                                         int k, int H, int W, const Taps& taps,
                                         float (&v0)[CH], float (&v1)[CH]) {
  float x[CH][KB + 1];
#pragma unroll
  for (int t = 0; t <= KB; ++t) {
    if (EXACT || t < k + d) {
      const int y = REFLECT ? reflect101(top + t, H) : top + t;
      const float* rowp = img + (size_t)y * W;
#pragma unroll
      for (int c = 0; c < CH; ++c) x[c][t] = __ldg(rowp + col[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int t = 0; t < KB; ++t) {
      if (EXACT || t < k) {
        const float tap = taps.t[t];
        a = t == 0 ? x[c][t] * tap : a + x[c][t] * tap;
        if (EXACT || d) b = t == 0 ? x[c][t + 1] * tap : b + x[c][t + 1] * tap;
      }
    }
    v0[c] = a;
    v1[c] = EXACT || d ? b : a;
  }
}

// Both horizontal sums of one shared row at columns 0 (h0) and d (h1);
// EXACT as above.
template <int KB, bool EXACT>
__device__ __forceinline__ void horizontal(const float* __restrict__ row,
                                           int d, int k, const Taps& taps,
                                           float& h0, float& h1) {
  float x[KB + 1];
#pragma unroll
  for (int t = 0; t <= KB; ++t)
    if (EXACT || t < k + d) x[t] = row[t];
  float a = 0.f, b = 0.f;
#pragma unroll
  for (int t = 0; t < KB; ++t) {
    if (EXACT || t < k) {
      const float tap = taps.t[t];
      a = t == 0 ? x[t] * tap : a + x[t] * tap;
      if (EXACT || d) b = t == 0 ? x[t + 1] * tap : b + x[t + 1] * tap;
    }
  }
  h0 = a;
  h1 = EXACT || d ? b : a;
}

// idx: ry0[lh], ry1[lh], cx0[lw], cx1[lw]; wts: wy[lh], wx[lw].
template <int KB>
__global__ void __launch_bounds__(TX * TY) pyramid_level_kernel(
    const float* __restrict__ src, float* __restrict__ out,
    const int* __restrict__ idx, const float* __restrict__ wts, int H, int W,
    int lh, int lw, int k, int th, int tw, int sw, Taps taps) {
  // column chunks a lane sums at once: more loads in flight where the
  // registers allow
  constexpr int CH = KB <= 9 ? 4 : KB <= 19 ? 2 : 1;
  extern __shared__ float vsum[];  // [2*th][sw]: rows ry0, ry1 of each oy
  const int* ry0 = idx;
  const int* ry1 = idx + lh;
  const int* cx0 = idx + 2 * lh;
  const int* cx1 = cx0 + lw;
  const float* wy = wts;
  const float* wx = wts + lh;
  const int r = k >> 1;
  const int oy0 = blockIdx.y * th, ox0 = blockIdx.x * tw;
  const int nrow = min(th, lh - oy0), ncol = min(tw, lw - ox0);
  const int c_lo = (cx0[ox0] - r) & ~31;                // floor to 32
  const int ncs = cx1[ox0 + ncol - 1] + r - c_lo + 1;  // <= sw
  const int tx = threadIdx.x, ty = threadIdx.y;
  const float* img = src + (size_t)blockIdx.z * H * W;

  for (int i = ty; i < nrow; i += TY) {
    const int row = ry0[oy0 + i];
    const int d = ry1[oy0 + i] - row;
    const int top = row - r;
    const bool inside = top >= 0 && top + k + d <= H;
    const bool exact = k == KB && d == 1;
    float* v0 = vsum + 2 * i * sw;
    float* v1 = v0 + sw;
    for (int j0 = tx; j0 < ncs; j0 += TX * CH) {
      int col[CH];
      float a[CH], b[CH];
#pragma unroll
      for (int c = 0; c < CH; ++c)
        col[c] = reflect101(c_lo + min(j0 + c * TX, ncs - 1), W);
      if (inside && exact)
        vertical<KB, CH, false, true>(img, col, top, d, k, H, W, taps, a, b);
      else if (inside)
        vertical<KB, CH, false, false>(img, col, top, d, k, H, W, taps, a, b);
      else
        vertical<KB, CH, true, false>(img, col, top, d, k, H, W, taps, a, b);
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        if (j0 + c * TX < ncs) {
          v0[j0 + c * TX] = a[c];
          v1[j0 + c * TX] = b[c];
        }
      }
    }
  }
  __syncthreads();

  for (int i = ty; i < nrow; i += TY) {
    const int oy = oy0 + i;
    const float wy1 = wy[oy];
    const float wy0 = 1.f - wy1;
    const float* v0 = vsum + 2 * i * sw;
    const float* v1 = v0 + sw;
    float* orow = out + ((size_t)blockIdx.z * lh + oy) * lw;
    for (int c = tx; c < ncol; c += TX) {
      const int ox = ox0 + c;
      const int a = cx0[ox] - r - c_lo;
      const int d = cx1[ox] - cx0[ox];
      float h00, h01, h10, h11;  // h<row><column>
      if (k == KB && d == 1) {
        horizontal<KB, true>(v0 + a, d, k, taps, h00, h01);
        horizontal<KB, true>(v1 + a, d, k, taps, h10, h11);
      } else {
        horizontal<KB, false>(v0 + a, d, k, taps, h00, h01);
        horizontal<KB, false>(v1 + a, d, k, taps, h10, h11);
      }
      const float p0 = h00 * wy0 + h10 * wy1;  // at column cx0
      const float p1 = h01 * wy0 + h11 * wy1;  // at column cx1
      const float wx1 = wx[ox];
      orow[ox] = p0 * (1.f - wx1) + p1 * wx1;
    }
  }
}

template <int KB>
int launch(const float* src, float* out, const int* idx, const float* wts,
           int N, int H, int W, int lh, int lw, int k, int th, int tw, int sw,
           const Taps& taps, cudaStream_t stream) {
  const dim3 grid((lw + tw - 1) / tw, (lh + th - 1) / th, N);
  const size_t smem = (size_t)2 * th * sw * sizeof(float);
  pyramid_level_kernel<KB><<<grid, dim3(TX, TY), smem, stream>>>(
      src, out, idx, wts, H, W, lh, lw, k, th, tw, sw, taps);
  return (int)cudaGetLastError();
}

using LaunchFn = int (*)(const float*, float*, const int*, const float*, int,
                         int, int, int, int, int, int, int, int, const Taps&,
                         cudaStream_t);
// tap-count buckets: the smallest that holds k
constexpr int kBuckets[] = {3, 5, 9, 19, 39, MAX_K};
const LaunchFn kLaunch[] = {launch<3>,  launch<5>,  launch<9>,
                            launch<19>, launch<39>, launch<MAX_K>};

}  // namespace

// src [N,H,W], out [N,lh,lw] f32 on the device; idx (int32) and wts (f32)
// the resize tables on the device (see the kernel); k odd, <= MAX_K, and
// its taps on the host; th x tw the output tile, sw the row stride of the
// vertical sums (at least every tile's column span). Returns the launch's
// cudaError_t.
extern "C" int ff_pyramid_level(const float* src, float* out, const int* idx,
                                const float* wts, int N, int H, int W, int lh,
                                int lw, int k, const float* taps, int th,
                                int tw, int sw, void* stream) {
  if (N < 1 || N > 65535 || H < 1 || W < 1 || lh < 1 || lw < 1 ||
      (long long)H * W > 0x7fffffff || (long long)lh * lw > 0x7fffffff ||
      k < 1 || k % 2 == 0 || k > MAX_K || th < 1 || th > 65535 || tw < 1 ||
      sw < 1 || (long long)2 * th * sw * sizeof(float) > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  Taps tp;
  for (int i = 0; i < MAX_K; ++i) tp.t[i] = i < k ? taps[i] : 0.f;
  int b = 0;
  while (kBuckets[b] < k) ++b;
  return kLaunch[b](src, out, idx, wts, N, H, W, lh, lw, k, th, tw, sw, tp,
                    (cudaStream_t)stream);
}
