// Bilinear samplers for Hopper (sm_90a): the relative warp of K2 (Farnebäck
// R1 planes) and K5 (DIS refinement planes), and the absolute sampler of K4
// (DIS patches, below).
//
// Replaces: funscript_flow_tpu/ops/pallas/warp.py warp_bilinear_pallas on the
// Farnebäck path. Plain twin: funscript_flow_tpu_torch/ops/farneback.py
// warp_bilinear; wrapper: ops/cuda/warp.py.
//
// What it computes: out[b,p,y,x] = bilinear sample of R[b,p] at
// (x + u[b,y,x], y + v[b,y,x]), with the four corners clamped one by one:
// x0c = clamp(floor(fx), 0, W-1), x1c = min(x0c + 1, W-1), likewise in y.
// The caller masks out-of-bounds pixels and forms the constraint matrices.
//
// What bounds it on this card: memory. It must read u, v (8 B) and the P
// planes (4P B) and write P planes (4P B) per pixel, 48 B at P=5. A direct
// gather costs more than those bytes: each of a pixel's 4P corner loads is
// an L1 request of its own, and where displacements spread over many rows
// a warp's loads touch many more sectors than it uses.
//
// Design: one block of 256 threads per (image, 32 x 32 output tile); a
// warp covers 32 adjacent columns of a row, and each thread 4 rows, 8
// apart. blockIdx.z = b and offsets inside a plane are 32-bit: no 64-bit
// division. A pixel's displacement, weights and corner offsets are
// computed once and serve all P planes; P is a template parameter (5 for
// K2, 3 for K5) so the plane loop unrolls.
// - The block reduces its pixels' clamped corners to their source bounding
//   box. When one plane's box fits the staging buffer (BOX_MAX floats), as
//   it does on every tile of the smooth flow of a real window, each plane's
//   box is copied into shared memory with cp.async (16-byte copies where
//   rows are whole float4s), double-buffered so that plane p+1 is in flight
//   while plane p is gathered. A warp's corner reads then fall on adjacent
//   columns of one or two rows: adjacent banks, no conflicts.
// - Otherwise (displacements spread too widely) the block gathers from
//   device memory directly. Both branches do the same arithmetic in the
//   same order on the same values.
// - WMIN_BLOCKS caps the registers so that four blocks (32 warps) share an
//   SM and one block's copies and barriers overlap the others' gathers.
//
// Numerics: the same expression order as the plain twin, built with
// --fmad=false, so each product and sum is rounded as there (bitwise equal
// on the card).

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WT = 32;           // output tile width: a warp's columns
constexpr int HT = 32;           // output tile height
constexpr int ROWS = 4;          // rows per thread, WT * HT / WTHREADS
constexpr int WTHREADS = 256;
constexpr int WMIN_BLOCKS = 4;   // resident blocks per SM: <= 64 registers
constexpr int WWARPS = WTHREADS / 32;
constexpr int BOX_MAX = 5120;    // floats of one staged plane (20 KB)

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy rows [by, by + bh) x columns [bx, bx + bw) of a plane (row stride W)
// into dst (row stride bw); with vec, bx and bw are multiples of 4 and the
// plane is 16-byte aligned.
__device__ __forceinline__ void stage_box(float* dst, const float* plane,
                                          int W, int by, int bh, int bx,
                                          int bw, bool vec) {
  const int tid = threadIdx.y * 32 + threadIdx.x;
  if (vec) {
    const int n4 = bw >> 2;
    for (int i = tid; i < bh * n4; i += WTHREADS) {
      const int r = i / n4, c = (i - r * n4) << 2;
      cp_async16(dst + r * bw + c, plane + (by + r) * W + bx + c);
    }
  } else {
    for (int i = tid; i < bh * bw; i += WTHREADS) {
      const int r = i / bw, c = i - r * bw;
      cp_async4(dst + r * bw + c, plane + (by + r) * W + bx + c);
    }
  }
}

// PC > 0: P = PC planes, known at compile time; PC == 0: P = Prt.
template <int PC>
__global__ void __launch_bounds__(WTHREADS, WMIN_BLOCKS)
warp_bilinear_kernel(const float* __restrict__ R, const float* __restrict__ u,
                     const float* __restrict__ v, float* __restrict__ out,
                     int Prt, int H, int W, int vec) {
  __shared__ __align__(16) float s_box[2][BOX_MAX];
  __shared__ int s_red[4][WWARPS];
  const int P = PC > 0 ? PC : Prt;
  const int plane = H * W;
  const int x = blockIdx.x * WT + threadIdx.x;
  const int y0 = blockIdx.y * HT + threadIdx.y;
  const size_t bplane = (size_t)blockIdx.z * plane;
  const float* src = R + bplane * P;
  float* dst = out + bplane * P;

  // per pixel: weights, clamped top-left corner, +1 column/row present
  bool ok[ROWS];
  float wx[ROWS], wy[ROWS];
  int x0c[ROWS], y0c[ROWS], dx[ROWS], dyr[ROWS];
  int bx0 = INT_MAX, bx1 = -1, by0 = INT_MAX, by1 = -1;
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int y = y0 + k * (HT / ROWS);
    ok[k] = x < W && y < H;
    const int o = ok[k] ? y * W + x : 0;
    const float fx = (float)x + u[bplane + o];
    const float fy = (float)y + v[bplane + o];
    const float xf = floorf(fx);
    const float yf = floorf(fy);
    wx[k] = fx - xf;
    wy[k] = fy - yf;
    // clamp in float, then convert: equal to clip(int(floor)) for any
    // finite coordinate and safe for ones beyond the int range
    x0c[k] = (int)fminf(fmaxf(xf, 0.f), (float)(W - 1));
    y0c[k] = (int)fminf(fmaxf(yf, 0.f), (float)(H - 1));
    dx[k] = x0c[k] + 1 < W ? 1 : 0;
    dyr[k] = y0c[k] + 1 < H ? 1 : 0;
    if (ok[k]) {
      bx0 = min(bx0, x0c[k]);
      bx1 = max(bx1, x0c[k] + dx[k]);
      by0 = min(by0, y0c[k]);
      by1 = max(by1, y0c[k] + dyr[k]);
    }
  }

  // the block's source box (thread (0, 0)'s first pixel is always in it)
  bx0 = __reduce_min_sync(0xffffffffu, bx0);
  by0 = __reduce_min_sync(0xffffffffu, by0);
  bx1 = __reduce_max_sync(0xffffffffu, bx1);
  by1 = __reduce_max_sync(0xffffffffu, by1);
  if (threadIdx.x == 0) {
    s_red[0][threadIdx.y] = bx0;
    s_red[1][threadIdx.y] = by0;
    s_red[2][threadIdx.y] = bx1;
    s_red[3][threadIdx.y] = by1;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < WWARPS; ++w) {
    bx0 = min(bx0, s_red[0][w]);
    by0 = min(by0, s_red[1][w]);
    bx1 = max(bx1, s_red[2][w]);
    by1 = max(by1, s_red[3][w]);
  }
  if (vec) bx0 &= ~3;  // 16-byte copies start on a float4
  const int bw = vec ? (bx1 - bx0 + 4) & ~3 : bx1 - bx0 + 1;
  const int bh = by1 - by0 + 1;
  const bool staged = bw * bh <= BOX_MAX;

  // corner offsets in the source: top-left, + dx[k] column, + dy[k] row
  int off[ROWS], dy[ROWS];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    off[k] = staged ? (y0c[k] - by0) * bw + (x0c[k] - bx0)
                    : y0c[k] * W + x0c[k];
    dy[k] = dyr[k] * (staged ? bw : W);
  }

  auto sample = [&](const float* s, float* d) {
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      if (!ok[k]) continue;
      const float* c = s + off[k];
      const float omx = 1.f - wx[k], omy = 1.f - wy[k];
      const float top = c[0] * omx + c[dx[k]] * wx[k];
      const float bot = c[dy[k]] * omx + c[dy[k] + dx[k]] * wx[k];
      d[(y0 + k * (HT / ROWS)) * W + x] = top * omy + bot * wy[k];
    }
  };

  if (staged) {
    stage_box(s_box[0], src, W, by0, bh, bx0, bw, vec);
    cp_async_commit();
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (p + 1 < P) {
        stage_box(s_box[(p + 1) & 1], src + (p + 1) * plane, W, by0, bh,
                  bx0, bw, vec);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      sample(s_box[p & 1], dst + p * plane);
      __syncthreads();  // s_box[p & 1] is refilled with plane p + 2
    }
  } else {
#pragma unroll
    for (int p = 0; p < P; ++p) sample(src + p * plane, dst + p * plane);
  }
}

template <int PC>
int launch_warp(const float* R, const float* u, const float* v, float* out,
                int B, int P, int H, int W, cudaStream_t stream) {
  // 16-byte staging copies: rows of whole float4s on a 16-byte base
  const int vec = W % 4 == 0 && (uintptr_t)R % 16 == 0;
  const dim3 block(32, WTHREADS / 32);
  const size_t plane = (size_t)H * W;
  for (int b0 = 0; b0 < B; b0 += 65535) {
    const int nb = B - b0 < 65535 ? B - b0 : 65535;
    const dim3 grid((W + WT - 1) / WT, (H + HT - 1) / HT, nb);
    warp_bilinear_kernel<PC><<<grid, block, 0, stream>>>(
        R + (size_t)b0 * P * plane, u + b0 * plane, v + b0 * plane,
        out + (size_t)b0 * P * plane, P, H, W, vec);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

// R [B,P,H,W], u/v [B,H,W], out [B,P,H,W], all f32 on the device.
// Returns the launch's cudaError_t. Serves two entry points: K2
// (warp_bilinear, P=5 Farnebäck planes) and K5 (warp_planes, P=3 DIS
// planes I1, I1x, I1y; replaces warp_planes_padded in
// funscript_flow_tpu/ops/pallas/warp.py, whose W padding to 128 lanes
// existed only for Mosaic). Any other P takes the same kernel with the
// plane count at run time.
extern "C" int ff_warp_bilinear(const float* R, const float* u, const float* v,
                                float* out, int B, int P, int H, int W,
                                void* stream) {
  if (B < 1 || P < 1 || H < 1 || W < 1 ||
      (long long)P * H * W > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (P == 5) return launch_warp<5>(R, u, v, out, B, P, H, W, st);
  if (P == 3) return launch_warp<3>(R, u, v, out, B, P, H, W, st);
  return launch_warp<0>(R, u, v, out, B, P, H, W, st);
}

// K4: bilinear sample of one plane at absolute coordinates, the DIS dense
// patch sampler's fetch (every descent step of every pyramid level).
//
// Replaces: funscript_flow_tpu/ops/pallas/warp.py sample_abs_pallas. Plain
// twin: funscript_flow_tpu_torch/models/dis.py bilinear_abs (the
// counterpart of _bilinear_abs_packed); wrapper: ops/cuda/warp.py.
//
// What it computes: out[b,i,j] = bilinear sample of img[b] (h x w) at
// (fy[b,i,j], fx[b,i,j]), coordinates pre-clamped by the caller to
// [0, h-1] x [0, w-1]; y0 = clamp(floor(fy), 0, h-1), the +1 neighbour
// edge-replicated, likewise in x. The output grid (Ho x Wo) is independent
// of the source shape.
//
// What bounds it: memory. Per output pixel it reads two coordinates (8 B)
// and writes one value (4 B); the source plane (4-64 KB at the DIS levels)
// is read once from device memory and then served from L1/L2, since
// neighbouring outputs of a patch sample neighbouring source pixels.
// Design: one thread per output pixel on the plain source plane. The TPU
// kernel's lane padding, its (8, 128) output alignment and its
// coord - iota round trip through the relative band warp existed only for
// Mosaic and are gone.
//
// Numerics: the twin's expression order, built with --fmad=false.
__global__ void __launch_bounds__(256)
sample_abs_kernel(const float* __restrict__ img, const float* __restrict__ fy,
                  const float* __restrict__ fx, float* __restrict__ out,
                  int B, int h, int w, int Ho, int Wo) {
  const size_t plane_out = (size_t)Ho * Wo;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * plane_out) return;
  const int b = (int)(idx / plane_out);

  const float y = fy[idx];
  const float x = fx[idx];
  const float yf = floorf(y);
  const float xf = floorf(x);
  const float wy = y - yf;
  const float wx = x - xf;
  const float omx = 1.f - wx;
  const float omy = 1.f - wy;
  const int y0 = (int)fminf(fmaxf(yf, 0.f), (float)(h - 1));
  const int x0 = (int)fminf(fmaxf(xf, 0.f), (float)(w - 1));
  const int y1 = min(y0 + 1, h - 1);
  const int x1 = min(x0 + 1, w - 1);

  const float* s = img + (size_t)b * h * w;
  const float top = s[(size_t)y0 * w + x0] * omx + s[(size_t)y0 * w + x1] * wx;
  const float bot = s[(size_t)y1 * w + x0] * omx + s[(size_t)y1 * w + x1] * wx;
  out[idx] = top * omy + bot * wy;
}

// img [B,h,w], fy/fx/out [B,Ho,Wo], all f32 on the device.
// Returns the launch's cudaError_t.
extern "C" int ff_sample_abs(const float* img, const float* fy, const float* fx,
                             float* out, int B, int h, int w, int Ho, int Wo,
                             void* stream) {
  if (B < 1 || h < 1 || w < 1 || Ho < 1 || Wo < 1)
    return (int)cudaErrorInvalidValue;
  const size_t total = (size_t)B * Ho * Wo;
  const int threads = 256;
  const size_t blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  sample_abs_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      img, fy, fx, out, B, h, w, Ho, Wo);
  return (int)cudaGetLastError();
}
