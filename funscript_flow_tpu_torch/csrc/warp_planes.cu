// K5 for Hopper (sm_90a): the relative bilinear warp of the three planes of
// the DIS variational refinement, (I1, I1x, I1y), by the incoming flow.
//
// Replaces: funscript_flow_tpu/ops/pallas/warp.py warp_planes_padded (through
// warp_bilinear_pallas), whose width padding to 128 lanes existed only for
// Mosaic. Plain twin: funscript_flow_tpu_torch/models/dis.py
// _warp_planes_plain; wrapper: ops/cuda/warp.py warp_planes.
//
// What it computes: out[b,p,y,x] = bilinear sample of plane p of image b at
// (x + u[b,y,x], y + v[b,y,x]), with the four corners clamped one by one:
// x0c = clamp(floor(fx), 0, W-1), x1c = min(x0c + 1, W-1), likewise in y.
// The DIS path passes flow that keeps every sample inside the image; any
// flow is sampled the same way.
//
// What bounds it on this card: memory. It must read u, v (8 B) and the three
// planes (12 B) and write three planes (12 B): 32 B per pixel. The DIS
// levels are small (252 images of 32, 64 or 128 px: 0.26-4.13 Mpx a call),
// so a call is over in a few microseconds of memory time, and what a block
// spends besides its bytes (barriers, reductions, long chains of dependent
// loads) shows at once.
//
// Design: one block of 256 threads per (image, band of BAND = 1024
// consecutive pixels): a whole 32 px image, 16 rows of a 64 px one, 8 of a
// 128 px one. The planes are read through three base pointers: the caller
// stacks nothing.
// - Where W % 4 == 0 (and every pointer is 16-byte aligned) a thread takes
//   four adjacent pixels of a row: u and v are read, and each output plane
//   written, 16 bytes at a time. For the gathers, the four pixels are
//   taken in an order rotated by (lane / 8) % 4, so that in each load the
//   warp's four groups of eight lanes read four different residues modulo
//   4 of the column: 32 distinct banks for a smooth field (unrotated, the
//   lanes 8 apart would hit one bank, four ways). The rotations are
//   register moves under a predicate. Otherwise a thread takes the pixels
//   tid, tid + 256, ... of the band, one at a time.
// - A pixel's weights and corner offsets are computed once and serve all
//   three planes.
// - The band's clamped corners are reduced to the source rows they reach;
//   when those rows fit the staging buffer (rows_cap rows of each plane,
//   the band's rows and MARGIN rows above and below), one cp.async group
//   copies them for all three planes into shared memory (16-byte copies
//   where rows are whole float4s), the block waits on one barrier and
//   gathers from there. Otherwise it gathers from device memory directly;
//   both branches do the same arithmetic in the same order on the same
//   values. A buffer above 48 KB (wide images only) is opted into with
//   cudaFuncSetAttribute, once per device.
// - MIN_BLOCKS caps the registers at 64 so that no pixel state spills.
//
// Numerics: the plain twin's expression order, built with --fmad=false, so
// each product and sum is rounded as there (bitwise equal on the card).

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int PT = 256;              // threads per block
constexpr int PX = 4;                // pixels per thread
constexpr int BAND = PT * PX;        // pixels per block
constexpr int PWARPS = PT / 32;
constexpr int MIN_BLOCKS = 4;        // resident blocks per SM: <= 64 registers
constexpr int MARGIN = 8;            // staged rows above and below a band
constexpr int SMEM_MAX = 96 * 1024;  // bytes of the largest staging buffer
constexpr int MAX_DEVICES = 64;

// a[s] <- a[(s + r) & 3]: fixed indices, so the array stays in registers
__device__ __forceinline__ void rotate4(float (&a)[PX], int r) {
  if (r & 1) {
    const float t = a[0];
    a[0] = a[1];
    a[1] = a[2];
    a[2] = a[3];
    a[3] = t;
  }
  if (r & 2) {
    const float t0 = a[0], t1 = a[1];
    a[0] = a[2];
    a[1] = a[3];
    a[2] = t0;
    a[3] = t1;
  }
}

// Copy rows [row0, row0 + rows) of a plane (row stride W) into dst, with
// the same row stride, with the PT threads of a block: 16-byte copies with
// VEC (W a multiple of 4, the plane and dst 16-byte aligned), else 4-byte
// ones. The (row, column) of a thread's copy advances by PT copies without
// a division.
template <bool VEC>
__device__ __forceinline__ void stage_rows(float* dst, const float* plane,
                                           int W, int row0, int rows) {
  const int per_row = VEC ? W / 4 : W;
  const int w = VEC ? 4 : 1;
  const int dr = PT / per_row, dc = PT - dr * per_row;
  int r = threadIdx.x / per_row;
  int c = threadIdx.x - r * per_row;
  for (; r < rows;) {
    if (VEC)
      cp_async16(dst + r * W + c * w, plane + (row0 + r) * W + c * w);
    else
      cp_async4(dst + r * W + c, plane + (row0 + r) * W + c);
    r += dr;
    c += dc;
    if (c >= per_row) {
      c -= per_row;
      ++r;
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(PT, MIN_BLOCKS)
warp_planes_kernel(const float* __restrict__ I1, const float* __restrict__ I1x,
                   const float* __restrict__ I1y, const float* __restrict__ u,
                   const float* __restrict__ v, float* __restrict__ out,
                   int H, int W, int rows_cap) {
  extern __shared__ float4 smem4[];
  float* s_rows = reinterpret_cast<float*>(smem4);
  __shared__ int s_red[2][PWARPS];
  const int HW = H * W;
  const int lane = threadIdx.x & 31;
  const size_t ib = (size_t)blockIdx.y * HW;  // this image's plane offset
  const int p0 = blockIdx.x * BAND + (VEC ? threadIdx.x * PX : threadIdx.x);
  // VEC: slot s takes pixel (s + rot) & 3 of the thread's four
  const int rot = VEC ? (lane >> 3) & 3 : 0;

  // per slot: weights, clamped top-left corner, +1 column/row present
  bool ok[PX];
  float wx[PX], wy[PX];
  int x0c[PX], y0c[PX], dx[PX], dyr[PX];
  float us[PX], vs[PX];
  int ys[PX], xs[PX];
  if (VEC) {
    const bool in = p0 < HW;
    const float4 U = in ? *reinterpret_cast<const float4*>(u + ib + p0)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 V = in ? *reinterpret_cast<const float4*>(v + ib + p0)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    us[0] = U.x; us[1] = U.y; us[2] = U.z; us[3] = U.w;
    vs[0] = V.x; vs[1] = V.y; vs[2] = V.z; vs[3] = V.w;
    rotate4(us, rot);
    rotate4(vs, rot);
    const int y = in ? p0 / W : 0;
    const int x = p0 - y * W;
#pragma unroll
    for (int s = 0; s < PX; ++s) {
      ok[s] = in;
      ys[s] = y;
      xs[s] = x + ((s + rot) & 3);
    }
  } else {
#pragma unroll
    for (int s = 0; s < PX; ++s) {
      const int p = p0 + s * PT;
      ok[s] = p < HW;
      ys[s] = ok[s] ? p / W : 0;
      xs[s] = ok[s] ? p - ys[s] * W : 0;
      us[s] = ok[s] ? u[ib + p] : 0.f;
      vs[s] = ok[s] ? v[ib + p] : 0.f;
    }
  }
  int rmin = INT_MAX, rmax = -1;
#pragma unroll
  for (int s = 0; s < PX; ++s) {
    const float fx = (float)xs[s] + us[s];
    const float fy = (float)ys[s] + vs[s];
    const float xf = floorf(fx);
    const float yf = floorf(fy);
    wx[s] = fx - xf;
    wy[s] = fy - yf;
    // clamp in float, then convert: equal to clip(int(floor)) for any
    // finite coordinate and safe for ones beyond the int range
    x0c[s] = (int)fminf(fmaxf(xf, 0.f), (float)(W - 1));
    y0c[s] = (int)fminf(fmaxf(yf, 0.f), (float)(H - 1));
    dx[s] = x0c[s] + 1 < W ? 1 : 0;
    dyr[s] = y0c[s] + 1 < H ? 1 : 0;
    if (ok[s]) {
      rmin = min(rmin, y0c[s]);
      rmax = max(rmax, y0c[s] + dyr[s]);
    }
  }

  // the source rows of the band (thread 0's first pixel is always in it)
  rmin = __reduce_min_sync(0xffffffffu, rmin);
  rmax = __reduce_max_sync(0xffffffffu, rmax);
  if (lane == 0) {
    s_red[0][threadIdx.x >> 5] = rmin;
    s_red[1][threadIdx.x >> 5] = rmax;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < PWARPS; ++w) {
    rmin = min(rmin, s_red[0][w]);
    rmax = max(rmax, s_red[1][w]);
  }
  const int rows = rmax - rmin + 1;
  const bool staged = rows <= rows_cap;

  const float* planes[3] = {I1 + ib, I1x + ib, I1y + ib};
  float* dst = out + ib * 3;
  // gather the three planes from s0, s1, s2 (row stride W; their first
  // row is the image's row row0)
  auto gather = [&](const float* s0, const float* s1, const float* s2,
                    int row0) {
    // a slot past the image's end reads the first source row (its value
    // is never stored): row0 may lie below its row
    int off[PX], dy[PX];
#pragma unroll
    for (int s = 0; s < PX; ++s) {
      off[s] = ok[s] ? (y0c[s] - row0) * W + x0c[s] : 0;
      dy[s] = ok[s] ? dyr[s] * W : 0;
    }
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const float* src = p == 0 ? s0 : (p == 1 ? s1 : s2);
      float val[PX];
#pragma unroll
      for (int s = 0; s < PX; ++s) {
        const float* c = src + off[s];
        const float omx = 1.f - wx[s], omy = 1.f - wy[s];
        const float top = c[0] * omx + c[dx[s]] * wx[s];
        const float bot = c[dy[s]] * omx + c[dy[s] + dx[s]] * wx[s];
        val[s] = top * omy + bot * wy[s];
      }
      float* d = dst + (size_t)p * HW;
      if (VEC) {
        if (ok[0]) {
          rotate4(val, (4 - rot) & 3);  // back to the pixels' order
          *reinterpret_cast<float4*>(d + p0) =
              make_float4(val[0], val[1], val[2], val[3]);
        }
      } else {
#pragma unroll
        for (int s = 0; s < PX; ++s)
          if (ok[s]) d[p0 + s * PT] = val[s];
      }
    }
  };

  if (staged) {
    const int plane_stride = rows_cap * W;
#pragma unroll
    for (int p = 0; p < 3; ++p)
      stage_rows<VEC>(s_rows + p * plane_stride, planes[p], W, rmin, rows);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    gather(s_rows, s_rows + plane_stride, s_rows + 2 * plane_stride, rmin);
  } else {
    gather(planes[0], planes[1], planes[2], 0);
  }
}

template <bool VEC>
int launch_planes(const float* I1, const float* I1x, const float* I1y,
                  const float* u, const float* v, float* out, int B, int H,
                  int W, cudaStream_t stream) {
  // rows a band can reach: the rows it covers and MARGIN above and below,
  // within the image and the largest buffer
  const int span = BAND % W == 0 ? BAND / W : (BAND + W - 2) / W + 1;
  int rows_cap = span + 2 * MARGIN < H ? span + 2 * MARGIN : H;
  const int fit = SMEM_MAX / (3 * W * (int)sizeof(float));
  if (rows_cap > fit) rows_cap = fit;
  const size_t smem = (size_t)3 * rows_cap * W * sizeof(float);
  cudaError_t e;
  static bool opted[MAX_DEVICES] = {};
  if (smem > 48 * 1024) {  // a race only sets the attribute twice
    int dev = 0;
    e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= MAX_DEVICES || !opted[dev]) {
      e = cudaFuncSetAttribute(warp_planes_kernel<VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_MAX);
      if (e != cudaSuccess) return (int)e;
      if (dev < MAX_DEVICES) opted[dev] = true;
    }
  }
  const size_t plane = (size_t)H * W;
  const int bands = (int)((plane + BAND - 1) / BAND);
  for (int b0 = 0; b0 < B; b0 += 65535) {
    const int nb = B - b0 < 65535 ? B - b0 : 65535;
    const size_t o = (size_t)b0 * plane;
    warp_planes_kernel<VEC><<<dim3(bands, nb), PT, smem, stream>>>(
        I1 + o, I1x + o, I1y + o, u + o, v + o, out + 3 * o, H, W, rows_cap);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

// I1, I1x, I1y, u, v [B,H,W], out [B,3,H,W], all f32 on the device.
// Returns the launch's cudaError_t.
extern "C" int ff_warp_planes(const float* I1, const float* I1x,
                              const float* I1y, const float* u, const float* v,
                              float* out, int B, int H, int W, void* stream) {
  if (B < 1 || H < 1 || W < 1 || (long long)3 * H * W > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool vec = W % 4 == 0 &&
                   ((uintptr_t)I1 | (uintptr_t)I1x | (uintptr_t)I1y |
                    (uintptr_t)u | (uintptr_t)v | (uintptr_t)out) % 16 == 0;
  if (vec) return launch_planes<true>(I1, I1x, I1y, u, v, out, B, H, W, st);
  return launch_planes<false>(I1, I1x, I1y, u, v, out, B, H, W, st);
}
