// Bilinear samplers for Hopper (sm_90a): K2, the relative warp of the
// Farnebäck R1 planes, and K4, the sampler of the DIS patch search in its
// patch and dense forms (below). K5, the DIS refinement's warp of three
// planes, has a kernel of its own in warp_planes.cu.
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
// K2; 0 takes any P at run time) so the plane loop unrolls.
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
//   SM and one block's copies and barriers overlap the others' gathers. At
//   P=5 the cap costs 8 B of spill stores and 16 B of loads; three blocks
//   (80 registers, no spill) ran 4% slower at 256 px on the H100.
//
// Numerics: the same expression order as the plain twin, built with
// --fmad=false, so each product and sum is rounded as there (bitwise equal
// on the card).

#include <algorithm>
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int WT = 32;           // output tile width: a warp's columns
constexpr int HT = 32;           // output tile height
constexpr int ROWS = 4;          // rows per thread, WT * HT / WTHREADS
constexpr int WTHREADS = 256;
constexpr int WMIN_BLOCKS = 4;   // resident blocks per SM: <= 64 registers
constexpr int WWARPS = WTHREADS / 32;
constexpr int BOX_MAX = 5120;    // floats of one staged plane (20 KB)

// Copy rows [by, by + bh) x columns [bx, bx + bw) of a plane (row stride W)
// into dst (row stride ds) with the WTHREADS threads of a block; with vec,
// bx, bw and ds are multiples of 4 and the plane is 16-byte aligned.
__device__ __forceinline__ void stage_box(float* dst, int ds,
                                          const float* plane, int W, int by,
                                          int bh, int bx, int bw, bool vec) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if (vec) {
    const int n4 = bw >> 2;
    for (int i = tid; i < bh * n4; i += WTHREADS) {
      const int r = i / n4, c = (i - r * n4) << 2;
      cp_async16(dst + r * ds + c, plane + (by + r) * W + bx + c);
    }
  } else {
    for (int i = tid; i < bh * bw; i += WTHREADS) {
      const int r = i / bw, c = i - r * bw;
      cp_async4(dst + r * ds + c, plane + (by + r) * W + bx + c);
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
    stage_box(s_box[0], bw, src, W, by0, bh, bx0, bw, vec);
    cp_async_commit();
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (p + 1 < P) {
        stage_box(s_box[(p + 1) & 1], bw, src + (p + 1) * plane, W, by0,
                  bh, bx0, bw, vec);
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
// Returns the launch's cudaError_t. K2 (warp_bilinear) passes the P=5
// Farnebäck planes; any other P takes the same kernel with the plane count
// at run time.
extern "C" int ff_warp_bilinear(const float* R, const float* u, const float* v,
                                float* out, int B, int P, int H, int W,
                                void* stream) {
  if (B < 1 || P < 1 || H < 1 || W < 1 ||
      (long long)P * H * W > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (P == 5) return launch_warp<5>(R, u, v, out, B, P, H, W, st);
  return launch_warp<0>(R, u, v, out, B, P, H, W, st);
}

// K4: the bilinear sampler of the DIS patch search, in two forms of one
// kernel body: the patch sampler (every descent step of every pyramid
// level, and the densification weights) and the dense absolute sampler.
//
// Replaces: funscript_flow_tpu/ops/pallas/warp.py sample_abs_pallas, which
// the JAX DIS calls on a dense [B, ny*ps, nx*ps] coordinate grid. Plain
// twins: funscript_flow_tpu_torch/models/dis.py _sample_patches_plain (the
// patch form: _sample_patches_dense with bilinear_abs) and bilinear_abs (the
// dense form, the counterpart of _bilinear_abs_packed); wrappers:
// ops/cuda/warp.py sample_patches and sample_abs.
//
// What it computes: the bilinear sample of img[b] (h x w) at (y, x), with
// y0 = clamp(floor(y), 0, h-1), the +1 neighbour edge-replicated, likewise
// in x:
// - patch form: out[b,i,j,dy*ps+dx] at y = clamp(i*stride + pv[b,i,j], 0,
//   h-ps) + dy, x = clamp(j*stride + pu[b,i,j], 0, w-ps) + dx, the corner
//   formed in float32 as the twin forms it (i*stride is exact);
// - dense form: out[b,o] at (fy[b,o], fx[b,o]), read from device memory.
//
// What bounds it: memory, and at the DIS levels (3-14 MB written per call)
// the host's cost of the call more than either. The patch form must read 8 B
// of offsets per patch and the source plane and write 4 B per output; the
// dense grid of the JAX design read 8 B of coordinates per output more,
// and needed about 9 small eager launches to build and fold it per call.
//
// Design: one block of 256 threads per (image, run of consecutive items);
// an item is a patch (at most PATCHES_MAX, about 16 outputs per thread) or
// an output. Consecutive threads take consecutive outputs, so a warp
// covers half a patch (4 rows x 8 columns at ps = 8) and its stores, like
// each patch's 64 outputs, are contiguous.
// - The patch form first forms its patches' clamped corners (into shared
//   memory) and reduces them to the source rows the block reads.
// - When the source plane fits STAGE_MAX (any DIS level up to 128 x 128),
//   the block copies those rows (the dense form: the whole plane) into
//   shared memory with cp.async (16-byte copies where rows are whole
//   float4s) and gathers from there. The staged row stride is congruent to
//   8 or 24 modulo 32 floats, so the 4 rows x 8 columns of a warp's corner
//   reads fall on 32 distinct banks.
// - Otherwise the block gathers from device memory directly. Both branches
//   do the same arithmetic in the same order on the same values.
//
// Numerics: the twins' expression order, built with --fmad=false (bitwise
// equal on the card).

namespace {

constexpr int ST = 256;                  // sampler threads per block
constexpr int SWARPS = ST / 32;
constexpr int PATCHES_MAX = 128;         // patches per block, patch form
constexpr int OUT_PER_BLOCK = 4096;      // outputs per block, about 16/thread
constexpr int STAGE_MAX = 100 * 1024;    // bytes of the largest staged plane
constexpr int MAX_DEVICES = 64;

struct SampleGeom {
  int h, w;        // source plane
  int items;       // per image: patches (patch form) or outputs (dense)
  int per_block;   // items per block
  int nx, ps, stride;  // patch form: grid width, patch size, patch stride
  int ld;          // row stride of the staged plane; 0: gather directly
  int vec;         // 16-byte staging copies
};

// Bilinear sample at (y, x) of a plane whose rows row0.. are at s with row
// stride ld, in the twins' order.
__device__ __forceinline__ float bilinear(const float* s, int ld, int row0,
                                          float y, float x, int h, int w) {
  const float yf = floorf(y);
  const float xf = floorf(x);
  const float wy = y - yf;
  const float wx = x - xf;
  const float omx = 1.f - wx;
  const float omy = 1.f - wy;
  // clamp in float, then convert: equal to clip(int(floor)) for any finite
  // coordinate
  const int y0 = (int)fminf(fmaxf(yf, 0.f), (float)(h - 1));
  const int x0 = (int)fminf(fmaxf(xf, 0.f), (float)(w - 1));
  const int y1 = min(y0 + 1, h - 1);
  const int x1 = min(x0 + 1, w - 1);
  const float* r0 = s + (y0 - row0) * ld;
  const float* r1 = s + (y1 - row0) * ld;
  const float top = r0[x0] * omx + r0[x1] * wx;
  const float bot = r1[x0] * omx + r1[x1] * wx;
  return top * omy + bot * wy;
}

// PATCH: the patch form (cy, cx = pv, pu [B, ny, nx]; PSC > 0 the patch
// size at compile time, 0 at run time); else the dense form (cy, cx = fy,
// fx [B, items]).
template <bool PATCH, int PSC>
__global__ void __launch_bounds__(ST)
sample_kernel(const float* __restrict__ img, const float* __restrict__ cy,
              const float* __restrict__ cx, float* __restrict__ out,
              SampleGeom g) {
  extern __shared__ float4 smem4[];
  float* s_img = reinterpret_cast<float*>(smem4);
  __shared__ float s_fy[PATCH ? PATCHES_MAX : 1];
  __shared__ float s_fx[PATCH ? PATCHES_MAX : 1];
  __shared__ int s_red[2][SWARPS];
  const int tid = threadIdx.x;
  const int ps = PSC > 0 ? PSC : g.ps;
  const int npx = PATCH ? ps * ps : 1;  // outputs per item
  const size_t ibase = (size_t)blockIdx.y * g.items;
  const float* src = img + (size_t)blockIdx.y * g.h * g.w;
  const int k0 = blockIdx.x * g.per_block;
  const int nk = min(g.per_block, g.items - k0);

  int lo = 0, hi = g.h - 1;  // the source rows the block reads
  if (PATCH) {
    int rmin = INT_MAX, rmax = -1;
    for (int k = tid; k < nk; k += ST) {
      const int i = (k0 + k) / g.nx;
      const int j = (k0 + k) - i * g.nx;
      const float fy = fminf(fmaxf((float)(i * g.stride) + cy[ibase + k0 + k],
                                   0.f), (float)(g.h - ps));
      const float fx = fminf(fmaxf((float)(j * g.stride) + cx[ibase + k0 + k],
                                   0.f), (float)(g.w - ps));
      s_fy[k] = fy;
      s_fx[k] = fx;
      rmin = min(rmin, (int)floorf(fy));
      rmax = max(rmax, (int)floorf(fy));
    }
    rmin = __reduce_min_sync(0xffffffffu, rmin);
    rmax = __reduce_max_sync(0xffffffffu, rmax);
    if ((tid & 31) == 0) {
      s_red[0][tid >> 5] = rmin;
      s_red[1][tid >> 5] = rmax;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < SWARPS; ++k) {
      rmin = min(rmin, s_red[0][k]);
      rmax = max(rmax, s_red[1][k]);
    }
    // floor(corner + dy) lies in [floor(corner), floor(corner) + ps], and
    // the +1 neighbour one row below
    lo = rmin;
    hi = min(g.h - 1, rmax + ps + 1);
  }
  if (g.ld) {
    stage_box(s_img, g.ld, src, g.w, lo, hi - lo + 1, 0, g.w, g.vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  const float* s = g.ld ? s_img : src;
  const int ld = g.ld ? g.ld : g.w;
  const int row0 = g.ld ? lo : 0;

  float* dst = out + (ibase + k0) * npx;
  const int n_out = nk * npx;
  for (int o = tid; o < n_out; o += ST) {
    float y, x;
    if (PATCH) {
      const int k = o / npx;
      const int q = o - k * npx;
      const int dy = q / ps;
      y = s_fy[k] + (float)dy;
      x = s_fx[k] + (float)(q - dy * ps);
    } else {
      y = cy[ibase + k0 + o];
      x = cx[ibase + k0 + o];
    }
    dst[o] = bilinear(s, ld, row0, y, x, g.h, g.w);
  }
}

template <bool PATCH, int PSC>
int launch_sample(const float* img, const float* cy, const float* cx,
                  float* out, int B, SampleGeom g, cudaStream_t stream) {
  // the staged plane's row stride: w rounded up to 16, plus 8
  const int ld = (g.w + 15) / 16 * 16 + 8;
  const size_t smem = (size_t)g.h * ld * sizeof(float);
  g.ld = smem <= STAGE_MAX ? ld : 0;
  g.vec = g.w % 4 == 0 && (uintptr_t)img % 16 == 0;
  // the dense form stages the whole plane: at least twice its size in
  // outputs per block
  if (!PATCH && g.ld) g.per_block = std::max(g.per_block, 2 * g.h * g.w);
  // more than 48 KB of dynamic shared memory is opted into once per device
  // (a race only sets the attribute twice)
  static bool opted[MAX_DEVICES] = {};
  cudaError_t e;
  if (g.ld && smem > 48 * 1024) {
    int dev = 0;
    e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= MAX_DEVICES || !opted[dev]) {
      e = cudaFuncSetAttribute(sample_kernel<PATCH, PSC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               STAGE_MAX);
      if (e != cudaSuccess) return (int)e;
      if (dev < MAX_DEVICES) opted[dev] = true;
    }
  }
  const int npx = PATCH ? g.ps * g.ps : 1;
  const size_t plane = (size_t)g.h * g.w, n_in = (size_t)g.items;
  for (int b0 = 0; b0 < B; b0 += 65535) {
    const int nb = B - b0 < 65535 ? B - b0 : 65535;
    const dim3 grid((g.items + g.per_block - 1) / g.per_block, nb);
    sample_kernel<PATCH, PSC><<<grid, ST, g.ld ? smem : 0, stream>>>(
        img + b0 * plane, cy + b0 * n_in, cx + b0 * n_in,
        out + b0 * n_in * npx, g);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

// Patch form. img [B,h,w], pu/pv [B,ny,nx] (x and y offsets), out
// [B,ny,nx,ps*ps], all f32 on the device. Returns the launch's cudaError_t.
extern "C" int ff_sample_patches(const float* img, const float* pu,
                                 const float* pv, float* out, int B, int h,
                                 int w, int ny, int nx, int ps, int stride,
                                 void* stream) {
  if (B < 1 || ny < 1 || nx < 1 || ps < 1 || ps > h || ps > w ||
      stride < 1 || (long long)h * w > 0x7fffffff ||
      (long long)ny * nx * ps * ps > 0x7fffffff ||
      (long long)std::max(ny, nx) * stride > (1 << 24))
    return (int)cudaErrorInvalidValue;
  SampleGeom g{};
  g.h = h;
  g.w = w;
  g.items = ny * nx;
  g.per_block = std::max(1, std::min(PATCHES_MAX, OUT_PER_BLOCK / (ps * ps)));
  g.nx = nx;
  g.ps = ps;
  g.stride = stride;
  const cudaStream_t st = (cudaStream_t)stream;
  if (ps == 8) return launch_sample<true, 8>(img, pv, pu, out, B, g, st);
  return launch_sample<true, 0>(img, pv, pu, out, B, g, st);
}

// Dense form. img [B,h,w], fy/fx/out [B,Ho,Wo], all f32 on the device.
// Returns the launch's cudaError_t.
extern "C" int ff_sample_abs(const float* img, const float* fy, const float* fx,
                             float* out, int B, int h, int w, int Ho, int Wo,
                             void* stream) {
  if (B < 1 || h < 1 || w < 1 || Ho < 1 || Wo < 1 ||
      (long long)h * w > 0x7fffffff || (long long)Ho * Wo > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  SampleGeom g{};
  g.h = h;
  g.w = w;
  g.items = Ho * Wo;
  g.per_block = OUT_PER_BLOCK;
  return launch_sample<false, 0>(img, fy, fx, out, B, g,
                                 (cudaStream_t)stream);
}
