// Box blur of the 5 Farnebäck constraint planes + 2x2 solve, for Hopper
// (sm_90a).
//
// Replaces: funscript_flow_tpu/ops/pallas/flow_step.py box_blur_solve_pallas.
// Plain twin: funscript_flow_tpu_torch/ops/farneback.py solve_flow; wrapper:
// ops/cuda/flow_step.py.
//
// What it computes: g11, g12, g22, h1, h2 = the win x win replicate-border
// mean of each of the planes m0..m4 [B,H,W]; then
//   idet = 1 / (g11*g22 - g12^2 + 1e-3),
//   u = (g22*h1 - g12*h2) * idet,  v = (g11*h2 - g12*h1) * idet.
//
// What bounds it on this card: the bytes are 5 planes read (20 B) and 2
// written (8 B) per pixel. The work is the tap sums: the twin's order (the
// vertical pass first, taps in order, then the product with 1/(win*win))
// forbids a running sum, so each output costs win - 1 adds per pass and
// plane: about 150 adds per pixel at win 15, about half the byte bound's
// time at the card's float32 rate. So the time is decided by how many
// loads, stores and index operations ride along with each add, and by
// keeping loads in flight behind the sums.
//
// Design: one block of 256 threads per (image, 64 x 32 output tile), the
// radius a template parameter (r = 0..15, the wrapper's odd win <= 31), so
// every tap loop unrolls and shared memory is sized for the radius launched.
// - Vertical pass from registers: one warp task per (plane, 32-column chunk
//   of the 64 + 2r haloed columns). Each lane walks its column down from
//   device memory (one coalesced row per load, the replicate border as a
//   clamped index), holds the 32 + 2r values in registers and sums each
//   output row's win taps in order: every input is loaded once per column
//   instead of win times from shared memory. The column sums of all five
//   planes go to shared memory, [5][32][64 + 2r rounded up to 4].
// - One barrier, then the horizontal pass with register blocking: a thread
//   takes 4 adjacent outputs of a row, reads the 4 + 2r column sums it needs
//   as float4 (conflict-free), and sums each output's win taps in order;
//   the five blurred values stay in registers through the solve, and u and
//   v are written as float4 where the row allows it.
// - No barrier per plane and no staging copy: the loads of the other blocks
//   on the SM overlap this block's sums. MIN_BLOCKS caps the registers so
//   that three blocks fit (left unbounded, the compiler takes 128 and
//   only two fit, too few to hide the loads).
//
// Numerics: sums in the plain twin's tap order, the mean as a product with
// the float32 rounding of 1/(win*win), built with --fmad=false and IEEE
// division, so each step is rounded as in the twin (bitwise equal on the
// card).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_R = 15;
constexpr int TW = 64;         // output tile width
constexpr int TH = 32;         // output tile height
constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 3;  // resident blocks per SM: <= 80 registers
constexpr int WARPS = THREADS / 32;
constexpr int QUADS = TW / 4;                 // 4-wide output groups per row
constexpr int QROWS = THREADS / QUADS;        // rows per horizontal step
static_assert(TH % QROWS == 0, "tile height must be a multiple of QROWS");

template <int R>
struct Geometry {
  static constexpr int WIN = 2 * R + 1;
  static constexpr int NC = TW + 2 * R;        // haloed columns
  static constexpr int NCP = (NC + 3) / 4 * 4; // row stride, float4 aligned
  static constexpr int NCH = (NC + 31) / 32;   // 32-column chunks
  static constexpr int NV4 = (4 + 2 * R + 3) / 4;  // float4 reads per quad
  static constexpr int SMEM = 5 * TH * NCP * (int)sizeof(float);
};

template <int R>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
box_blur_solve_kernel(const float* __restrict__ m0,
                      const float* __restrict__ m1,
                      const float* __restrict__ m2,
                      const float* __restrict__ m3,
                      const float* __restrict__ m4, float* __restrict__ u,
                      float* __restrict__ v, int H, int W, float inv_area,
                      int vec) {
  using G = Geometry<R>;
  extern __shared__ float4 smem4[];
  float* s_v = reinterpret_cast<float*>(smem4);  // [5][TH][NCP] column sums

  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const size_t base = (size_t)blockIdx.z * H * W;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // vertical pass: warp task = (plane, 32-column chunk)
  for (int task = warp; task < 5 * G::NCH; task += WARPS) {
    const int p = task / G::NCH;
    const int c = (task - p * G::NCH) * 32 + lane;
    if (c >= G::NC) continue;
    const float* src = (p == 0 ? m0 : p == 1 ? m1 : p == 2 ? m2
                        : p == 3 ? m3 : m4) +
                       base + min(max(x0 - R + c, 0), W - 1);
    float col[TH + 2 * R];
#pragma unroll
    for (int j = 0; j < TH + 2 * R; ++j)
      col[j] = src[min(max(y0 - R + j, 0), H - 1) * W];
    float* dst = s_v + p * TH * G::NCP + c;
#pragma unroll
    for (int i = 0; i < TH; ++i) {
      float a = col[i];
#pragma unroll
      for (int k = 1; k < G::WIN; ++k) a = a + col[i + k];
      dst[i * G::NCP] = a;
    }
  }
  __syncthreads();

  // horizontal pass + solve: 4 adjacent outputs of one row per thread
  const int qx = threadIdx.x % QUADS;
  const int x = x0 + 4 * qx;
#pragma unroll
  for (int step = 0; step < TH / QROWS; ++step) {
    const int i = threadIdx.x / QUADS + step * QROWS;
    const int y = y0 + i;
    if (y >= H || x >= W) continue;
    float blur[5][4];
#pragma unroll
    for (int p = 0; p < 5; ++p) {
      const float4* row =
          reinterpret_cast<const float4*>(s_v + (p * TH + i) * G::NCP) + qx;
      float w[4 * G::NV4];
#pragma unroll
      for (int k = 0; k < G::NV4; ++k) {
        const float4 t = row[k];
        w[4 * k] = t.x;
        w[4 * k + 1] = t.y;
        w[4 * k + 2] = t.z;
        w[4 * k + 3] = t.w;
      }
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        float a = w[o];
#pragma unroll
        for (int k = 1; k < G::WIN; ++k) a = a + w[o + k];
        blur[p][o] = a * inv_area;
      }
    }
    float uo[4], vo[4];
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      const float g11 = blur[0][o], g12 = blur[1][o], g22 = blur[2][o];
      const float h1 = blur[3][o], h2 = blur[4][o];
      const float idet = 1.f / (g11 * g22 - g12 * g12 + 1e-3f);
      uo[o] = (g22 * h1 - g12 * h2) * idet;
      vo[o] = (g11 * h2 - g12 * h1) * idet;
    }
    const size_t off = base + (size_t)y * W + x;
    if (vec && x + 3 < W) {
      *reinterpret_cast<float4*>(u + off) =
          make_float4(uo[0], uo[1], uo[2], uo[3]);
      *reinterpret_cast<float4*>(v + off) =
          make_float4(vo[0], vo[1], vo[2], vo[3]);
    } else {
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        if (x + o < W) {
          u[off + o] = uo[o];
          v[off + o] = vo[o];
        }
      }
    }
  }
}

constexpr int MAX_DEVICES = 64;

template <int R>
int launch(const float* m0, const float* m1, const float* m2,
           const float* m3, const float* m4, float* u, float* v, int B,
           int H, int W, float inv_area, int vec, cudaStream_t stream) {
  const int smem = Geometry<R>::SMEM;
  // more than 48 KB of dynamic shared memory is opted into once per device
  // (a race only sets the attribute twice)
  static bool opted[MAX_DEVICES] = {};
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= MAX_DEVICES || !opted[dev]) {
      e = cudaFuncSetAttribute(box_blur_solve_kernel<R>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
      if (e != cudaSuccess) return (int)e;
      if (dev < MAX_DEVICES) opted[dev] = true;
    }
  }
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  box_blur_solve_kernel<R><<<grid, THREADS, smem, stream>>>(
      m0, m1, m2, m3, m4, u, v, H, W, inv_area, vec);
  return (int)cudaGetLastError();
}

using LaunchFn = int (*)(const float*, const float*, const float*,
                         const float*, const float*, float*, float*, int, int,
                         int, float, int, cudaStream_t);
const LaunchFn kLaunch[MAX_R + 1] = {
    launch<0>,  launch<1>,  launch<2>,  launch<3>,  launch<4>,  launch<5>,
    launch<6>,  launch<7>,  launch<8>,  launch<9>,  launch<10>, launch<11>,
    launch<12>, launch<13>, launch<14>, launch<15>};

}  // namespace

// m0..m4, u, v: [B,H,W] f32 on the device; win odd, <= 2*MAX_R+1.
// Returns the launch's cudaError_t.
extern "C" int ff_box_blur_solve(const float* m0, const float* m1,
                                 const float* m2, const float* m3,
                                 const float* m4, float* u, float* v, int B,
                                 int H, int W, int win, float inv_area,
                                 void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || (long long)H * W > 0x7fffffff ||
      win < 1 || win % 2 == 0 || win > 2 * MAX_R + 1)
    return (int)cudaErrorInvalidValue;
  // float4 stores of u and v: rows of whole float4s on 16-byte bases
  const int vec = W % 4 == 0 && ((uintptr_t)u | (uintptr_t)v) % 16 == 0;
  return kLaunch[win / 2](m0, m1, m2, m3, m4, u, v, B, H, W, inv_area, vec,
                          (cudaStream_t)stream);
}
