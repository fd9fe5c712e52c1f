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
// What bounds it: memory. It must read 5 planes (20 B) and write 2 (8 B)
// per pixel; the separable sums are about 30 adds per plane and pixel,
// well under the f32 rate's share. Design: one block per (image, 32x32
// output tile); for each plane in turn it loads the tile plus a win/2 halo
// (clamped: the replicate border) into shared memory, sums the columns
// into a second shared buffer, then each thread sums its rows and keeps
// the blurred value in registers. The five blurred planes never leave the
// SM: the solve runs on the registers and only u and v are written.
//
// Numerics: sums in the plain twin's tap order, the mean as a product with
// the float32 rounding of 1/(win*win), built with --fmad=false and
// IEEE division, so each step is rounded as in the twin.

#include <cuda_runtime.h>

#define MAX_R 15
#define TILE 32
#define THREADS_Y 8
#define ROWS (TILE / THREADS_Y)

__global__ void __launch_bounds__(TILE * THREADS_Y)
box_blur_solve_kernel(const float* __restrict__ m0, const float* __restrict__ m1,
                      const float* __restrict__ m2, const float* __restrict__ m3,
                      const float* __restrict__ m4, float* __restrict__ u,
                      float* __restrict__ v, int H, int W, int r,
                      float inv_area) {
  __shared__ float s_in[TILE + 2 * MAX_R][TILE + 2 * MAX_R];
  __shared__ float s_v[TILE][TILE + 2 * MAX_R];

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * TILE;
  const int y0 = blockIdx.y * TILE;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TILE + tx;
  const int nthreads = TILE * THREADS_Y;
  const int win = 2 * r + 1;
  const int in_h = TILE + 2 * r;
  const int in_w = TILE + 2 * r;
  const size_t plane = (size_t)H * W;
  const float* planes[5] = {m0, m1, m2, m3, m4};
  float blur[5][ROWS];

#pragma unroll
  for (int p = 0; p < 5; ++p) {
    const float* src = planes[p] + (size_t)b * plane;
    // (the previous plane's column pass finished reading s_in before the
    // barrier ahead of its row pass, so s_in may be refilled now)
    for (int i = tid; i < in_h * in_w; i += nthreads) {
      const int rr = i / in_w, c = i % in_w;
      const int y = min(max(y0 - r + rr, 0), H - 1);
      const int x = min(max(x0 - r + c, 0), W - 1);
      s_in[rr][c] = src[(size_t)y * W + x];
    }
    __syncthreads();
    for (int i = tid; i < TILE * in_w; i += nthreads) {
      const int rr = i / in_w, c = i % in_w;
      float a = s_in[rr][c];
      for (int k = 1; k < win; ++k) a = a + s_in[rr + k][c];
      s_v[rr][c] = a;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const int rr = ty + j * THREADS_Y;
      float a = s_v[rr][tx];
      for (int k = 1; k < win; ++k) a = a + s_v[rr][tx + k];
      blur[p][j] = a * inv_area;
    }
  }

  const int x = x0 + tx;
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const int y = y0 + ty + j * THREADS_Y;
    if (y >= H || x >= W) continue;
    const float g11 = blur[0][j], g12 = blur[1][j], g22 = blur[2][j];
    const float h1 = blur[3][j], h2 = blur[4][j];
    const float idet = 1.f / (g11 * g22 - g12 * g12 + 1e-3f);
    const size_t o = (size_t)b * plane + (size_t)y * W + x;
    u[o] = (g22 * h1 - g12 * h2) * idet;
    v[o] = (g11 * h2 - g12 * h1) * idet;
  }
}

// m0..m4, u, v: [B,H,W] f32 on the device; win odd, <= 2*MAX_R+1.
// Returns the launch's cudaError_t.
extern "C" int ff_box_blur_solve(const float* m0, const float* m1,
                                 const float* m2, const float* m3,
                                 const float* m4, float* u, float* v, int B,
                                 int H, int W, int win, float inv_area,
                                 void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || win < 1 || win % 2 == 0 ||
      win > 2 * MAX_R + 1)
    return (int)cudaErrorInvalidValue;
  dim3 block(TILE, THREADS_Y);
  dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
  box_blur_solve_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      m0, m1, m2, m3, m4, u, v, H, W, win / 2, inv_area);
  return (int)cudaGetLastError();
}
