// Farnebäck polynomial expansion of one image batch, for Hopper (sm_90a).
//
// Replaces: funscript_flow_tpu/ops/pallas/polyexp.py poly_exp_pallas (the
// Pallas TPU kernel). Plain twin: funscript_flow_tpu_torch/ops/farneback.py
// poly_exp; wrapper: ops/cuda/polyexp.py.
//
// What it computes: for img [B,H,W] f32, three vertical correlations with
// the applicability taps g, x*g, x^2*g (2n+1 taps, replicate border), then
// six horizontal correlations of those, combined into 5 planes written
// stacked as out [B,5,H,W]:
//   bx*ig11, by*ig11, bc*ig03 + bxx*ig33, bc*ig03 + byy*ig33, bxy*ig55.
//
// What bounds it: memory. Per pixel it must read 4 B and write 20 B, and it
// does about 200 flops, under the f32 rate's share of that traffic (about
// 8 flops per byte against the card's ~20). Design: one block per
// (image, 32x32 output tile) loads the tile plus an n-pixel clamped halo
// into shared memory once (the halo re-reads come from L2), runs the three
// vertical accumulators over the halo'd width into shared memory, then
// each thread does the six horizontal sums for its pixels and writes the
// five planes with coalesced row stores. Unlike the TPU kernel it runs at
// every pyramid level (32 px wide included).
//
// Numerics: every tap is summed in the plain twin's order (tap 0 first,
// products rounded before each add; the library is built with
// --fmad=false), so the kernel repeats the twin's roundings.

#include <cuda_runtime.h>

#define MAX_N 8
#define MAX_T (2 * MAX_N + 1)
#define TILE_W 32
#define TILE_H 32
#define THREADS_Y 8

struct PolyTaps {
  float g[MAX_T];
  float xg[MAX_T];
  float xxg[MAX_T];
  float ig11, ig03, ig33, ig55;
  int n;
};

__global__ void __launch_bounds__(TILE_W * THREADS_Y)
poly_exp_kernel(const float* __restrict__ img, float* __restrict__ out,
                int H, int W, PolyTaps tp) {
  __shared__ float s_in[TILE_H + 2 * MAX_N][TILE_W + 2 * MAX_N];
  __shared__ float s_v[3][TILE_H][TILE_W + 2 * MAX_N];
  __shared__ float s_taps[3][MAX_T];

  const int n = tp.n;
  const int T = 2 * n + 1;
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * TILE_W;
  const int y0 = blockIdx.y * TILE_H;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TILE_W + tx;
  const int nthreads = TILE_W * THREADS_Y;
  const int in_h = TILE_H + 2 * n;
  const int in_w = TILE_W + 2 * n;
  const size_t plane = (size_t)H * W;
  const float* src = img + (size_t)b * plane;

  if (tid < T) {
    s_taps[0][tid] = tp.g[tid];
    s_taps[1][tid] = tp.xg[tid];
    s_taps[2][tid] = tp.xxg[tid];
  }
  // tile + halo, coordinates clamped: the replicate border
  for (int i = tid; i < in_h * in_w; i += nthreads) {
    const int r = i / in_w, c = i % in_w;
    const int y = min(max(y0 - n + r, 0), H - 1);
    const int x = min(max(x0 - n + c, 0), W - 1);
    s_in[r][c] = src[(size_t)y * W + x];
  }
  __syncthreads();

  // vertical pass over the halo'd width; a halo column holds the vertical
  // sum of a clamped source column, which is the replicate pad of the
  // vertical result that the horizontal pass needs
  for (int i = tid; i < TILE_H * in_w; i += nthreads) {
    const int r = i / in_w, c = i % in_w;
    float s = s_in[r][c];
    float a0 = s * s_taps[0][0];
    float a1 = s * s_taps[1][0];
    float a2 = s * s_taps[2][0];
    for (int k = 1; k < T; ++k) {
      s = s_in[r + k][c];
      a0 = a0 + s * s_taps[0][k];
      a1 = a1 + s * s_taps[1][k];
      a2 = a2 + s * s_taps[2][k];
    }
    s_v[0][r][c] = a0;  // vertical g
    s_v[1][r][c] = a1;  // vertical x*g
    s_v[2][r][c] = a2;  // vertical x^2*g
  }
  __syncthreads();

  const int x = x0 + tx;
  for (int r = ty; r < TILE_H; r += THREADS_Y) {
    const int y = y0 + r;
    if (y >= H || x >= W) continue;
    float v0 = s_v[0][r][tx], v1 = s_v[1][r][tx], v2 = s_v[2][r][tx];
    float bc = v0 * s_taps[0][0];
    float bx = v0 * s_taps[1][0];
    float bxx = v0 * s_taps[2][0];
    float by = v1 * s_taps[0][0];
    float bxy = v1 * s_taps[1][0];
    float byy = v2 * s_taps[0][0];
    for (int k = 1; k < T; ++k) {
      v0 = s_v[0][r][tx + k];
      v1 = s_v[1][r][tx + k];
      v2 = s_v[2][r][tx + k];
      bc = bc + v0 * s_taps[0][k];
      bx = bx + v0 * s_taps[1][k];
      bxx = bxx + v0 * s_taps[2][k];
      by = by + v1 * s_taps[0][k];
      bxy = bxy + v1 * s_taps[1][k];
      byy = byy + v2 * s_taps[0][k];
    }
    float* o = out + (size_t)b * 5 * plane + (size_t)y * W + x;
    o[0] = bx * tp.ig11;
    o[plane] = by * tp.ig11;
    o[2 * plane] = bc * tp.ig03 + bxx * tp.ig33;
    o[3 * plane] = bc * tp.ig03 + byy * tp.ig33;
    o[4 * plane] = bxy * tp.ig55;
  }
}

// img [B,H,W] f32, out [B,5,H,W] f32 (device); taps = g, xg, xxg, each
// 2n+1 floats, and ig = ig11, ig03, ig33, ig55 (host memory, copied into
// the launch's arguments). Returns the launch's cudaError_t.
extern "C" int ff_poly_exp(const float* img, float* out, int B, int H, int W,
                           int n, const float* taps, const float* ig,
                           void* stream) {
  if (n < 1 || n > MAX_N || B < 1 || B > 65535 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  PolyTaps tp;
  const int T = 2 * n + 1;
  for (int i = 0; i < MAX_T; ++i) {
    tp.g[i] = i < T ? taps[i] : 0.f;
    tp.xg[i] = i < T ? taps[T + i] : 0.f;
    tp.xxg[i] = i < T ? taps[2 * T + i] : 0.f;
  }
  tp.ig11 = ig[0];
  tp.ig03 = ig[1];
  tp.ig33 = ig[2];
  tp.ig55 = ig[3];
  tp.n = n;
  dim3 block(TILE_W, THREADS_Y);
  dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H, B);
  poly_exp_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(img, out, H, W, tp);
  return (int)cudaGetLastError();
}
