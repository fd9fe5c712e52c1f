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
// What bounds it: memory. It must read u, v (8 B) and the 5 planes (20 B)
// and write 5 planes (20 B) per pixel, about 48 B; flow is smooth, so the
// 4 corner reads of neighbouring threads fall on the same or adjacent rows
// and are served from L1/L2. Design: a direct gather, one thread per
// output pixel; the displacement and weights are computed once and shared
// by the 5 planes. The TPU kernel's band/piece decomposition, its row
// padding and its shifted Rx copy existed only for Mosaic's single-tile
// gather and are gone: the kernel reads the plain stacked planes.
//
// Numerics: the same expression order as the plain twin, built with
// --fmad=false, so each product and sum is rounded as there.

#include <cuda_runtime.h>

__global__ void __launch_bounds__(256)
warp_bilinear_kernel(const float* __restrict__ R, const float* __restrict__ u,
                     const float* __restrict__ v, float* __restrict__ out,
                     int B, int P, int H, int W) {
  const size_t plane = (size_t)H * W;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * plane) return;
  const int b = (int)(idx / plane);
  const size_t pix = idx - (size_t)b * plane;
  const int y = (int)(pix / W);
  const int x = (int)(pix - (size_t)y * W);

  const float fx = (float)x + u[idx];
  const float fy = (float)y + v[idx];
  const float xf = floorf(fx);
  const float yf = floorf(fy);
  const float wx = fx - xf;
  const float wy = fy - yf;
  const float omx = 1.f - wx;
  const float omy = 1.f - wy;
  // clamp in float, then convert: equal to clip(int(floor)) for any finite
  // coordinate and safe for ones beyond the int range
  const int x0c = (int)fminf(fmaxf(xf, 0.f), (float)(W - 1));
  const int y0c = (int)fminf(fmaxf(yf, 0.f), (float)(H - 1));
  const int x1c = min(x0c + 1, W - 1);
  const int y1c = min(y0c + 1, H - 1);
  const size_t i00 = (size_t)y0c * W + x0c, i01 = (size_t)y0c * W + x1c;
  const size_t i10 = (size_t)y1c * W + x0c, i11 = (size_t)y1c * W + x1c;

  const float* src = R + (size_t)b * P * plane;
  float* dst = out + (size_t)b * P * plane + pix;
  for (int p = 0; p < P; ++p) {
    const float* s = src + (size_t)p * plane;
    const float top = s[i00] * omx + s[i01] * wx;
    const float bot = s[i10] * omx + s[i11] * wx;
    dst[(size_t)p * plane] = top * omy + bot * wy;
  }
}

// R [B,P,H,W], u/v [B,H,W], out [B,P,H,W], all f32 on the device.
// Returns the launch's cudaError_t. Serves two entry points: K2
// (warp_bilinear, P=5 Farnebäck planes) and K5 (warp_planes, P=3 DIS
// planes I1, I1x, I1y; replaces warp_planes_padded in
// funscript_flow_tpu/ops/pallas/warp.py, whose W padding to 128 lanes
// existed only for Mosaic).
extern "C" int ff_warp_bilinear(const float* R, const float* u, const float* v,
                                float* out, int B, int P, int H, int W,
                                void* stream) {
  if (B < 1 || P < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const size_t total = (size_t)B * H * W;
  const int threads = 256;
  const size_t blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  warp_bilinear_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      R, u, v, out, B, P, H, W);
  return (int)cudaGetLastError();
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
