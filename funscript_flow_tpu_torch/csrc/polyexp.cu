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
// What bounds it on this card: it must read 4 B and write 20 B per pixel
// (0.118 ms at 256 px, B=252), and do 198 multiplies and adds per pixel at
// n=5. Built with --fmad=false (the twin's roundings), each is an
// instruction of its own, so the arithmetic alone takes about 0.1 ms: the
// kernel is close to balanced, and every load, index or shared-memory
// instruction beside the arithmetic takes slots the sums need.
//
// Design: one block of 256 threads per (image, 64 x 32 output tile); the
// tap count is a template parameter (n = 1..8), so every tap loop unrolls
// and each tap is a constant operand of its multiply (a kernel parameter),
// with no load per tap.
// - Vertical pass from registers: a thread walks one of the tile's
//   64 + 2n haloed columns down from device memory (a warp reads 32
//   adjacent columns of a row: one coalesced load), holds the 8 + 2n values
//   that 8 output rows need in registers and sums each row's taps in order
//   for the three vertical filters. Warp w takes columns 32*(w&1).. of the
//   tile and rows 8*(w>>1)..; the 2n halo columns of the four row segments
//   go to the first threads after that. The three column sums are written
//   to shared memory once, [3][32][64 + 2n rounded up to 4].
// - One barrier, then the horizontal pass with register blocking: a thread
//   takes 4 adjacent outputs of a row and reads the 4 + 2n column sums they
//   need as float4 (conflict-free), once per vertical filter (instead of
//   2n + 1 loads per output), and sums each output's taps in order. The six
//   horizontal sums of its 4 outputs stay in registers through the combine;
//   the five planes are written as float4 where the row allows it.
// - The 64-column tile puts the vertical halo overhead at (64+2n)/64, 1.16x
//   at n=5 (a 32-column tile: 1.31x). MIN_BLOCKS caps the registers at 64
//   (no spills) so that four blocks share an SM and one block's loads
//   overlap the others' sums; with three blocks (76 registers) the kernel
//   took about 6% longer at 256 px.
// It runs at every pyramid level (32 px wide included) and any H and W,
// W < 2n+1 included (the replicate border is a clamped index).
//
// Numerics: every tap is summed in the plain twin's order (tap 0 first,
// products rounded before each add; the library is built with
// --fmad=false), so the kernel repeats the twin's roundings bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_N = 8;
constexpr int MAX_T = 2 * MAX_N + 1;
constexpr int TW = 64;                  // output tile width
constexpr int TH = 32;                  // output tile height
constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 4;           // resident blocks per SM: <= 64 regs
constexpr int SEG = 8;                  // output rows per vertical task
constexpr int NSEG = TH / SEG;          // row segments of the tile
constexpr int QUADS = TW / 4;           // 4-wide output groups per row
constexpr int QROWS = THREADS / QUADS;  // rows per horizontal step
static_assert((TW / 32) * NSEG == THREADS / 32,
              "one warp per (32-column chunk, row segment)");
static_assert(TH % QROWS == 0, "tile height must be a multiple of QROWS");

struct PolyTaps {
  float g[MAX_T];
  float xg[MAX_T];
  float xxg[MAX_T];
  float ig11, ig03, ig33, ig55;
};

template <int N>
struct Geometry {
  static constexpr int T = 2 * N + 1;
  static constexpr int NC = TW + 2 * N;          // haloed columns
  static constexpr int NCP = (NC + 3) / 4 * 4;   // row stride, float4 aligned
  static constexpr int NV4 = (4 + 2 * N + 3) / 4;  // float4 reads per quad
};

// The three vertical sums of haloed column c (source column x0 - N + c,
// clamped) for the SEG output rows of segment seg, into s_v.
template <int N>
__device__ __forceinline__ void vertical(const float* __restrict__ src,
                                         float (*s_v)[TH][Geometry<N>::NCP],
                                         const PolyTaps& tp, int H, int W,
                                         int x0, int y0, int c, int seg) {
  const float* p = src + min(max(x0 - N + c, 0), W - 1);
  const int r0 = y0 + seg * SEG - N;
  float col[SEG + 2 * N];
#pragma unroll
  for (int j = 0; j < SEG + 2 * N; ++j)
    col[j] = p[min(max(r0 + j, 0), H - 1) * W];
#pragma unroll
  for (int i = 0; i < SEG; ++i) {
    float a0 = col[i] * tp.g[0];
    float a1 = col[i] * tp.xg[0];
    float a2 = col[i] * tp.xxg[0];
#pragma unroll
    for (int k = 1; k < Geometry<N>::T; ++k) {
      a0 = a0 + col[i + k] * tp.g[k];
      a1 = a1 + col[i + k] * tp.xg[k];
      a2 = a2 + col[i + k] * tp.xxg[k];
    }
    s_v[0][seg * SEG + i][c] = a0;  // vertical g
    s_v[1][seg * SEG + i][c] = a1;  // vertical x*g
    s_v[2][seg * SEG + i][c] = a2;  // vertical x^2*g
  }
}

// The 4 + 2n column sums of one row that a quad's 4 outputs need.
template <int N>
__device__ __forceinline__ void load_row(const float* row,
                                         float (&w)[4 * Geometry<N>::NV4]) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int k = 0; k < Geometry<N>::NV4; ++k) {
    const float4 t = r4[k];
    w[4 * k] = t.x;
    w[4 * k + 1] = t.y;
    w[4 * k + 2] = t.z;
    w[4 * k + 3] = t.w;
  }
}

// acc[o] = sum over taps k of w[o + k] * taps[k], tap 0 first.
template <int N>
__device__ __forceinline__ void hsum(const float (&w)[4 * Geometry<N>::NV4],
                                     const float (&taps)[MAX_T],
                                     float (&acc)[4]) {
#pragma unroll
  for (int o = 0; o < 4; ++o) {
    float a = w[o] * taps[0];
#pragma unroll
    for (int k = 1; k < Geometry<N>::T; ++k) a = a + w[o + k] * taps[k];
    acc[o] = a;
  }
}

template <int N>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
poly_exp_kernel(const float* __restrict__ img, float* __restrict__ out,
                int H, int W, int vec, PolyTaps tp) {
  using G = Geometry<N>;
  __shared__ __align__(16) float s_v[3][TH][G::NCP];

  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int plane = H * W;
  const float* src = img + (size_t)blockIdx.z * plane;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // vertical pass: the main columns, one warp per (chunk, segment), then
  // the halo columns
  vertical<N>(src, s_v, tp, H, W, x0, y0, N + 32 * (warp & 1) + lane,
              warp >> 1);
  if (tid < 2 * N * NSEG) {
    const int hc = tid % (2 * N);
    vertical<N>(src, s_v, tp, H, W, x0, y0, hc < N ? hc : TW + hc,
                tid / (2 * N));
  }
  __syncthreads();

  // horizontal pass + combine: 4 adjacent outputs of one row per thread
  const int qx = tid % QUADS;
  const int x = x0 + 4 * qx;
  float* ob = out + (size_t)blockIdx.z * 5 * plane;
#pragma unroll
  for (int step = 0; step < TH / QROWS; ++step) {
    const int i = tid / QUADS + step * QROWS;
    const int y = y0 + i;
    if (y >= H || x >= W) continue;
    float w[4 * G::NV4];
    float bc[4], bx[4], bxx[4], by[4], bxy[4], byy[4];
    load_row<N>(&s_v[0][i][4 * qx], w);  // vertical g
    hsum<N>(w, tp.g, bc);
    hsum<N>(w, tp.xg, bx);
    hsum<N>(w, tp.xxg, bxx);
    load_row<N>(&s_v[1][i][4 * qx], w);  // vertical x*g
    hsum<N>(w, tp.g, by);
    hsum<N>(w, tp.xg, bxy);
    load_row<N>(&s_v[2][i][4 * qx], w);  // vertical x^2*g
    hsum<N>(w, tp.g, byy);
    float r[5][4];
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      const float c03 = bc[o] * tp.ig03;
      r[0][o] = bx[o] * tp.ig11;
      r[1][o] = by[o] * tp.ig11;
      r[2][o] = c03 + bxx[o] * tp.ig33;
      r[3][o] = c03 + byy[o] * tp.ig33;
      r[4][o] = bxy[o] * tp.ig55;
    }
    float* o0 = ob + y * W + x;
    if (vec && x + 3 < W) {
#pragma unroll
      for (int p = 0; p < 5; ++p)
        *reinterpret_cast<float4*>(o0 + (size_t)p * plane) =
            make_float4(r[p][0], r[p][1], r[p][2], r[p][3]);
    } else {
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        if (x + o < W) {
#pragma unroll
          for (int p = 0; p < 5; ++p) o0[(size_t)p * plane + o] = r[p][o];
        }
      }
    }
  }
}

template <int N>
int launch(const float* img, float* out, int B, int H, int W, int vec,
           const PolyTaps& tp, cudaStream_t stream) {
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  poly_exp_kernel<N><<<grid, THREADS, 0, stream>>>(img, out, H, W, vec, tp);
  return (int)cudaGetLastError();
}

using LaunchFn = int (*)(const float*, float*, int, int, int, int,
                         const PolyTaps&, cudaStream_t);
const LaunchFn kLaunch[MAX_N + 1] = {nullptr,   launch<1>, launch<2>,
                                     launch<3>, launch<4>, launch<5>,
                                     launch<6>, launch<7>, launch<8>};

}  // namespace

// img [B,H,W] f32, out [B,5,H,W] f32 (device); taps = g, xg, xxg, each
// 2n+1 floats, and ig = ig11, ig03, ig33, ig55 (host memory, copied into
// the launch's arguments). Returns the launch's cudaError_t.
extern "C" int ff_poly_exp(const float* img, float* out, int B, int H, int W,
                           int n, const float* taps, const float* ig,
                           void* stream) {
  if (n < 1 || n > MAX_N || B < 1 || B > 65535 || H < 1 || W < 1 ||
      (long long)H * W > 0x7fffffff)
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
  // float4 stores: rows of whole float4s on a 16-byte base
  const int vec = W % 4 == 0 && (uintptr_t)out % 16 == 0;
  return kLaunch[n](img, out, B, H, W, vec, tp, (cudaStream_t)stream);
}
