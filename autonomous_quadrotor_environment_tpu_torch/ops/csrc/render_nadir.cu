// Batched nadir-camera render for Hopper (sm_90a): one anti-aliased image
// per env of a bordered checkerboard marker over sin/cos ground shading,
// times a brightness, clipped to [0, 1].
//
// Replaces the TPU kernel `ops/render_kernel.py:render_nadir_batch_pallas`
// of the JAX package (Pallas body `_render_kernel`); computes what the
// port's `render/scene.py:render_nadir` computes, written straight into the
// port's NCHW image layout (B, 3, H, W).
//
// Bound. The kernel reads 6 floats per env and writes B*H*W*3 floats: at
// B = 100, 84x84, that is 8.47 MB, 2.5 us at 3.35 TB/s; at B = 4096 347 MB,
// 0.104 ms. The arithmetic per pixel is a few dozen flops and one sinf.
//
// Design. The nadir ray of pixel (u, v) meets the ground at x_w(u), y_w(v):
// the hit point's x depends only on the column and its y only on the row,
// and so do the square waves, the board and coverage edges and the slow
// sin/cos of the ground shading. Only the checker, the products of the
// factors, the ground's mixed sinf(x_w * 5.1 + y_w * 3.7) and the channels
// mix the two. So a CTA owns one band of BAND_ROWS rows of one image (grid:
// bands x column spans x B; one span up to SPAN columns, so any width): it
// first computes each of its columns' terms (x_w, its square wave, board
// and coverage factors, sinf(x_w * 1.7)) into dynamic shared memory (20
// bytes a column: 9.6 KB at 480) and each of its rows' terms (y_w, the same
// for y, cosf(y_w * 1.3)) into static shared memory, each with exactly the
// expression of the per-pixel formula, then each thread forms four
// neighbouring pixels of a row from them and stores them as one float4 per
// channel (a row of 84 floats is 336 bytes, a channel plane 28,224: both
// multiples of 16); a width that is not a multiple of 4 takes one pixel
// and scalar stores at a time. The pixels are the per-pixel formula's, with
// the same operations in the same order.
//
// Precision. Precise sinf/cosf/floorf and IEEE division (no fast math).
// The cell parity is c - 2*floor(c/2), a floor-mod like the plain
// version's `torch.remainder`: fmodf would give -1 on negative cells. The
// image is continuous in the pose (the smooth steps blend across every
// edge), so FMA contraction moves pixels by a little and flips none.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 128;
constexpr int BAND_ROWS = 21;  // rows per CTA: 84 = 4 bands
constexpr int SPAN = 2048;     // columns per CTA at most: 40 KB of column terms
constexpr float DARK = 0.05f, LIGHT = 0.95f, BORDER = 0.9f;
__constant__ float GROUND[3] = {0.35f, 0.42f, 0.32f};

struct Geometry {
  int H, W;
  float fx, fy, cx, cy;
  float square;          // checker square side (world units)
  float half_w, half_h;  // half extents of the checker area
  float ground_z;        // env-frame ground height
};

__device__ __forceinline__ float clip01(float v) { return fminf(fmaxf(v, 0.f), 1.f); }

// Anti-aliased alternating 0/1 pattern of cell size s; soft > 0.
__device__ __forceinline__ float square_wave(float x, float s, float soft) {
  const float t = x / s;
  const float cell = floorf(t);
  const float parity = cell - 2.f * floorf(cell / 2.f);
  const float frac = t - cell;
  const float dist = fminf(frac, 1.f - frac) * s;
  const float w = clip01(0.5f + (dist / soft) * 0.5f);
  return parity * w + (1.f - parity) * (1.f - w);
}

// The terms of one axis at hit coordinate x_w (marker at m, half extent
// half): the square wave, the board factor, the coverage factor.
struct AxisTerms {
  float wave, board, cover;
};

__device__ __forceinline__ AxisTerms axis_terms(float x_w, float m, float half, float square,
                                                float soft) {
  const float rel = x_w - m;
  const float a = fabsf(rel);
  return {square_wave(rel + half, square, soft), clip01((half - a) / soft + 0.5f),
          clip01((half + square - a) / soft + 0.5f)};
}

// The row terms of a band, in static shared memory.
struct Rows {
  float y[BAND_ROWS], py[BAND_ROWS], by[BAND_ROWS], cy[BAND_ROWS], cyw[BAND_ROWS];
};

// One column's terms.
struct Col {
  float x, px, bx, cx, sx;
};

// Pixel (column terms c, band row i): its three channels.
__device__ __forceinline__ void pixel(const Col& c, const Rows& tm, int i, float bright,
                                      float (&rgb)[3]) {
  const float px = c.px, py = tm.py[i];
  const float checker = px * (1.f - py) + py * (1.f - px);
  const float val = DARK + (LIGHT - DARK) * checker;
  const float on_board = c.bx * tm.by[i];
  const float coverage = c.cx * tm.cy[i];
  const float wave = 0.06f * c.sx * tm.cyw[i] + 0.04f * sinf(c.x * 5.1f + tm.y[i] * 3.7f);
  const float board = val * on_board + BORDER * (1.f - on_board);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float ground = clip01(GROUND[ch] + wave);
    const float v = board * coverage + ground * (1.f - coverage);
    rgb[ch] = clip01(v * bright);
  }
}

// The column span a CTA holds, rounded up to 4 (each of its 5 arrays of
// column terms starts 16-byte aligned, so four neighbouring columns load as
// one float4 each).
__host__ __device__ __forceinline__ int span_floats(int W) {
  return ((W < SPAN ? W : SPAN) + 3) & ~3;
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__global__ void __launch_bounds__(THREADS)
render_nadir_kernel(const float* __restrict__ quad, const float* __restrict__ marker,
                    const float* __restrict__ brightness, float* __restrict__ out,
                    Geometry g) {
  extern __shared__ float4 cols4[];
  __shared__ Rows tm;
  const int sw = span_floats(g.W);
  float* const cx_w = reinterpret_cast<float*>(cols4);  // x_w, px, bx, cx, sx: [5][sw]
  float* const cpx = cx_w + sw;
  float* const cbx = cpx + sw;
  float* const ccx = cbx + sw;
  float* const csx = ccx + sw;
  const int env = blockIdx.z, v0 = blockIdx.x * BAND_ROWS, u0 = blockIdx.y * SPAN;
  const int rows = min(BAND_ROWS, g.H - v0), w = min(SPAN, g.W - u0);
  const float cam_x = quad[3 * env + 0];
  const float cam_y = quad[3 * env + 1];
  const float height = fmaxf(quad[3 * env + 2] - g.ground_z, 1e-3f);
  const float bright = brightness ? brightness[env] : 1.f;
  const float mx = marker[2 * env + 0];
  const float my = marker[2 * env + 1];
  const float soft = fmaxf(height / g.fx, 1e-6f);  // pixel footprint

  // Nadir ray meets the ground plane at t = height:
  // world = cam + height * ((u - cx)/fx, -(v - cy)/fy, -1).
  for (int k = threadIdx.x; k < w + rows; k += THREADS) {
    if (k < w) {
      const float x_w = cam_x + ((float)(u0 + k) - g.cx) / g.fx * height;
      const AxisTerms a = axis_terms(x_w, mx, g.half_w, g.square, soft);
      cx_w[k] = x_w;
      cpx[k] = a.wave;
      cbx[k] = a.board;
      ccx[k] = a.cover;
      csx[k] = sinf(x_w * 1.7f);
    } else {
      const int i = k - w;
      const float y_w = cam_y - ((float)(v0 + i) - g.cy) / g.fy * height;
      const AxisTerms a = axis_terms(y_w, my, g.half_h, g.square, soft);
      tm.y[i] = y_w;
      tm.py[i] = a.wave;
      tm.by[i] = a.board;
      tm.cy[i] = a.cover;
      tm.cyw[i] = cosf(y_w * 1.3f);
    }
  }
  __syncthreads();

  const size_t hw = (size_t)g.H * g.W;
  float* img = out + (size_t)env * 3 * hw + (size_t)v0 * g.W + u0;
  if ((g.W & 3) == 0) {
    const int quads = w / 4;
    for (int k = threadIdx.x; k < rows * quads; k += THREADS) {
      const int i = k / quads, u = 4 * (k % quads);
      const float4 x = lds4(cx_w + u), px = lds4(cpx + u), bx = lds4(cbx + u),
                   cx = lds4(ccx + u), sx = lds4(csx + u);
      const Col cols[4] = {{x.x, px.x, bx.x, cx.x, sx.x}, {x.y, px.y, bx.y, cx.y, sx.y},
                           {x.z, px.z, bx.z, cx.z, sx.z}, {x.w, px.w, bx.w, cx.w, sx.w}};
      float p[4][3];
#pragma unroll
      for (int j = 0; j < 4; ++j) pixel(cols[j], tm, i, bright, p[j]);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        *reinterpret_cast<float4*>(img + c * hw + (size_t)i * g.W + u) =
            make_float4(p[0][c], p[1][c], p[2][c], p[3][c]);
    }
  } else {
    for (int k = threadIdx.x; k < rows * w; k += THREADS) {
      const int i = k / w, u = k % w;
      const Col col{cx_w[u], cpx[u], cbx[u], ccx[u], csx[u]};
      float p[3];
      pixel(col, tm, i, bright, p);
#pragma unroll
      for (int c = 0; c < 3; ++c) img[c * hw + (size_t)i * g.W + u] = p[c];
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of the kernel in bytes at image width W: the
// column terms of a span (the row terms are static).
int render_nadir_smem_bytes(int W) { return 5 * span_floats(W) * (int)sizeof(float); }

// Launches the render on `stream` and returns cudaGetLastError(): a launch
// the card refuses never runs and is reported only here. `brightness` may
// be null (brightness 1); any H and W, B up to 65,535 (the grid's z).
int render_nadir(const float* quad, const float* marker, const float* brightness, float* out,
                 int B, int H, int W, float fx, float fy, float cx, float cy, float square,
                 float half_w, float half_h, float ground_z, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || H == 0 || W == 0) return 0;
  Geometry g{H, W, fx, fy, cx, cy, square, half_w, half_h, ground_z};
  const dim3 grid((H + BAND_ROWS - 1) / BAND_ROWS, (W + SPAN - 1) / SPAN, B);
  render_nadir_kernel<<<grid, THREADS, render_nadir_smem_bytes(W),
                        static_cast<cudaStream_t>(stream)>>>(quad, marker, brightness, out, g);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
