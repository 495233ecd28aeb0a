// Batched nadir-camera render for Hopper (sm_90a): one anti-aliased image
// per env of a bordered checkerboard marker over sin/cos ground shading,
// times a brightness, clipped to [0, 1].
//
// Replaces the TPU kernel `ops/render_kernel.py:render_nadir_batch_pallas`
// of the JAX package (Pallas body `_render_kernel`); computes what the
// port's `render/scene.py:render_nadir` computes, written straight into the
// port's NCHW image layout (B, 3, H, W).
//
// Design. Every pixel is independent and needs only its env's six scalars
// (camera x, y, height, brightness; marker x, y), so one thread computes one
// pixel: the grid is (ceil(H*W / 256), B), block y being the env. The TPU
// kernel's one-program-per-env grid over (84, 3)-blocked VMEM tiles has no
// counterpart here. Each thread reads its env's scalars (every thread of a
// block the same ones, served from L1) and writes three floats, one to
// each channel plane; neighbouring threads write neighbouring pixels, so
// every store of a warp is one coalesced 128-byte line.
//
// Bound. The kernel reads 6 floats per env and writes B*H*W*3 floats: at
// B = 100, 84x84, that is 8.47 MB, 2.5 us at 3.35 TB/s. The arithmetic is a
// few dozen flops and three sin/cos per pixel, below that bound; at B = 100
// the launch itself sets the pace.
//
// Precision. Precise sinf/cosf/floorf and IEEE division (no fast math).
// The cell parity is c - 2*floor(c/2), a floor-mod like the plain
// version's `torch.remainder`: fmodf would give -1 on negative cells. The
// image is continuous in the pose (the smooth steps blend across every
// edge), so FMA contraction moves pixels by a little and flips none.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;
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

__global__ void __launch_bounds__(THREADS)
render_nadir_kernel(const float* __restrict__ quad, const float* __restrict__ marker,
                    const float* __restrict__ brightness, float* __restrict__ out,
                    Geometry g) {
  const int hw = g.H * g.W;
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= hw) return;
  const int env = blockIdx.y;
  const float u = (float)(p % g.W);
  const float v = (float)(p / g.W);

  const float cam_x = quad[3 * env + 0];
  const float cam_y = quad[3 * env + 1];
  const float height = fmaxf(quad[3 * env + 2] - g.ground_z, 1e-3f);
  const float bright = brightness ? brightness[env] : 1.f;
  const float mx = marker[2 * env + 0];
  const float my = marker[2 * env + 1];

  // Nadir ray meets the ground plane at t = height:
  // world = cam + height * ((u - cx)/fx, -(v - cy)/fy, -1).
  const float x_w = cam_x + (u - g.cx) / g.fx * height;
  const float y_w = cam_y - (v - g.cy) / g.fy * height;
  const float soft = fmaxf(height / g.fx, 1e-6f);  // pixel footprint

  const float rel_x = x_w - mx;
  const float rel_y = y_w - my;
  const float px = square_wave(rel_x + g.half_w, g.square, soft);
  const float py = square_wave(rel_y + g.half_h, g.square, soft);
  const float checker = px * (1.f - py) + py * (1.f - px);
  const float val = DARK + (LIGHT - DARK) * checker;

  const float ax = fabsf(rel_x), ay = fabsf(rel_y);
  const float on_board = clip01((g.half_w - ax) / soft + 0.5f) *
                         clip01((g.half_h - ay) / soft + 0.5f);
  const float coverage = clip01((g.half_w + g.square - ax) / soft + 0.5f) *
                         clip01((g.half_h + g.square - ay) / soft + 0.5f);
  const float wave = 0.06f * sinf(x_w * 1.7f) * cosf(y_w * 1.3f) +
                     0.04f * sinf(x_w * 5.1f + y_w * 3.7f);
  const float board = val * on_board + BORDER * (1.f - on_board);

  float* img = out + (size_t)env * 3 * hw + p;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float ground = clip01(GROUND[c] + wave);
    const float rgb = board * coverage + ground * (1.f - coverage);
    img[(size_t)c * hw] = clip01(rgb * bright);
  }
}

}  // namespace

extern "C" {

// Launches the render on `stream` and returns cudaGetLastError(): a launch
// the card refuses never runs and is reported only here. `brightness` may
// be null (brightness 1).
int render_nadir(const float* quad, const float* marker, const float* brightness, float* out,
                 int B, int H, int W, float fx, float fy, float cx, float cy, float square,
                 float half_w, float half_h, float ground_z, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return 0;
  Geometry g{H, W, fx, fy, cx, cy, square, half_w, half_h, ground_z};
  const dim3 grid((H * W + THREADS - 1) / THREADS, B);
  render_nadir_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      quad, marker, brightness, out, g);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of the kernel in bytes (none).
int render_nadir_smem_bytes() { return 0; }

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
