// Host-side chase-camera preview renderer.
//
// Native equivalent of the reference's Panda3D human-viewing path
// (reference: models/world_setup.py:5-99, models/camera_control.py:3-127,
// visual_landing/ppo_world_setup.py:70-103): the training loop renders
// its own observations on-device (render/), but humans watching a flight
// (manual flight, eval replays) need a host renderer with a free camera.
// This is a dependency-free C++ rasterizer: ground grid + checkerboard
// marker + quadrotor cross with props, painter's-algorithm over a pinhole
// chase camera, RGB8 output buffer consumed from Python via ctypes
// (native/__init__.py), dumped as PPM/PNG or streamed to a viewer.
//
// Built at first use by native/__init__.py (g++ -O3 -fPIC -shared -std=c++17)
// into the package's build/ directory.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>

namespace {

struct Vec3 {
  double x, y, z;
};

Vec3 sub(Vec3 a, Vec3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
Vec3 cross(Vec3 a, Vec3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
double dot(Vec3 a, Vec3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
Vec3 norm(Vec3 a) {
  double n = std::sqrt(dot(a, a));
  if (n < 1e-12) return {0, 0, 1};
  return {a.x / n, a.y / n, a.z / n};
}

struct Camera {
  Vec3 pos;
  // world->camera rotation rows (right, down, forward)
  Vec3 r0, r1, r2;
  double fx, fy, cx, cy;
  int w, h;
};

// Build a look-at chase camera (film 36x24, f=45 like the reference chase
// cam, ppo_world_setup.py:92).
Camera make_camera(Vec3 pos, Vec3 target, int w, int h) {
  Camera c;
  c.pos = pos;
  Vec3 fwd = norm(sub(target, pos));
  Vec3 up{0, 0, 1};
  Vec3 right = norm(cross(fwd, up));
  Vec3 down = cross(fwd, right);  // right-handed: y_cam points "down"
  c.r0 = right;
  c.r1 = down;
  c.r2 = fwd;
  c.fx = 45.0 / 36.0 * w;
  c.fy = 45.0 / 24.0 * h;
  c.cx = (w - 1) / 2.0;
  c.cy = (h - 1) / 2.0;
  c.w = w;
  c.h = h;
  return c;
}

bool project(const Camera& c, Vec3 p, double* u, double* v, double* depth) {
  Vec3 d = sub(p, c.pos);
  double zc = dot(c.r2, d);
  if (zc < 1e-3) return false;
  *u = c.fx * dot(c.r0, d) / zc + c.cx;
  *v = c.fy * dot(c.r1, d) / zc + c.cy;
  *depth = zc;
  return true;
}

void put_pixel(uint8_t* img, const Camera& c, int x, int y, uint8_t r,
               uint8_t g, uint8_t b) {
  if (x < 0 || y < 0 || x >= c.w || y >= c.h) return;
  uint8_t* p = img + 3 * (y * c.w + x);
  p[0] = r;
  p[1] = g;
  p[2] = b;
}

void draw_line(uint8_t* img, const Camera& c, Vec3 a, Vec3 b, uint8_t r,
               uint8_t g, uint8_t bl, int thickness = 1) {
  double u0, v0, u1, v1, d0, d1;
  if (!project(c, a, &u0, &v0, &d0) || !project(c, b, &u1, &v1, &d1)) return;
  double len = std::max(std::abs(u1 - u0), std::abs(v1 - v0));
  int steps = std::max(2, (int)len + 1);
  for (int i = 0; i <= steps; ++i) {
    double t = (double)i / steps;
    int x = (int)std::lround(u0 + (u1 - u0) * t);
    int y = (int)std::lround(v0 + (v1 - v0) * t);
    for (int dy = 0; dy < thickness; ++dy)
      for (int dx = 0; dx < thickness; ++dx)
        put_pixel(img, c, x + dx, y + dy, r, g, bl);
  }
}

// Quaternion (w,x,y,z) -> body-to-world rotation applied to v.
Vec3 quat_rot(const double* q, Vec3 v) {
  double w = q[0], x = q[1], y = q[2], z = q[3];
  Vec3 u{x, y, z};
  Vec3 t = cross(u, v);
  t = {t.x * 2, t.y * 2, t.z * 2};
  Vec3 wt{w * t.x, w * t.y, w * t.z};
  Vec3 ut = cross(u, t);
  return {v.x + wt.x + ut.x, v.y + wt.y + ut.y, v.z + wt.z + ut.z};
}

}  // namespace

extern "C" {

// Render one chase-cam frame.
//   quad_state: 13 doubles [x,vx,y,vy,z,vz,q0,q1,q2,q3,wx,wy,wz] (env frame,
//               ground at z=-5 like the landing task)
//   marker_xy:  2 doubles
//   cam_offset: 3 doubles, camera position relative to the quad (world)
//   img:        out, h*w*3 uint8 (RGB)
void render_preview(const double* quad_state, const double* marker_xy,
                    const double* cam_offset, int w, int h, uint8_t* img) {
  Vec3 quad{quad_state[0], quad_state[2], quad_state[4] + 5.0};  // world z
  Vec3 cam_pos{quad.x + cam_offset[0], quad.y + cam_offset[1],
               quad.z + cam_offset[2]};
  Camera cam = make_camera(cam_pos, quad, w, h);

  // Sky.
  for (int i = 0; i < w * h; ++i) {
    img[3 * i + 0] = 140;
    img[3 * i + 1] = 166;
    img[3 * i + 2] = 204;
  }

  // Ground plane z=0: per-pixel ray cast (matches the on-device renderer's
  // scene: muted ground + checkerboard marker).
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      // camera-frame ray through the pixel
      double rx = (x - cam.cx) / cam.fx;
      double ry = (y - cam.cy) / cam.fy;
      Vec3 dir{cam.r0.x * rx + cam.r1.x * ry + cam.r2.x,
               cam.r0.y * rx + cam.r1.y * ry + cam.r2.y,
               cam.r0.z * rx + cam.r1.z * ry + cam.r2.z};
      if (dir.z > -1e-6) continue;  // looking up: keep sky
      double t = -cam_pos.z / dir.z;
      double gx = cam_pos.x + t * dir.x;
      double gy = cam_pos.y + t * dir.y;

      // checkerboard marker (10x7 squares of 0.1023 m + border)
      double s = 0.5 * 0.2046;
      double half_w_b = 10 * s / 2.0, half_h_b = 7 * s / 2.0;
      double relx = gx - marker_xy[0], rely = gy - marker_xy[1];
      uint8_t r, g, b;
      if (std::abs(relx) < half_w_b + s && std::abs(rely) < half_h_b + s) {
        if (std::abs(relx) < half_w_b && std::abs(rely) < half_h_b) {
          int ix = (int)std::floor((relx + half_w_b) / s);
          int iy = (int)std::floor((rely + half_h_b) / s);
          bool dark = ((ix + iy) & 1) == 0;
          r = g = b = dark ? 13 : 242;
        } else {
          r = g = b = 230;  // border
        }
      } else {
        // ground shading wave (same formula family as render/scene.py)
        double wave = 0.06 * std::sin(gx * 1.7) * std::cos(gy * 1.3) +
                      0.04 * std::sin(gx * 5.1 + gy * 3.7);
        r = (uint8_t)std::clamp((0.35 + wave) * 255.0, 0.0, 255.0);
        g = (uint8_t)std::clamp((0.42 + wave) * 255.0, 0.0, 255.0);
        b = (uint8_t)std::clamp((0.32 + wave) * 255.0, 0.0, 255.0);
      }
      // distance fade
      double fade = std::min(1.0, 30.0 / (t + 1e-9));
      put_pixel(img, cam, x, y, (uint8_t)(r * fade), (uint8_t)(g * fade),
                (uint8_t)(b * fade));
    }
  }

  // Quadrotor: two arms (body x/y axes, 0.26 m) + prop circles.
  const double* q = quad_state + 6;
  Vec3 arm1 = quat_rot(q, {0.26, 0, 0});
  Vec3 arm2 = quat_rot(q, {0, 0.26, 0});
  Vec3 tips[4] = {
      {quad.x + arm1.x, quad.y + arm1.y, quad.z + arm1.z},
      {quad.x - arm1.x, quad.y - arm1.y, quad.z - arm1.z},
      {quad.x + arm2.x, quad.y + arm2.y, quad.z + arm2.z},
      {quad.x - arm2.x, quad.y - arm2.y, quad.z - arm2.z},
  };
  draw_line(img, cam, tips[0], tips[1], 30, 30, 30, 2);
  draw_line(img, cam, tips[2], tips[3], 200, 40, 40, 2);
  for (auto& tip : tips) {
    // small prop disc: 8-segment circle in the body plane
    Vec3 px = quat_rot(q, {0.09, 0, 0});
    Vec3 py = quat_rot(q, {0, 0.09, 0});
    for (int k = 0; k < 8; ++k) {
      double a0 = 2 * M_PI * k / 8, a1 = 2 * M_PI * (k + 1) / 8;
      Vec3 p0{tip.x + px.x * std::cos(a0) + py.x * std::sin(a0),
              tip.y + px.y * std::cos(a0) + py.y * std::sin(a0),
              tip.z + px.z * std::cos(a0) + py.z * std::sin(a0)};
      Vec3 p1{tip.x + px.x * std::cos(a1) + py.x * std::sin(a1),
              tip.y + px.y * std::cos(a1) + py.y * std::sin(a1),
              tip.z + px.z * std::cos(a1) + py.z * std::sin(a1)};
      draw_line(img, cam, p0, p1, 60, 60, 60, 1);
    }
  }
}

// Render a whole trajectory into frames (T, h, w, 3) — batch API so Python
// crosses the ctypes boundary once per episode, not per frame.
void render_trajectory(const double* states, int t_steps, const double* marker_xy,
                       const double* cam_offset, int w, int h, uint8_t* imgs) {
  for (int t = 0; t < t_steps; ++t) {
    render_preview(states + 13 * t, marker_xy, cam_offset, w, h,
                   imgs + (size_t)3 * w * h * t);
  }
}
}
