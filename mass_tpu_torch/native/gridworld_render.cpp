// Native core of the procedural grid-world environment engine.
//
// The reference framework's environment layer (SURVEY.md §1 L0) is a
// native engine: the AI2-THOR Unity runtime (C#/C++) renders RGB-D +
// instance segmentation and steps physics, with Python orchestrating
// over JSON-RPC.  This file is the grid-world replacement's native
// equivalent: the per-frame analytic renderer (planar-depth ray vs
// axis-aligned boxes) that `mass_tpu_torch/env/gridworld.py` otherwise
// evaluates in numpy.  Semantics are a line-for-line match of
// GridWorld.render / _ray_aabb_planar (same double-precision math,
// same strict-less-than closest-hit rule, same +inf-miss / 1e-6 near
// clip), pinned by tests/test_native_render.py.
//
// Built on demand by mass_tpu_torch/native/__init__.py (g++ -O2 -shared);
// loaded via ctypes.  No Python.h dependency — plain C ABI.

#include <cmath>
#include <cstdint>
#include <limits>

namespace {

inline double safe_inv(double d) {
    if (std::fabs(d) < 1e-9) d = (d < 0.0) ? -1e-9 : 1e-9;
    return 1.0 / d;
}

// Planar-depth intersection of one unnormalized ray (unit length along
// the camera axis) with one AABB; +inf on miss.  Mirrors
// env/gridworld.py::_ray_aabb_planar.
inline double ray_aabb_planar(const double o[3], const double d[3],
                              const double lo[3], const double hi[3]) {
    double tmin = -std::numeric_limits<double>::infinity();
    double tmax = std::numeric_limits<double>::infinity();
    for (int a = 0; a < 3; ++a) {
        const double inv = safe_inv(d[a]);
        const double t0 = (lo[a] - o[a]) * inv;
        const double t1 = (hi[a] - o[a]) * inv;
        const double lo_t = t0 < t1 ? t0 : t1;
        const double hi_t = t0 < t1 ? t1 : t0;
        if (lo_t > tmin) tmin = lo_t;
        if (hi_t < tmax) tmax = hi_t;
    }
    const double entry = tmin > 1e-6 ? tmin : 1e-6;
    if (tmax >= entry) return entry;
    return std::numeric_limits<double>::infinity();
}

}  // namespace

extern "C" {

// Render one frame.
//
//   h, w, focal      camera intrinsics (square pixels, centered pp)
//   origin[3]        camera position in world frame (x, z_sim, y_up)
//   yaw, elev        radians (already converted from THOR degrees by
//                    the Python caller, matching GridWorld.render)
//   n_boxes          static boxes first, then objects (render order =
//                    priority order under strict '<' closest-hit)
//   lo/hi [n,3]      box corners in WORLD frame (x, z_sim, y_up)
//   cls   [n]        semantic class id per box
//   obj   [n]        object index per box (-1 for statics)
//
// Outputs (row-major h*w):
//   depth_out f32    planar depth, 0 where no hit
//   sem_out   i32    class id of closest hit (0 default)
//   obj_out   i32    object index of closest hit (-1 default)
void gridworld_render(int32_t h, int32_t w, double focal,
                      const double* origin, double yaw, double elev,
                      int32_t n_boxes, const double* lo,
                      const double* hi, const int32_t* cls,
                      const int32_t* obj, float* depth_out,
                      int32_t* sem_out, int32_t* obj_out) {
    // camera basis (matches env/gridworld.py: eye/up spherical, basis
    // rows = [cross(eye, up), up, -eye])
    const double eye[3] = {std::cos(yaw) * std::cos(elev),
                           std::sin(yaw) * std::cos(elev),
                           std::sin(elev)};
    const double e2 = elev + M_PI / 2.0;
    const double up[3] = {std::cos(yaw) * std::cos(e2),
                          std::sin(yaw) * std::cos(e2),
                          std::sin(e2)};
    const double cx = eye[1] * up[2] - eye[2] * up[1];
    const double cy = eye[2] * up[0] - eye[0] * up[2];
    const double cz = eye[0] * up[1] - eye[1] * up[0];
    // world_dir = rx * cross + ry * up + rz * (-eye)
    const double bx[3] = {cx, cy, cz};
    const double by[3] = {up[0], up[1], up[2]};
    const double bz[3] = {-eye[0], -eye[1], -eye[2]};

    const double inf = std::numeric_limits<double>::infinity();
    for (int32_t py = 0; py < h; ++py) {
        const double ry = -((double)py - 0.5 * (double)(h - 1)) / focal;
        for (int32_t px = 0; px < w; ++px) {
            const double rx = ((double)px - 0.5 * (double)(w - 1)) / focal;
            // camera dir (rx, ry, -1) rotated into the world frame;
            // rz = -1, so the bz basis contributes with a flipped sign
            double d[3];
            for (int a = 0; a < 3; ++a)
                d[a] = rx * bx[a] + ry * by[a] + (-1.0) * bz[a];

            double best_t = inf;
            int32_t best_cls = 0;
            int32_t best_obj = -1;
            for (int32_t b = 0; b < n_boxes; ++b) {
                const double t = ray_aabb_planar(origin, d,
                                                 lo + 3 * b, hi + 3 * b);
                if (t < best_t) {
                    best_t = t;
                    best_cls = cls[b];
                    best_obj = obj[b];
                }
            }
            const int64_t i = (int64_t)py * w + px;
            depth_out[i] = std::isinf(best_t) ? 0.0f : (float)best_t;
            sem_out[i] = best_cls;
            obj_out[i] = best_obj;
        }
    }
}

}  // extern "C"
