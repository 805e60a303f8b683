// Software triangle rasterizer — native C++ kernel.
//
// Replaces the reference's pyrender/EGL offscreen renderer
// (`reference tools/mesh_renderer.py:26-141`) for headless mesh
// visualization: pinhole projection, z-buffered barycentric fill,
// per-face Lambertian shading with a headlight + ambient, optional
// per-vertex colors, and optional alpha-composited back faces (the
// reference's back_face_alpha composite, `mesh_renderer.py:134-141`).
//
// C ABI for ctypes. Buffers are caller-allocated.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

struct V3 {
  float x, y, z;
};

inline V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
inline float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline V3 norm(V3 a) {
  float n = std::sqrt(dot(a, a));
  if (n < 1e-12f) return {0, 0, 1};
  return {a.x / n, a.y / n, a.z / n};
}

}  // namespace

extern "C" {

// verts: (n_verts, 3) world coords. faces: (n_faces, 3) indices.
// cam_T_world: 4x4 row-major. K: 3x3 row-major (pinhole, CV convention).
// vert_colors: (n_verts, 3) in [0,1] or nullptr (uses base_color).
// out_rgb: (h, w, 3) uint8 — caller-cleared to the background color.
// out_depth: (h, w) float32 — caller-cleared to 0 (0 = no hit).
// back_face_alpha: 0 = cull back faces; >0 = composite them with alpha.
void raster_mesh(const float* verts, int64_t n_verts,
                 const int32_t* faces, int64_t n_faces,
                 const float* cam_T_world, const float* K,
                 int width, int height,
                 const float* vert_colors,
                 const float* base_color_rgb,
                 float back_face_alpha,
                 uint8_t* out_rgb, float* out_depth) {
  const float fx = K[0], cx = K[2], fy = K[4], cy = K[5];

  // transform vertices to camera space
  float* cam_pts = new float[n_verts * 3];
  for (int64_t i = 0; i < n_verts; ++i) {
    const float X = verts[i * 3], Y = verts[i * 3 + 1],
                Z = verts[i * 3 + 2];
    for (int r = 0; r < 3; ++r) {
      cam_pts[i * 3 + r] = cam_T_world[r * 4 + 0] * X +
                           cam_T_world[r * 4 + 1] * Y +
                           cam_T_world[r * 4 + 2] * Z +
                           cam_T_world[r * 4 + 3];
    }
  }

  float* zbuf = new float[(size_t)width * height];
  std::fill(zbuf, zbuf + (size_t)width * height, 1e30f);

  const float kAmbient = 0.35f;
  V3 base = base_color_rgb
                ? V3{base_color_rgb[0], base_color_rgb[1], base_color_rgb[2]}
                : V3{0.75f, 0.75f, 0.75f};

  for (int64_t f = 0; f < n_faces; ++f) {
    const int32_t ia = faces[f * 3], ib = faces[f * 3 + 1],
                  ic = faces[f * 3 + 2];
    V3 a{cam_pts[ia * 3], cam_pts[ia * 3 + 1], cam_pts[ia * 3 + 2]};
    V3 b{cam_pts[ib * 3], cam_pts[ib * 3 + 1], cam_pts[ib * 3 + 2]};
    V3 c{cam_pts[ic * 3], cam_pts[ic * 3 + 1], cam_pts[ic * 3 + 2]};
    if (a.z <= 1e-5f || b.z <= 1e-5f || c.z <= 1e-5f) continue;  // clip

    V3 n = norm(cross(sub(b, a), sub(c, a)));
    // facing test: normal vs view ray to the face centroid
    V3 centroid{(a.x + b.x + c.x) / 3, (a.y + b.y + c.y) / 3,
                (a.z + b.z + c.z) / 3};
    float facing = dot(n, norm(centroid));
    bool back_face = facing > 0.0f;
    if (back_face && back_face_alpha <= 0.0f) continue;

    // project
    float ax = fx * a.x / a.z + cx, ay = fy * a.y / a.z + cy;
    float bx = fx * b.x / b.z + cx, by = fy * b.y / b.z + cy;
    float cx_ = fx * c.x / c.z + cx, cy_ = fy * c.y / c.z + cy;

    int min_x = std::max(0, (int)std::floor(std::min({ax, bx, cx_})));
    int max_x = std::min(width - 1,
                         (int)std::ceil(std::max({ax, bx, cx_})));
    int min_y = std::max(0, (int)std::floor(std::min({ay, by, cy_})));
    int max_y = std::min(height - 1,
                         (int)std::ceil(std::max({ay, by, cy_})));
    if (min_x > max_x || min_y > max_y) continue;

    float denom = (by - cy_) * (ax - cx_) + (cx_ - bx) * (ay - cy_);
    if (std::fabs(denom) < 1e-12f) continue;

    // headlight Lambertian
    float lambert = std::fabs(facing);
    float shade = kAmbient + (1.0f - kAmbient) * lambert;

    V3 col_a = base, col_b = base, col_c = base;
    if (vert_colors) {
      col_a = {vert_colors[ia * 3], vert_colors[ia * 3 + 1],
               vert_colors[ia * 3 + 2]};
      col_b = {vert_colors[ib * 3], vert_colors[ib * 3 + 1],
               vert_colors[ib * 3 + 2]};
      col_c = {vert_colors[ic * 3], vert_colors[ic * 3 + 1],
               vert_colors[ic * 3 + 2]};
    }

    for (int py = min_y; py <= max_y; ++py) {
      for (int px = min_x; px <= max_x; ++px) {
        float sx = px + 0.5f, sy = py + 0.5f;
        float w0 = ((by - cy_) * (sx - cx_) + (cx_ - bx) * (sy - cy_))
                   / denom;
        float w1 = ((cy_ - ay) * (sx - cx_) + (ax - cx_) * (sy - cy_))
                   / denom;
        float w2 = 1.0f - w0 - w1;
        if (w0 < 0 || w1 < 0 || w2 < 0) continue;
        // perspective-correct depth via 1/z interpolation
        float inv_z = w0 / a.z + w1 / b.z + w2 / c.z;
        float z = 1.0f / inv_z;
        size_t idx = (size_t)py * width + px;
        if (z >= zbuf[idx]) continue;

        float r = (w0 * col_a.x + w1 * col_b.x + w2 * col_c.x) * shade;
        float g = (w0 * col_a.y + w1 * col_b.y + w2 * col_c.y) * shade;
        float bcol = (w0 * col_a.z + w1 * col_b.z + w2 * col_c.z) * shade;
        if (back_face) {
          // composite over current color, keep existing depth
          float alpha = back_face_alpha;
          out_rgb[idx * 3 + 0] =
              (uint8_t)(alpha * std::min(1.f, r) * 255 +
                        (1 - alpha) * out_rgb[idx * 3 + 0]);
          out_rgb[idx * 3 + 1] =
              (uint8_t)(alpha * std::min(1.f, g) * 255 +
                        (1 - alpha) * out_rgb[idx * 3 + 1]);
          out_rgb[idx * 3 + 2] =
              (uint8_t)(alpha * std::min(1.f, bcol) * 255 +
                        (1 - alpha) * out_rgb[idx * 3 + 2]);
          continue;
        }
        zbuf[idx] = z;
        out_depth[idx] = z;
        out_rgb[idx * 3 + 0] = (uint8_t)(std::min(1.f, r) * 255);
        out_rgb[idx * 3 + 1] = (uint8_t)(std::min(1.f, g) * 255);
        out_rgb[idx * 3 + 2] = (uint8_t)(std::min(1.f, bcol) * 255);
      }
    }
  }

  delete[] cam_pts;
  delete[] zbuf;
}

}  // extern "C"
