// What the sweep kernels share. The float32 CUDA-core forward sweeps, K1
// (fused_sweep.cu, fused_sweep_mlp_kernel; K4 and K5, early_sweeps.cu)
// share `project`, the projection of a plane point into a source view
// (K1's and K4's), the metadata rows and the MLP below. K1, K1-dot, K2
// and the scatter of the sweeps' gradient (sweep_scatter.cu) share
// `project_taps`, and K1 `bilinear`. The bf16 tensor-core kernels share the
// last section: the bf16 input tile's metadata values, K1's and K2's
// fill of it (`fill_inputs_bf16`), the weight copy, and the shared
// memory and MLP call of the forward kernels K1, K4 and K5 (`MlpTile`),
// around the mma tile of sweep_mma.cuh.
//
// A CUDA-core sweep kernel's block owns one tile of kTile reference
// pixels at one (batch, plane) and runs kHidden threads.
// It assembles the tile's MLP input in shared memory as rows of kTile
// pixels, in the channel order of simplerecon_tpu/models/cost_volume.py::
// _metadata_chunk:
//
//   [sampled (k*c, view-major) | ref (c)] mask(k) depth(k) plane(1)
//   dot(k) ray_angle(k) [ref ray (3) | src rays (3k)] penalty(k) R(k) t(k)
//
// with `view_meta_rows` (one (pixel, view) item) and `pixel_meta_rows`
// (one pixel), then calls `mlp_tail`, which runs the MLP
// C_in -> 128 -> 128 -> 1 with LeakyReLU(0.01) over those rows and writes
// the tile's scores. Values are rounded to the compute dtype T where they
// enter a product; every product and sum is float32.
//
// mlp_tail: thread j keeps the tile's 64 sums for hidden channel j in
// registers. Each input row is read as float4 broadcasts from shared
// memory; the thread's weight w[i][j] is one coalesced load per row. The
// rounded activations overwrite the inputs in shared memory and feed the
// next layer; the last layer (128 -> 1) is a per-pixel dot over the shared
// activations. Rows are kRow = 68 floats apart, so the float4 row writes
// do not collide in banks; max(C_in, 128) rows (54.9 KB at C_in = 202) are
// dynamic shared memory above 48 KB.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "sweep_mma.cuh"

namespace {

constexpr int kTile = 64;     // pixels per block
constexpr int kRow = 68;      // shared-memory row stride in floats

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Rounds a float32 value to T (round to nearest even) and back.
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return round_bf16(x);
}

// MLP input width for k source views of c channels.
__host__ __device__ __forceinline__ int mlp_in_channels(int k, int c) {
  return (k + 1) * c + 10 * k + 4;
}

// A point projected into one source view with P = K @ src_T_cur (row-major
// 4x4) and the eps-safe divide of ops/geometry.py::project_points: pixel
// coords (u, v), depth z + 1e-8 and mask z + 1e-8 > 0.
struct Projection {
  float u, v, z_eps, mask;
};

__device__ __forceinline__ Projection project(const float* P, float wx,
                                              float wy, float wz) {
  Projection q;
  const float cx = P[0] * wx + P[1] * wy + P[2] * wz + P[3];
  const float cy = P[4] * wx + P[5] * wy + P[6] * wz + P[7];
  const float cz = P[8] * wx + P[9] * wy + P[10] * wz + P[11];
  q.z_eps = cz + 1e-8f;
  const float scale = fabsf(cz) > 1e-8f ? 1.0f / q.z_eps : 1.0f;
  q.u = cx * scale;
  q.v = cy * scale;
  q.mask = q.z_eps > 0.f ? 1.f : 0.f;
  return q;
}

// Unnormalised ray invK @ (x + 0.5, y + 0.5, 1) of reference pixel pix.
__device__ __forceinline__ float3 pixel_ray(const float* ik, int pix, int w) {
  const float px = (pix % w) + 0.5f;
  const float py = (pix / w) + 0.5f;
  return make_float3(ik[0] * px + ik[1] * py + ik[2],
                     ik[4] * px + ik[5] * py + ik[6],
                     ik[8] * px + ik[9] * py + ik[10]);
}

// Projection of one point into one source view and its bilinear taps.
struct Taps {
  int pix[4];    // tap pixel indices y * w + x: nw, ne, sw, se (0 outside)
  float wt[4];   // tap weights (0 outside the image)
  float z_eps;   // projected depth z + 1e-8
  float mask;    // z_eps > 0
};

// Projects the reference-frame point (wx, wy, wz) (`project`), then takes
// the bilinear taps at index coords (u - 0.5, v - 0.5), zeros outside the
// image.
__device__ __forceinline__ Taps project_taps(const float* P, float wx,
                                             float wy, float wz, int h,
                                             int w) {
  Taps t;
  const Projection q = project(P, wx, wy, wz);
  t.z_eps = q.z_eps;
  t.mask = q.mask;
  const float u = q.u, v = q.v;

  const float ix = u - 0.5f, iy = v - 0.5f;
  const float x0 = floorf(ix), y0 = floorf(iy);
  const float x1 = x0 + 1.f, y1 = y0 + 1.f;
  const bool vx0 = x0 >= 0.f && x0 <= w - 1.f;
  const bool vx1 = x1 >= 0.f && x1 <= w - 1.f;
  const bool vy0 = y0 >= 0.f && y0 <= h - 1.f;
  const bool vy1 = y1 >= 0.f && y1 <= h - 1.f;
  const int xi0 = vx0 ? (int)x0 : 0, xi1 = vx1 ? (int)x1 : 0;
  const int yi0 = vy0 ? (int)y0 : 0, yi1 = vy1 ? (int)y1 : 0;
  t.wt[0] = (vx0 && vy0) ? (x1 - ix) * (y1 - iy) : 0.f;
  t.wt[1] = (vx1 && vy0) ? (ix - x0) * (y1 - iy) : 0.f;
  t.wt[2] = (vx0 && vy1) ? (x1 - ix) * (iy - y0) : 0.f;
  t.wt[3] = (vx1 && vy1) ? (ix - x0) * (iy - y0) : 0.f;
  t.pix[0] = yi0 * w + xi0;
  t.pix[1] = yi0 * w + xi1;
  t.pix[2] = yi1 * w + xi0;
  t.pix[3] = yi1 * w + xi1;
  return t;
}

// The float32 sample of one channel from its four tap values.
__device__ __forceinline__ float bilinear(const Taps& t, float nw, float ne,
                                          float sw, float se) {
  return t.wt[0] * nw + t.wt[1] * ne + t.wt[2] * sw + t.wt[3] * se;
}

// Dynamic shared memory of one block: the input rows, reused for the
// hidden rows.
inline size_t tail_smem_bytes(int cin) {
  return (size_t)(cin > kHidden ? cin : kHidden) * kRow * sizeof(float);
}

// Rows of one (pixel p, view) item: mask, depth, dot * mask, the angle
// between the unit rays from the reference camera and from the source
// camera centre loc to the plane point ray * plane, and that source ray.
// `ray` is the reference pixel's unnormalised ray. meta is the first
// metadata row, (k + 1) * c.
template <typename T>
__device__ __forceinline__ void view_meta_rows(float* rows, int p, int view,
                                               int k, int meta, float mask,
                                               float depth, float dot,
                                               float3 ray, float plane,
                                               const float* loc) {
  const float rx = ray.x, ry = ray.y, rz = ray.z;
  const float wx = rx * plane, wy = ry * plane, wz = rz * plane;
  const float ref_inv = 1.0f / sqrtf(rx * rx + ry * ry + rz * rz + 1e-30f);
  const float sx = wx - loc[0], sy = wy - loc[1], sz = wz - loc[2];
  const float src_inv = 1.0f / sqrtf(sx * sx + sy * sy + sz * sz + 1e-30f);
  const float angle =
      (rx * ref_inv) * (sx * src_inv) + (ry * ref_inv) * (sy * src_inv) +
      (rz * ref_inv) * (sz * src_inv);

  rows[(meta + view) * kRow + p] = round_to<T>(mask);
  rows[(meta + k + view) * kRow + p] = round_to<T>(depth);
  rows[(meta + 2 * k + 1 + view) * kRow + p] = round_to<T>(dot * mask);
  rows[(meta + 3 * k + 1 + view) * kRow + p] = round_to<T>(angle);
  const int sray = meta + 4 * k + 4 + 3 * view;
  rows[(sray + 0) * kRow + p] = round_to<T>(sx * src_inv);
  rows[(sray + 1) * kRow + p] = round_to<T>(sy * src_inv);
  rows[(sray + 2) * kRow + p] = round_to<T>(sz * src_inv);
}

// Rows of one pixel p: its reference features cur_p (c values), the plane
// depth, its unit reference ray and the pose rows [penalty(k), R(k), t(k)]
// from pose (k, 3).
template <typename T>
__device__ __forceinline__ void pixel_meta_rows(float* rows, int p, int k,
                                                int c, int meta,
                                                const T* cur_p, float3 ray,
                                                float plane,
                                                const float* pose) {
  for (int ch = 0; ch < c; ++ch) {
    rows[(k * c + ch) * kRow + p] = to_float(cur_p[ch]);
  }
  const float rx = ray.x, ry = ray.y, rz = ray.z;
  const float ref_inv = 1.0f / sqrtf(rx * rx + ry * ry + rz * rz + 1e-30f);
  rows[(meta + 2 * k) * kRow + p] = round_to<T>(plane);
  rows[(meta + 4 * k + 1) * kRow + p] = round_to<T>(rx * ref_inv);
  rows[(meta + 4 * k + 2) * kRow + p] = round_to<T>(ry * ref_inv);
  rows[(meta + 4 * k + 3) * kRow + p] = round_to<T>(rz * ref_inv);
  for (int jv = 0; jv < 3 * k; ++jv) {
    const int j = jv / k, view = jv % k;
    rows[(meta + 7 * k + 4 + jv) * kRow + p] = round_to<T>(pose[view * 3 + j]);
  }
}

// acc[p] += sum_i rows[i][p] * w[i*kHidden + j] for the tile's 64 pixels.
template <typename T>
__device__ __forceinline__ void dense_rows(const float* rows, int n_rows,
                                           const T* __restrict__ wgt, int j,
                                           float (&acc)[kTile]) {
#pragma unroll 2
  for (int i = 0; i < n_rows; ++i) {
    const float wv = to_float(wgt[i * kHidden + j]);
    const float4* row = reinterpret_cast<const float4*>(rows + i * kRow);
#pragma unroll
    for (int q = 0; q < kTile / 4; ++q) {
      const float4 f = row[q];
      acc[4 * q + 0] = fmaf(f.x, wv, acc[4 * q + 0]);
      acc[4 * q + 1] = fmaf(f.y, wv, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(f.z, wv, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(f.w, wv, acc[4 * q + 3]);
    }
  }
}

// Writes thread j's 64 activations, rounded to T, as row j.
template <typename T>
__device__ __forceinline__ void store_row(float* rows, int j, float bias,
                                          const float (&acc)[kTile]) {
  float4* row = reinterpret_cast<float4*>(rows + j * kRow);
#pragma unroll
  for (int q = 0; q < kTile / 4; ++q) {
    row[q] = make_float4(round_to<T>(leaky_relu(acc[4 * q + 0] + bias)),
                         round_to<T>(leaky_relu(acc[4 * q + 1] + bias)),
                         round_to<T>(leaky_relu(acc[4 * q + 2] + bias)),
                         round_to<T>(leaky_relu(acc[4 * q + 3] + bias)));
  }
}

// The MLP over the cin input rows the block has assembled (and made
// visible with __syncthreads); every thread of the block calls it. Writes
// the scores of the tile's first `valid` pixels to out[0 .. valid).
template <typename T>
__device__ __forceinline__ void mlp_tail(float* rows, int cin,
                                         const T* __restrict__ w0,
                                         const float* __restrict__ b0,
                                         const T* __restrict__ w1,
                                         const float* __restrict__ b1,
                                         const T* __restrict__ w2,
                                         const float* __restrict__ b2,
                                         float* __restrict__ out, int valid) {
  const int tid = threadIdx.x;
  float acc[kTile];
#pragma unroll
  for (int p = 0; p < kTile; ++p) acc[p] = 0.f;
  dense_rows(rows, cin, w0, tid, acc);
  __syncthreads();  // every thread has read the inputs
  store_row<T>(rows, tid, b0[tid], acc);
  __syncthreads();

#pragma unroll
  for (int p = 0; p < kTile; ++p) acc[p] = 0.f;
  dense_rows(rows, kHidden, w1, tid, acc);
  __syncthreads();
  store_row<T>(rows, tid, b1[tid], acc);
  __syncthreads();

  if (tid < kTile && tid < valid) {
    float o = 0.f;
    for (int j = 0; j < kHidden; ++j) {
      o = fmaf(rows[j * kRow + tid], to_float(w2[j]), o);
    }
    out[tid] = o + b2[0];
  }
}

// ---- the bf16 input tile of the tensor-core kernels (K1 and K2, bf16) ----
// There the MLP input is a row-major bf16 tile X, one row of xs elements
// per cell (reference pixel, plane), in the channel order above. It holds
// the values that the float32 row layout holds, rounded where K1 rounds.

constexpr int kMmaThreads = 256;   // 8 warps a block

// C_in padded with zero rows to the products' k-step of 16, keeping at
// least one zero row (K2's d_x points its padding columns there).
__host__ __device__ __forceinline__ int padded_cin(int cin) {
  return (cin + 16) / 16 * 16;
}

// Copies w0 (cin x 128) and w1 (128 x 128) into shared memory, kWs
// elements a row, and zeroes rows [cin, padded_cin(cin)) of W0. Every
// thread of the block calls it; the caller syncs.
__device__ __forceinline__ void load_weights(
    __nv_bfloat16* W0, __nv_bfloat16* W1,
    const __nv_bfloat16* __restrict__ w0,
    const __nv_bfloat16* __restrict__ w1, int cin) {
  copy_rows(W0, kWs, w0, cin, kHidden);
  copy_rows(W1, kWs, w1, kHidden, kHidden);
  const int pad = padded_cin(cin) - cin;
  for (int i = threadIdx.x; i < pad * kHidden; i += blockDim.x) {
    W0[(cin + i / kHidden) * kWs + i % kHidden] = __float2bfloat16_rn(0.f);
  }
  copy_wait();
}

// The 8 bf16 of u as float32.
__device__ __forceinline__ void unpack8(const uint4& u, float (&v)[8]) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(q[e]);
    v[2 * e] = f.x;
    v[2 * e + 1] = f.y;
  }
}

// Loads 8 bf16 from a 16-byte-aligned address as float32.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  unpack8(*reinterpret_cast<const uint4*>(p), v);
}

// The float32 samples of channels [ch0, ch0 + 8) of one view's taps
// (img is the view's (h*w, c) map, 16-byte aligned, c % 8 == 0).
__device__ __forceinline__ void sample8(const __nv_bfloat16* img, int c,
                                        const Taps& t, int ch0,
                                        float (&s)[8]) {
  uint4 q[4];  // the four taps' 8 channels, still bf16
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    q[i] = *reinterpret_cast<const uint4*>(img + (size_t)t.pix[i] * c + ch0);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float2 f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[i] = __bfloat1622float2(
          reinterpret_cast<const __nv_bfloat162*>(&q[i])[e]);
    }
    s[2 * e] = bilinear(t, f[0].x, f[1].x, f[2].x, f[3].x);
    s[2 * e + 1] = bilinear(t, f[0].y, f[1].y, f[2].y, f[3].y);
  }
}

// The float32 sample of channel ch (any c).
__device__ __forceinline__ float sample1(const __nv_bfloat16* img, int c,
                                         const Taps& t, int ch) {
  return bilinear(t, __bfloat162float(img[(size_t)t.pix[0] * c + ch]),
                  __bfloat162float(img[(size_t)t.pix[1] * c + ch]),
                  __bfloat162float(img[(size_t)t.pix[2] * c + ch]),
                  __bfloat162float(img[(size_t)t.pix[3] * c + ch]));
}

// The values of `view_meta_rows` for one (cell, view), rounded to bf16
// into the cell's row x of X: mask, depth, dot * mask, the angle between
// the unit rays from the reference camera and from the source camera
// centre lv to the plane point ray * plane, and that source ray. `ray` is
// the reference pixel's unnormalised ray; meta is the first metadata
// column, (k + 1) * c.
__device__ __forceinline__ void view_meta_bf16(bf16* x, int meta, int k,
                                               int view, float mask,
                                               float depth, float dot,
                                               float3 ray, float plane,
                                               const float* lv) {
  const float rx = ray.x, ry = ray.y, rz = ray.z;
  const float wx = rx * plane, wy = ry * plane, wz = rz * plane;
  const float ref_inv = 1.0f / sqrtf(rx * rx + ry * ry + rz * rz + 1e-30f);
  const float sx = wx - lv[0], sy = wy - lv[1], sz = wz - lv[2];
  const float src_inv = 1.0f / sqrtf(sx * sx + sy * sy + sz * sz + 1e-30f);
  const float angle =
      (rx * ref_inv) * (sx * src_inv) + (ry * ref_inv) * (sy * src_inv) +
      (rz * ref_inv) * (sz * src_inv);
  x[meta + view] = __float2bfloat16_rn(mask);
  x[meta + k + view] = __float2bfloat16_rn(depth);
  x[meta + 2 * k + 1 + view] = __float2bfloat16_rn(dot * mask);
  x[meta + 3 * k + 1 + view] = __float2bfloat16_rn(angle);
  const int sray = meta + 4 * k + 4 + 3 * view;
  x[sray + 0] = __float2bfloat16_rn(sx * src_inv);
  x[sray + 1] = __float2bfloat16_rn(sy * src_inv);
  x[sray + 2] = __float2bfloat16_rn(sz * src_inv);
}

// The values of `pixel_meta_rows` for one cell into its row x of X: the
// reference features cur_p (c values, copied; vec8: 16-byte copies), the
// plane depth, the unit reference ray and the pose columns [penalty(k),
// R(k), t(k)] from pose (k, 3).
__device__ __forceinline__ void pixel_meta_bf16(bf16* x, int meta, int k,
                                                int c, const bf16* cur_p,
                                                float3 ray, float plane,
                                                const float* pose,
                                                bool vec8) {
  if (vec8) {
    for (int ch0 = 0; ch0 < c; ch0 += 8) {
      *reinterpret_cast<uint4*>(x + k * c + ch0) =
          *reinterpret_cast<const uint4*>(cur_p + ch0);
    }
  } else {
    for (int ch = 0; ch < c; ++ch) x[k * c + ch] = cur_p[ch];
  }
  const float rx = ray.x, ry = ray.y, rz = ray.z;
  const float ref_inv = 1.0f / sqrtf(rx * rx + ry * ry + rz * rz + 1e-30f);
  x[meta + 2 * k] = __float2bfloat16_rn(plane);
  x[meta + 4 * k + 1] = __float2bfloat16_rn(rx * ref_inv);
  x[meta + 4 * k + 2] = __float2bfloat16_rn(ry * ref_inv);
  x[meta + 4 * k + 3] = __float2bfloat16_rn(rz * ref_inv);
  for (int jv = 0; jv < 3 * k; ++jv) {
    const int j = jv / k, view = jv % k;
    x[meta + 7 * k + 4 + jv] = __float2bfloat16_rn(pose[view * 3 + j]);
  }
}

// Fills rows [0, M) of X: row m is reference pixel min(p0 + m, n - 1) at
// depth `plane` (a ragged last tile repeats the last pixel; the caller
// drops its results). src (k, h*w, c), cur (h*w, c), proj (k, 4, 4),
// ik (4, 4), pose (k, 3) and loc (k, 3) are one batch element's. Columns
// [cin, xs) are not written: the caller zeroes them. vec8: c % 8 ==
// 0 and src, cur 16-byte aligned, so taps are 16-byte loads. Samples are
// float32 from the bf16 maps, rounded once into X; the dot rows come from
// the unrounded samples, as in K1's float32 layout. Every thread of the
// block calls it.
__device__ __forceinline__ void fill_inputs_bf16(
    bf16* X, int xs, int M, const bf16* __restrict__ src,
    const bf16* __restrict__ cur, const float* __restrict__ proj,
    const float* __restrict__ ik, float plane,
    const float* __restrict__ pose, const float* __restrict__ loc, int p0,
    int n, int k, int h, int w, int c, bool vec8) {
  const int meta = (k + 1) * c;
  // one loop over M * k (pixel, view) items, then M pixel items, so every
  // thread takes about the same share of the loads
  for (int item = threadIdx.x; item < M * (k + 1); item += blockDim.x) {
    if (item >= M * k) {
      const int m = item - M * k;
      const int pix = min(p0 + m, n - 1);
      pixel_meta_bf16(X + m * xs, meta, k, c, cur + (size_t)pix * c,
                      pixel_ray(ik, pix, w), plane, pose, vec8);
      continue;
    }
    const int m = item % M;
    const int view = item / M;
    const int pix = min(p0 + m, n - 1);
    const float3 ray = pixel_ray(ik, pix, w);
    const Taps t = project_taps(proj + view * 16, ray.x * plane,
                                ray.y * plane, ray.z * plane, h, w);
    const bf16* img = src + (size_t)view * n * c;
    const bf16* cur_p = cur + (size_t)pix * c;
    bf16* x = X + m * xs;
    float dot = 0.f;
    if (vec8) {
      for (int ch0 = 0; ch0 < c; ch0 += 8) {
        float s[8], cv[8];
        sample8(img, c, t, ch0, s);
        load8(cur_p + ch0, cv);
#pragma unroll
        for (int e = 0; e < 8; ++e) dot = fmaf(s[e], cv[e], dot);
        *reinterpret_cast<uint4*>(x + view * c + ch0) =
            make_uint4(pack_bf16(s[0], s[1]), pack_bf16(s[2], s[3]),
                       pack_bf16(s[4], s[5]), pack_bf16(s[6], s[7]));
      }
    } else {
      for (int ch = 0; ch < c; ++ch) {
        const float s = sample1(img, c, t, ch);
        x[view * c + ch] = __float2bfloat16_rn(s);
        dot = fmaf(s, __bfloat162float(cur_p[ch]), dot);
      }
    }
    view_meta_bf16(x, meta, k, view, t.mask, t.z_eps, dot, ray, plane,
                   loc + view * 3);
  }
}

// ---- the forward tensor-core kernels (K1, K4 and K5 in bf16) -----------
// Persistent blocks of kMmaThreads, one an SM, walk work items of
// kMmaCells cells; per item, every thread fills X, then warp i runs the
// MLP of rows [16i, 16i + 16) (`mlp_rows`). Shared memory at hero widths
// (C_in = 202, padded to 208): W0 56,576 B + W1 34,816 + X (128 x 216)
// 55,296 + b0, b1, w2 1,536 = 148,224 B.
constexpr int kMmaCells = 16 * (kMmaThreads / 32);

inline size_t mma_smem_bytes(int cin) {
  const int cinp = padded_cin(cin);
  return ((size_t)(cinp + kHidden) * kWs + (size_t)kMmaCells * (cinp + 8)) *
             sizeof(bf16) +
         3 * kHidden * sizeof(float);
}

// Blocks of a persistent kernel with `items` work items: one an SM, or
// one an item.
inline int persistent_blocks(long items) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)(items < sms ? items : sms);
}

// The MLP's operands in shared memory: weights, biases, w2 and the input
// tile X (kMmaCells rows of xs elements), and b2.
struct MlpTile {
  bf16 *W0, *W1, *X;
  float *B0, *B1, *W2;
  int cinp, xs;
  float b2;
};

// Lays out the shared memory `smem` (mma_smem_bytes(cin) bytes), copies
// the weights, biases and w2 into it and zeroes X's columns [cin, xs),
// which no fill writes. Every thread of the block calls it; the caller
// syncs before the first fill.
__device__ __forceinline__ MlpTile load_mlp_tile(
    void* smem, const bf16* __restrict__ w0, const float* __restrict__ b0,
    const bf16* __restrict__ w1, const float* __restrict__ b1,
    const bf16* __restrict__ w2, const float* __restrict__ b2, int cin) {
  MlpTile s;
  s.cinp = padded_cin(cin);
  s.xs = s.cinp + 8;
  s.W0 = static_cast<bf16*>(smem);
  s.W1 = s.W0 + s.cinp * kWs;
  s.X = s.W1 + kHidden * kWs;
  s.B0 = reinterpret_cast<float*>(s.X + kMmaCells * s.xs);
  s.B1 = s.B0 + kHidden;
  s.W2 = s.B1 + kHidden;
  s.b2 = b2[0];
  load_weights(s.W0, s.W1, w0, w1, cin);
  const int pad = s.xs - cin;
  for (int i = threadIdx.x; i < kMmaCells * pad; i += blockDim.x) {
    s.X[(i / pad) * s.xs + cin + i % pad] = __float2bfloat16_rn(0.f);
  }
  for (int i = threadIdx.x; i < kHidden; i += blockDim.x) {
    s.B0[i] = b0[i];
    s.B1[i] = b1[i];
    s.W2[i] = __bfloat162float(w2[i]);
  }
  return s;
}

// After a fill of X (and a __syncthreads): the scores of the item's cells
// [0, valid) into out[0 .. valid). Every thread of the block calls it.
__device__ __forceinline__ void mlp_tile_out(const MlpTile& s, float* out,
                                             int valid) {
  const int lane = threadIdx.x & 31, g = lane >> 2;
  const int m0 = (threadIdx.x >> 5) * 16;  // this warp's rows of X
  const float2 o = mlp_rows(s.X, s.xs, m0, s.cinp, s.W0, s.W1, s.B0, s.B1,
                            s.W2);
  if ((lane & 3) == 0 && m0 + g < valid) out[m0 + g] = o.x + s.b2;
  if ((lane & 3) == 0 && m0 + g + 8 < valid) out[m0 + g + 8] = o.y + s.b2;
}

}  // namespace
