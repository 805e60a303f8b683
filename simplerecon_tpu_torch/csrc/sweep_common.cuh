// What the three forward sweep kernels share: K1 (fused_sweep.cu,
// fused_sweep_mlp_kernel), K4 and K5 (early_sweeps.cu). `project` is the
// projection of a plane point into a source view (K1's and K4's); the rest
// is the metadata rows and the MLP. Each kernel's block owns one tile of
// kTile reference pixels at one (batch, plane) and runs kHidden threads.
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

namespace {

constexpr int kHidden = 128;  // MLP width == threads per block
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
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float leaky_relu(float x) {
  return x > 0.f ? x : 0.01f * x;
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

}  // namespace
