// The hero feature volume's two earlier sweep kernels: the metadata + MLP
// tail over a pre-warped stack (K5) and the full-width fused warp (K4).
// Both compute what K1 (fused_sweep.cu) computes, with the JAX kernels'
// own rounding points, and share K1's metadata rows and MLP (`mlp_tail`
// and its helpers in sweep_common.cuh): one block per (pixel tile of 64,
// plane, batch element), 128 threads, the tile's C_in input rows in shared
// memory.
//
// K5, fused_feature_volume_kernel, replaces simplerecon_tpu/ops/
// pallas_cv.py::fused_feature_volume (body _kernel, tail _metadata_mlp;
// backend "pallas_v1"). Inputs: the warped stack sampled (k, b*d*N, c) in
// the compute dtype T, rows ordered (b, d, N); mask and depths (k, b*d*N)
// float32; cur (b, N, c) in T; unnormalised rays (b, N, 3), planes (b, d),
// pose_meta and src_loc (b, k, 3) float32; w0 (C_in, 128), w1 (128, 128),
// w2 (128, 1) in T and float32 biases. The samples come in already
// rounded to T, so the dot rows are taken from the rounded samples.
// Each (pixel, view) item reads its stack row of c elements with 16-byte
// vector loads (c a multiple of 8; the wrapper checks) and its mask and
// depth as float32; neighbouring threads read neighbouring rows.
// What bounds it on an H100: its device memory stream and its MLP are
// about equal. At hero b1 bf16 the stack is 176 MB and mask and depth add
// 44 MB: 0.067 ms at 3.35 TB/s, against 66.6 GFLOP of MLP, 0.067 ms on
// the bf16 tensor cores. This first version runs the MLP on the CUDA
// cores in float32 FMAs, as K1 does, so the MLP bounds it.
//
// K4, fused_warp_feature_volume_kernel, replaces pallas_cv.py::
// fused_warp_feature_volume (body _warp_kernel, taps _twohot_weights;
// backend "pallas_full"). Inputs: source maps img (b, k, h, c*w) in T
// with c-major rows (element (y, ch, x) at y*c*w + ch*w + x); cur, rays,
// planes, pose_meta, src_loc and the MLP as for K5; proj = K @ src_T_cur
// (b, k, 4, 4) float32. Each (pixel, view) item projects the plane point
// as K1 does (`project`), then samples separably as the TPU kernel's
// two-hot products do: the y taps' weights rounded to T, the two rows
// combined first, then the x taps with float32 weights. The two x taps of
// a channel are neighbours in a row, so a channel is four scalar loads
// from L1/L2 (one (b, view) map is 0.4 MB in bf16 at hero size). The
// samples stay float32 for the dot rows and are rounded to T as MLP
// inputs; mask = z + eps > 0 and depth = z + eps. Its device memory
// traffic is small (the maps, cur, rays and the float32 output), so the
// float32 CUDA-core MLP bounds it, as it does K1.
//
// Output of both: (b, d, N) float32 scores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sweep_common.cuh"

namespace {

constexpr int kVec = 8;  // stack channels per 16-byte vector load (K5)

// Loads kVec channels of T from a 16-byte-aligned address as float32.
__device__ __forceinline__ void load_vec(const float* p, float (&v)[kVec]) {
  const float4* q = reinterpret_cast<const float4*>(p);
  const float4 a = q[0], b = q[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&v)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < kVec / 2; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    v[2 * e + 0] = f.x;
    v[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ float3 load_ray(const float* r) {
  return make_float3(r[0], r[1], r[2]);
}

template <typename T>
__global__ void __launch_bounds__(kHidden)
fused_feature_volume_kernel(const T* __restrict__ sampled,
                            const float* __restrict__ mask,
                            const float* __restrict__ depths,
                            const T* __restrict__ cur,
                            const float* __restrict__ rays,
                            const float* __restrict__ planes,
                            const float* __restrict__ pose_meta,
                            const float* __restrict__ src_loc,
                            const T* __restrict__ w0,
                            const float* __restrict__ b0,
                            const T* __restrict__ w1,
                            const float* __restrict__ b1,
                            const T* __restrict__ w2,
                            const float* __restrict__ b2,
                            float* __restrict__ out, int b, int k, int n,
                            int c, int d) {
  extern __shared__ float4 smem4[];
  float* rows = reinterpret_cast<float*>(smem4);

  const int meta = (k + 1) * c;  // first metadata row
  const int p0 = blockIdx.x * kTile;
  const int di = blockIdx.y;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const float plane = planes[bi * d + di];
  const size_t n_rows = (size_t)b * d * n;             // stack rows a view
  const size_t cell0 = ((size_t)bi * d + di) * n;      // this (b, plane)

  // Per-view rows: one item per (pixel, view).
  for (int item = tid; item < kTile * k; item += kHidden) {
    const int p = item % kTile;
    const int view = item / kTile;
    const int pix = min(p0 + p, n - 1);  // ragged last tile: not stored
    const size_t row = view * n_rows + cell0 + pix;
    const T* s = sampled + row * c;
    const T* cur_p = cur + ((size_t)bi * n + pix) * c;
    float dot = 0.f;
    for (int ch0 = 0; ch0 < c; ch0 += kVec) {
      float sv[kVec], cv[kVec];
      load_vec(s + ch0, sv);
      load_vec(cur_p + ch0, cv);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        rows[(view * c + ch0 + e) * kRow + p] = sv[e];
        dot = fmaf(sv[e], cv[e], dot);
      }
    }
    view_meta_rows<T>(rows, p, view, k, meta, mask[row], depths[row], dot,
                      load_ray(rays + ((size_t)bi * n + pix) * 3), plane,
                      src_loc + (bi * k + view) * 3);
  }
  // Per-pixel rows: reference features, plane, reference ray, pose rows.
  for (int p = tid; p < kTile; p += kHidden) {
    const int pix = min(p0 + p, n - 1);
    pixel_meta_rows<T>(rows, p, k, c, meta, cur + ((size_t)bi * n + pix) * c,
                       load_ray(rays + ((size_t)bi * n + pix) * 3), plane,
                       pose_meta + bi * k * 3);
  }
  __syncthreads();

  mlp_tail<T>(rows, mlp_in_channels(k, c), w0, b0, w1, b1, w2, b2,
              out + cell0 + p0, n - p0);
}

// The two taps of one axis at index coord `coord` in [0, size): the
// TPU kernel's _twohot_weights, w0 = 1 - frac at floor(coord) and
// w1 = frac at floor(coord) + 1, each zero (at index 0) outside.
struct TwoHot {
  int i0, i1;
  float w0, w1;
};

__device__ __forceinline__ TwoHot two_hot(float coord, int size) {
  TwoHot t;
  const float c0 = floorf(coord);
  const float f1 = coord - c0;
  const float f0 = 1.0f - f1;
  const bool v0 = c0 >= 0.f && c0 <= size - 1.f;
  const bool v1 = c0 + 1.f >= 0.f && c0 + 1.f <= size - 1.f;
  t.i0 = v0 ? (int)c0 : 0;
  t.i1 = v1 ? (int)c0 + 1 : 0;
  t.w0 = v0 ? f0 : 0.f;
  t.w1 = v1 ? f1 : 0.f;
  return t;
}

template <typename T>
__global__ void __launch_bounds__(kHidden)
fused_warp_feature_volume_kernel(const T* __restrict__ img,
                                 const T* __restrict__ cur,
                                 const float* __restrict__ rays,
                                 const float* __restrict__ planes,
                                 const float* __restrict__ proj,
                                 const float* __restrict__ pose_meta,
                                 const float* __restrict__ src_loc,
                                 const T* __restrict__ w0,
                                 const float* __restrict__ b0,
                                 const T* __restrict__ w1,
                                 const float* __restrict__ b1,
                                 const T* __restrict__ w2,
                                 const float* __restrict__ b2,
                                 float* __restrict__ out, int k, int h, int w,
                                 int c, int d) {
  extern __shared__ float4 smem4[];
  float* rows = reinterpret_cast<float*>(smem4);

  const int n = h * w;
  const int meta = (k + 1) * c;  // first metadata row
  const int p0 = blockIdx.x * kTile;
  const int di = blockIdx.y;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const float plane = planes[bi * d + di];
  const size_t map = (size_t)h * c * w;  // elements of one (b, view) map

  // Per-view rows: one item per (pixel, view).
  for (int item = tid; item < kTile * k; item += kHidden) {
    const int p = item % kTile;
    const int view = item / kTile;
    const int pix = min(p0 + p, n - 1);  // ragged last tile: not stored
    const float3 ray = load_ray(rays + ((size_t)bi * n + pix) * 3);
    const Projection q = project(proj + (bi * k + view) * 16, ray.x * plane,
                                 ray.y * plane, ray.z * plane);
    const TwoHot tx = two_hot(q.u - 0.5f, w);
    const TwoHot ty = two_hot(q.v - 0.5f, h);
    const float wy0 = round_to<T>(ty.w0), wy1 = round_to<T>(ty.w1);

    const T* base = img + (bi * k + view) * map;
    const T* row0 = base + (size_t)ty.i0 * c * w;
    const T* row1 = base + (size_t)ty.i1 * c * w;
    const T* cur_p = cur + ((size_t)bi * n + pix) * c;
    float dot = 0.f;
    for (int ch = 0; ch < c; ++ch) {
      const int o = ch * w;
      // y first (the rows at x0 and x1), then x
      const float r0 = fmaf(wy1, to_float(row1[o + tx.i0]),
                            wy0 * to_float(row0[o + tx.i0]));
      const float r1 = fmaf(wy1, to_float(row1[o + tx.i1]),
                            wy0 * to_float(row0[o + tx.i1]));
      const float s = fmaf(tx.w1, r1, tx.w0 * r0);
      rows[(view * c + ch) * kRow + p] = round_to<T>(s);
      dot = fmaf(s, to_float(cur_p[ch]), dot);
    }
    view_meta_rows<T>(rows, p, view, k, meta, q.mask, q.z_eps, dot, ray,
                      plane, src_loc + (bi * k + view) * 3);
  }
  // Per-pixel rows: reference features, plane, reference ray, pose rows.
  for (int p = tid; p < kTile; p += kHidden) {
    const int pix = min(p0 + p, n - 1);
    pixel_meta_rows<T>(rows, p, k, c, meta, cur + ((size_t)bi * n + pix) * c,
                       load_ray(rays + ((size_t)bi * n + pix) * 3), plane,
                       pose_meta + bi * k * 3);
  }
  __syncthreads();

  mlp_tail<T>(rows, mlp_in_channels(k, c), w0, b0, w1, b1, w2, b2,
              out + ((size_t)bi * d + di) * n + p0, n - p0);
}

template <typename T>
int launch_stack(const void* sampled, const void* mask, const void* depths,
                 const void* cur, const void* rays, const void* planes,
                 const void* pose_meta, const void* src_loc, const void* w0,
                 const void* b0, const void* w1, const void* b1,
                 const void* w2, const void* b2, void* out, int b, int k,
                 int n, int c, int d, cudaStream_t stream) {
  if (c % kVec != 0 || reinterpret_cast<uintptr_t>(sampled) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(cur) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = tail_smem_bytes(mlp_in_channels(k, c));
  cudaError_t err = cudaFuncSetAttribute(
      fused_feature_volume_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kTile - 1) / kTile, d, b);
  fused_feature_volume_kernel<T><<<grid, kHidden, smem, stream>>>(
      static_cast<const T*>(sampled), static_cast<const float*>(mask),
      static_cast<const float*>(depths), static_cast<const T*>(cur),
      static_cast<const float*>(rays), static_cast<const float*>(planes),
      static_cast<const float*>(pose_meta),
      static_cast<const float*>(src_loc), static_cast<const T*>(w0),
      static_cast<const float*>(b0), static_cast<const T*>(w1),
      static_cast<const float*>(b1), static_cast<const T*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(out), b, k, n, c,
      d);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_warp(const void* img, const void* cur, const void* rays,
                const void* planes, const void* proj, const void* pose_meta,
                const void* src_loc, const void* w0, const void* b0,
                const void* w1, const void* b1, const void* w2,
                const void* b2, void* out, int b, int k, int h, int w, int c,
                int d, cudaStream_t stream) {
  const size_t smem = tail_smem_bytes(mlp_in_channels(k, c));
  cudaError_t err = cudaFuncSetAttribute(
      fused_warp_feature_volume_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((h * w + kTile - 1) / kTile, d, b);
  fused_warp_feature_volume_kernel<T><<<grid, kHidden, smem, stream>>>(
      static_cast<const T*>(img), static_cast<const T*>(cur),
      static_cast<const float*>(rays), static_cast<const float*>(planes),
      static_cast<const float*>(proj), static_cast<const float*>(pose_meta),
      static_cast<const float*>(src_loc), static_cast<const T*>(w0),
      static_cast<const float*>(b0), static_cast<const T*>(w1),
      static_cast<const float*>(b1), static_cast<const T*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(out), k, h, w, c, d);
  return (int)cudaGetLastError();
}

}  // namespace

// K5. dtype: 0 = float32, 1 = bfloat16. n = N reference pixels, d the
// planes of this call. Returns a cudaError_t (0 = success).
extern "C" int fused_feature_volume(int dtype, const void* sampled,
                                    const void* mask, const void* depths,
                                    const void* cur, const void* rays,
                                    const void* planes, const void* pose_meta,
                                    const void* src_loc, const void* w0,
                                    const void* b0, const void* w1,
                                    const void* b1, const void* w2,
                                    const void* b2, void* out, int b, int k,
                                    int n, int c, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_stack<float>(sampled, mask, depths, cur, rays, planes,
                               pose_meta, src_loc, w0, b0, w1, b1, w2, b2,
                               out, b, k, n, c, d, s);
  }
  if (dtype == 1) {
    return launch_stack<__nv_bfloat16>(sampled, mask, depths, cur, rays,
                                       planes, pose_meta, src_loc, w0, b0,
                                       w1, b1, w2, b2, out, b, k, n, c, d, s);
  }
  return (int)cudaErrorInvalidValue;
}

// K4. dtype as above; w is the source maps' width (a row holds c * w).
extern "C" int fused_warp_feature_volume(int dtype, const void* img,
                                         const void* cur, const void* rays,
                                         const void* planes, const void* proj,
                                         const void* pose_meta,
                                         const void* src_loc, const void* w0,
                                         const void* b0, const void* w1,
                                         const void* b1, const void* w2,
                                         const void* b2, void* out, int b,
                                         int k, int h, int w, int c, int d,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_warp<float>(img, cur, rays, planes, proj, pose_meta,
                              src_loc, w0, b0, w1, b1, w2, b2, out, b, k, h,
                              w, c, d, s);
  }
  if (dtype == 1) {
    return launch_warp<__nv_bfloat16>(img, cur, rays, planes, proj,
                                      pose_meta, src_loc, w0, b0, w1, b1, w2,
                                      b2, out, b, k, h, w, c, d, s);
  }
  return (int)cudaErrorInvalidValue;
}
