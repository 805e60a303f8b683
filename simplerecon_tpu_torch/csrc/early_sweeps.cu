// The hero feature volume's two earlier sweep kernels: the metadata + MLP
// tail over a pre-warped stack (K5) and the full-width fused warp (K4).
// Both compute what K1 (fused_sweep.cu) computes, with the JAX kernels'
// own rounding points. Each has two kernels, by the compute dtype, built
// as K1's are:
// * bf16 (the kernels the hero model's "pallas_v1" and "pallas_full"
//   backends run): the MLP on the tensor cores, K1's tile (`MlpTile` of
//   sweep_common.cuh, `mlp_rows` of sweep_mma.cuh). Persistent blocks of
//   256 threads, one an SM, copy W0 (zero rows to C_in = 208) and W1 into
//   shared memory once, then walk work items of 128 cells (128 reference
//   pixels at one (batch, plane)): all threads fill the bf16 input tile X
//   with the kernel's own fill, then warp i runs the MLP of rows
//   [16i, 16i + 16). Shared memory at C_in = 202: 148,224 B, as K1's;
//   registers (ptxas) K5 179 a thread, K4 182, no spills.
// * float32: one block per (pixel tile of 64, plane, batch element), 128
//   threads, the tile's C_in input rows in shared memory, and K1's
//   CUDA-core MLP (`mlp_tail` and its helpers in sweep_common.cuh); the
//   card-against-CPU checks run it, and tensor cores would take float32
//   as TF32.
//
// K5, fused_feature_volume_kernel (float32) and
// fused_feature_volume_mma_kernel (bf16), replaces simplerecon_tpu/ops/
// pallas_cv.py::fused_feature_volume (body _kernel, tail _metadata_mlp;
// backend "pallas_v1"). Inputs: the warped stack sampled (k, b*d*N, c) in
// the compute dtype T, rows ordered (b, d, N), d the planes of this call
// (one chunk of planes); mask and depths (k, b*d*N) float32; cur (b, N, c)
// in T; unnormalised rays (b, N, 3), planes (b, d), pose_meta and src_loc
// (b, k, 3) float32; w0 (C_in, 128), w1 (128, 128), w2 (128, 1) in T and
// float32 biases. The samples come in already rounded to T, so the dot
// rows are taken from the rounded samples. Each (pixel, view) item reads
// its stack row of c elements with 16-byte vector loads (c a multiple of
// 8; the wrapper checks) and its mask and depth as float32; neighbouring
// threads read neighbouring rows. In bf16 the row is copied into X as it
// is. What bounds it on an H100: its device memory stream and its MLP are
// about equal. At hero b1 bf16 the stack is 176 MB and mask and depth add
// 44 MB: 0.067 ms at 3.35 TB/s, against 66.6 GFLOP of MLP, 0.067 ms on
// the bf16 tensor cores.
//
// K4, fused_warp_feature_volume_kernel (float32) and
// fused_warp_feature_volume_mma_kernel (bf16), replaces pallas_cv.py::
// fused_warp_feature_volume (body _warp_kernel, taps _twohot_weights;
// backend "pallas_full"). Inputs: source maps img (b, k, h, c*w) in T
// with c-major rows (element (y, ch, x) at y*c*w + ch*w + x); cur, rays,
// planes, pose_meta, src_loc and the MLP as for K5; proj = K @ src_T_cur
// (b, k, 4, 4) float32. Each (pixel, view) item projects the plane point
// as K1 does (`project`), then samples separably as the TPU kernel's
// two-hot products do: the y taps' weights rounded to T, the two rows
// combined first, then the x taps with float32 weights. The samples stay
// float32 for the dot rows and are rounded to T as MLP inputs; mask =
// z + eps > 0 and depth = z + eps. Its device memory traffic is small
// (the maps, cur, rays and the float32 output; one (b, view) map is
// 0.4 MB in bf16 at hero size), so the taps come from L1 and L2: with
// the MLP on the tensor cores, the fill's tap loads set the pace, as
// K1's fill sets K1's. The two x taps of a channel are neighbours in a
// c-major row: the bf16 kernel reads both with one 8-byte load where they
// fall in one aligned group of four (w % 4 == 0; three x positions in
// four), else two 2-byte loads; the float32 kernel reads each alone.
//
// Output of both: (b, d, N) float32 scores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sweep_common.cuh"

namespace {

constexpr int kVec = 8;  // stack channels per 16-byte vector load (K5)

// Loads kVec float32 channels from a 16-byte-aligned address.
__device__ __forceinline__ void load_vec(const float* p, float (&v)[kVec]) {
  const float4* q = reinterpret_cast<const float4*>(p);
  const float4 a = q[0], b = q[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
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

// ---- K5 in bf16 on the tensor cores --------------------------------------
__global__ void __launch_bounds__(kMmaThreads, 1)
fused_feature_volume_mma_kernel(const bf16* __restrict__ sampled,
                                const float* __restrict__ mask,
                                const float* __restrict__ depths,
                                const bf16* __restrict__ cur,
                                const float* __restrict__ rays,
                                const float* __restrict__ planes,
                                const float* __restrict__ pose_meta,
                                const float* __restrict__ src_loc,
                                const bf16* __restrict__ w0,
                                const float* __restrict__ b0,
                                const bf16* __restrict__ w1,
                                const float* __restrict__ b1,
                                const bf16* __restrict__ w2,
                                const float* __restrict__ b2,
                                float* __restrict__ out, int b, int k, int n,
                                int c, int d) {
  extern __shared__ uint4 smem_u4[];
  const MlpTile s = load_mlp_tile(smem_u4, w0, b0, w1, b1, w2, b2,
                                  mlp_in_channels(k, c));
  constexpr int M = kMmaCells;
  const int meta = (k + 1) * c;
  const size_t n_rows = (size_t)b * d * n;  // stack rows a view
  const int tiles = (n + M - 1) / M;
  for (int item = blockIdx.x; item < b * d * tiles; item += gridDim.x) {
    const int tile = item % tiles;
    const int di = (item / tiles) % d;
    const int bi = item / (tiles * d);
    const int p0 = tile * M;
    const float plane = planes[bi * d + di];
    const size_t cell0 = ((size_t)bi * d + di) * n;  // this (b, plane)
    __syncthreads();  // weights loaded; the previous item's X consumed
    for (int it = threadIdx.x; it < M * (k + 1); it += kMmaThreads) {
      const int m = it < M * k ? it % M : it - M * k;
      const int pix = min(p0 + m, n - 1);  // ragged last tile: not stored
      const bf16* cur_p = cur + ((size_t)bi * n + pix) * c;
      const float3 ray = load_ray(rays + ((size_t)bi * n + pix) * 3);
      bf16* x = s.X + m * s.xs;
      if (it >= M * k) {
        pixel_meta_bf16(x, meta, k, c, cur_p, ray, plane,
                        pose_meta + bi * k * 3, true);
        continue;
      }
      const int view = it / M;
      const size_t row = view * n_rows + cell0 + pix;
      const bf16* sp = sampled + row * c;
      float dot = 0.f;
      for (int ch0 = 0; ch0 < c; ch0 += kVec) {
        const uint4 u = *reinterpret_cast<const uint4*>(sp + ch0);
        *reinterpret_cast<uint4*>(x + view * c + ch0) = u;
        float sv[kVec], cv[kVec];
        unpack8(u, sv);
        load8(cur_p + ch0, cv);
#pragma unroll
        for (int e = 0; e < kVec; ++e) dot = fmaf(sv[e], cv[e], dot);
      }
      view_meta_bf16(x, meta, k, view, mask[row], depths[row], dot, ray,
                     plane, src_loc + (bi * k + view) * 3);
    }
    __syncthreads();
    mlp_tile_out(s, out + cell0 + p0, n - p0);
  }
}

// ---- K4 in bf16 on the tensor cores --------------------------------------
// The float32 value of bf16 bits.
__device__ __forceinline__ float bf16_bits(unsigned bits) {
  return __uint_as_float((bits & 0xffffu) << 16);
}

// The x taps (i0, i1) of one channel's row r of a c-major map: one 8-byte
// load of the aligned group of four that holds both where `pair`
// (i1 == i0 + 1, i0 % 4 != 3, the row 8-byte aligned), else two loads.
__device__ __forceinline__ float2 x_taps(const bf16* r, int i0, int i1,
                                         bool pair) {
  if (pair) {
    const unsigned long long q =
        *reinterpret_cast<const unsigned long long*>(r + (i0 & ~3)) >>
        (16 * (i0 & 3));
    return make_float2(bf16_bits((unsigned)q), bf16_bits((unsigned)(q >> 16)));
  }
  return make_float2(__bfloat162float(r[i0]), __bfloat162float(r[i1]));
}

__global__ void __launch_bounds__(kMmaThreads, 1)
fused_warp_feature_volume_mma_kernel(const bf16* __restrict__ img,
                                     const bf16* __restrict__ cur,
                                     const float* __restrict__ rays,
                                     const float* __restrict__ planes,
                                     const float* __restrict__ proj,
                                     const float* __restrict__ pose_meta,
                                     const float* __restrict__ src_loc,
                                     const bf16* __restrict__ w0,
                                     const float* __restrict__ b0,
                                     const bf16* __restrict__ w1,
                                     const float* __restrict__ b1,
                                     const bf16* __restrict__ w2,
                                     const float* __restrict__ b2,
                                     float* __restrict__ out, int b, int k,
                                     int h, int w, int c, int d, int vec8,
                                     int pairs) {
  extern __shared__ uint4 smem_u4[];
  const MlpTile s = load_mlp_tile(smem_u4, w0, b0, w1, b1, w2, b2,
                                  mlp_in_channels(k, c));
  constexpr int M = kMmaCells;
  const int n = h * w;
  const int meta = (k + 1) * c;
  const size_t map = (size_t)h * c * w;  // elements of one (b, view) map
  const int tiles = (n + M - 1) / M;
  for (int item = blockIdx.x; item < b * d * tiles; item += gridDim.x) {
    const int tile = item % tiles;
    const int di = (item / tiles) % d;
    const int bi = item / (tiles * d);
    const int p0 = tile * M;
    const float plane = planes[bi * d + di];
    __syncthreads();  // weights loaded; the previous item's X consumed
    for (int it = threadIdx.x; it < M * (k + 1); it += kMmaThreads) {
      const int m = it < M * k ? it % M : it - M * k;
      const int pix = min(p0 + m, n - 1);  // ragged last tile: not stored
      const bf16* cur_p = cur + ((size_t)bi * n + pix) * c;
      const float3 ray = load_ray(rays + ((size_t)bi * n + pix) * 3);
      bf16* x = s.X + m * s.xs;
      if (it >= M * k) {
        pixel_meta_bf16(x, meta, k, c, cur_p, ray, plane,
                        pose_meta + bi * k * 3, vec8 != 0);
        continue;
      }
      const int view = it / M;
      const Projection q = project(proj + (bi * k + view) * 16,
                                   ray.x * plane, ray.y * plane,
                                   ray.z * plane);
      const TwoHot tx = two_hot(q.u - 0.5f, w);
      const TwoHot ty = two_hot(q.v - 0.5f, h);
      const float wy0 = round_bf16(ty.w0), wy1 = round_bf16(ty.w1);
      const bool pair = pairs && tx.i1 == tx.i0 + 1 && (tx.i0 & 3) != 3;
      const bf16* base = img + (bi * k + view) * map;
      const bf16* row0 = base + (size_t)ty.i0 * c * w;
      const bf16* row1 = base + (size_t)ty.i1 * c * w;
      float dot = 0.f;
      for (int ch0 = 0; ch0 < c; ch0 += 8) {
        const int nc = min(8, c - ch0);
        float sv[8] = {};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (e >= nc) break;
          const int o = (ch0 + e) * w;
          // y first (the rows at x0 and x1), then x
          const float2 t0 = x_taps(row0 + o, tx.i0, tx.i1, pair);
          const float2 t1 = x_taps(row1 + o, tx.i0, tx.i1, pair);
          const float r0 = fmaf(wy1, t1.x, wy0 * t0.x);
          const float r1 = fmaf(wy1, t1.y, wy0 * t0.y);
          sv[e] = fmaf(tx.w1, r1, tx.w0 * r0);
          dot = fmaf(sv[e], __bfloat162float(cur_p[ch0 + e]), dot);
        }
        if (vec8) {
          *reinterpret_cast<uint4*>(x + view * c + ch0) =
              make_uint4(pack_bf16(sv[0], sv[1]), pack_bf16(sv[2], sv[3]),
                         pack_bf16(sv[4], sv[5]), pack_bf16(sv[6], sv[7]));
        } else {
          for (int e = 0; e < nc; ++e) {
            x[view * c + ch0 + e] = __float2bfloat16_rn(sv[e]);
          }
        }
      }
      view_meta_bf16(x, meta, k, view, q.mask, q.z_eps, dot, ray, plane,
                     src_loc + (bi * k + view) * 3);
    }
    __syncthreads();
    mlp_tile_out(s, out + ((size_t)bi * d + di) * n + p0, n - p0);
  }
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

int launch_stack_mma(const void* sampled, const void* mask,
                     const void* depths, const void* cur, const void* rays,
                     const void* planes, const void* pose_meta,
                     const void* src_loc, const void* w0, const void* b0,
                     const void* w1, const void* b1, const void* w2,
                     const void* b2, void* out, int b, int k, int n, int c,
                     int d, cudaStream_t stream) {
  if (c % kVec != 0 || reinterpret_cast<uintptr_t>(sampled) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(cur) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = mma_smem_bytes(mlp_in_channels(k, c));
  cudaError_t err = cudaFuncSetAttribute(
      fused_feature_volume_mma_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks =
      persistent_blocks((long)b * d * ((n + kMmaCells - 1) / kMmaCells));
  fused_feature_volume_mma_kernel<<<blocks, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(sampled), static_cast<const float*>(mask),
      static_cast<const float*>(depths), static_cast<const bf16*>(cur),
      static_cast<const float*>(rays), static_cast<const float*>(planes),
      static_cast<const float*>(pose_meta),
      static_cast<const float*>(src_loc), static_cast<const bf16*>(w0),
      static_cast<const float*>(b0), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(out), b, k, n, c,
      d);
  return (int)cudaGetLastError();
}

int launch_warp_mma(const void* img, const void* cur, const void* rays,
                    const void* planes, const void* proj,
                    const void* pose_meta, const void* src_loc,
                    const void* w0, const void* b0, const void* w1,
                    const void* b1, const void* w2, const void* b2,
                    void* out, int b, int k, int h, int w, int c, int d,
                    cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(mlp_in_channels(k, c));
  cudaError_t err = cudaFuncSetAttribute(
      fused_warp_feature_volume_mma_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks =
      persistent_blocks((long)b * d * ((h * w + kMmaCells - 1) / kMmaCells));
  const int vec8 = c % 8 == 0 && reinterpret_cast<uintptr_t>(cur) % 16 == 0;
  const int pairs = w % 4 == 0 && reinterpret_cast<uintptr_t>(img) % 8 == 0;
  fused_warp_feature_volume_mma_kernel<<<blocks, kMmaThreads, smem,
                                         stream>>>(
      static_cast<const bf16*>(img), static_cast<const bf16*>(cur),
      static_cast<const float*>(rays), static_cast<const float*>(planes),
      static_cast<const float*>(proj), static_cast<const float*>(pose_meta),
      static_cast<const float*>(src_loc), static_cast<const bf16*>(w0),
      static_cast<const float*>(b0), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(out), b, k, h, w, c,
      d, vec8, pairs);
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
    return launch_stack_mma(sampled, mask, depths, cur, rays, planes,
                            pose_meta, src_loc, w0, b0, w1, b1, w2, b2, out,
                            b, k, n, c, d, s);
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
    return launch_warp_mma(img, cur, rays, planes, proj, pose_meta, src_loc,
                           w0, b0, w1, b1, w2, b2, out, b, k, h, w, c, d, s);
  }
  return (int)cudaErrorInvalidValue;
}
