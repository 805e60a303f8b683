// Fused plane sweep for the hero model's feature volume: projection,
// bilinear warp, 202-channel metadata and the MLP C_in -> 128 -> 128 -> 1,
// in one kernel.
//
// Replaces the TPU kernel simplerecon_tpu/ops/pallas_cv.py::
// banded_warp_feature_volume (mode "mlp"; body _banded_kernel, launched by
// _banded_call). That kernel samples with two-hot matrix products over
// y-banded source tiles, because gathers starve the TPU's matrix unit.
// Here each sample is four direct tap loads: one (b, view) feature map is
// h*w*c elements (2.75 MB for all 7 hero views in bf16), so the taps hit
// L2.
//
// What bounds it on an H100: the MLP, 2*(202*128 + 128*128 + 128) =
// 84.7 kFLOP per (pixel, plane), 66.6 GFLOP per hero frame (b=1, d=64,
// N=12288), against 0.5 MB of feature reads per plane. This first version
// runs the MLP on the CUDA cores in float32 FMAs (no tensor cores), so it
// is bound by FMA issue and the shared-memory reads that feed them.
//
// Design: one block per (pixel tile of 64, plane, batch element), one
// thread per hidden channel (128 threads).
//   1. The block assembles the tile's MLP inputs, rounded to the compute
//      dtype, in shared memory as rows of 64 pixels (row stride 68 floats,
//      so the float4 row writes of phase 3 do not collide in banks).
//      202 rows * 272 B = 54.9 KB: dynamic shared memory above 48 KB.
//   2. Thread j keeps the 64 pixels' sums for hidden channel j in
//      registers. Each input row is read as float4 broadcasts from shared
//      memory; the thread's weight w[i][j] is one coalesced load per row.
//   3. The rounded activations overwrite the inputs in shared memory and
//      feed the next layer; the last layer (128 -> 1) is a per-pixel dot
//      over the shared activations.
// Inputs: src (b,k,h,w,c), cur (b,N,c), w0 (C_in,128), w1 (128,128),
// w2 (128,1) in the compute dtype T; proj = K @ src_T_cur (b,k,4,4),
// invK (b,4,4), planes (b,d), pose_meta (b,k,3), src_loc (b,k,3) and the
// biases in float32. Output (b,d,N) float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

template <typename T>
__global__ void __launch_bounds__(kHidden)
fused_sweep_mlp_kernel(const T* __restrict__ src, const T* __restrict__ cur,
                       const float* __restrict__ proj,
                       const float* __restrict__ invK,
                       const float* __restrict__ planes,
                       const float* __restrict__ pose_meta,
                       const float* __restrict__ src_loc,
                       const T* __restrict__ w0, const float* __restrict__ b0,
                       const T* __restrict__ w1, const float* __restrict__ b1,
                       const T* __restrict__ w2, const float* __restrict__ b2,
                       float* __restrict__ out, int k, int h, int w, int c,
                       int d) {
  extern __shared__ float4 smem4[];
  float* rows = reinterpret_cast<float*>(smem4);

  const int n = h * w;
  const int cin = (k + 1) * c + 10 * k + 4;
  const int meta = (k + 1) * c;  // first metadata row
  const int p0 = blockIdx.x * kTile;
  const int di = blockIdx.y;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const float plane = planes[bi * d + di];
  const float* ik = invK + bi * 16;

  // ---- 1. MLP inputs ----------------------------------------------------
  // Per-view rows: one item per (pixel, view).
  for (int item = tid; item < kTile * k; item += kHidden) {
    const int p = item % kTile;
    const int view = item / kTile;
    const int pix = min(p0 + p, n - 1);  // ragged last tile: not stored
    const float px = (pix % w) + 0.5f;
    const float py = (pix / w) + 0.5f;
    const float rx = ik[0] * px + ik[1] * py + ik[2];
    const float ry = ik[4] * px + ik[5] * py + ik[6];
    const float rz = ik[8] * px + ik[9] * py + ik[10];
    const float wx = rx * plane, wy = ry * plane, wz = rz * plane;

    // eps-safe projection (ops/geometry.py::project_points)
    const float* P = proj + (bi * k + view) * 16;
    const float cx = P[0] * wx + P[1] * wy + P[2] * wz + P[3];
    const float cy = P[4] * wx + P[5] * wy + P[6] * wz + P[7];
    const float cz = P[8] * wx + P[9] * wy + P[10] * wz + P[11];
    const float z_eps = cz + 1e-8f;
    const float scale = fabsf(cz) > 1e-8f ? 1.0f / z_eps : 1.0f;
    const float u = cx * scale, v = cy * scale;
    const float mask = z_eps > 0.f ? 1.f : 0.f;

    // bilinear taps at index coords (u - 0.5, v - 0.5), zeros outside
    const float ix = u - 0.5f, iy = v - 0.5f;
    const float x0 = floorf(ix), y0 = floorf(iy);
    const float x1 = x0 + 1.f, y1 = y0 + 1.f;
    const bool vx0 = x0 >= 0.f && x0 <= w - 1.f;
    const bool vx1 = x1 >= 0.f && x1 <= w - 1.f;
    const bool vy0 = y0 >= 0.f && y0 <= h - 1.f;
    const bool vy1 = y1 >= 0.f && y1 <= h - 1.f;
    const int xi0 = vx0 ? (int)x0 : 0, xi1 = vx1 ? (int)x1 : 0;
    const int yi0 = vy0 ? (int)y0 : 0, yi1 = vy1 ? (int)y1 : 0;
    const float w_nw = (vx0 && vy0) ? (x1 - ix) * (y1 - iy) : 0.f;
    const float w_ne = (vx1 && vy0) ? (ix - x0) * (y1 - iy) : 0.f;
    const float w_sw = (vx0 && vy1) ? (x1 - ix) * (iy - y0) : 0.f;
    const float w_se = (vx1 && vy1) ? (ix - x0) * (iy - y0) : 0.f;
    const T* img = src + (size_t)(bi * k + view) * n * c;
    const T* t_nw = img + (size_t)(yi0 * w + xi0) * c;
    const T* t_ne = img + (size_t)(yi0 * w + xi1) * c;
    const T* t_sw = img + (size_t)(yi1 * w + xi0) * c;
    const T* t_se = img + (size_t)(yi1 * w + xi1) * c;
    const T* cur_p = cur + ((size_t)bi * n + pix) * c;

    float dot = 0.f;
    for (int ch = 0; ch < c; ++ch) {
      const float s = w_nw * to_float(t_nw[ch]) + w_ne * to_float(t_ne[ch]) +
                      w_sw * to_float(t_sw[ch]) + w_se * to_float(t_se[ch]);
      rows[(view * c + ch) * kRow + p] = round_to<T>(s);
      dot = fmaf(s, to_float(cur_p[ch]), dot);
    }

    // unit rays from the reference and the source camera centre
    const float ref_inv = 1.0f / sqrtf(rx * rx + ry * ry + rz * rz + 1e-30f);
    const float* loc = src_loc + (bi * k + view) * 3;
    const float sx = wx - loc[0], sy = wy - loc[1], sz = wz - loc[2];
    const float src_inv = 1.0f / sqrtf(sx * sx + sy * sy + sz * sz + 1e-30f);
    const float angle =
        (rx * ref_inv) * (sx * src_inv) + (ry * ref_inv) * (sy * src_inv) +
        (rz * ref_inv) * (sz * src_inv);

    rows[(meta + view) * kRow + p] = mask;
    rows[(meta + k + view) * kRow + p] = round_to<T>(z_eps);
    rows[(meta + 2 * k + 1 + view) * kRow + p] = round_to<T>(dot * mask);
    rows[(meta + 3 * k + 1 + view) * kRow + p] = round_to<T>(angle);
    const int sray = meta + 4 * k + 4 + 3 * view;
    rows[(sray + 0) * kRow + p] = round_to<T>(sx * src_inv);
    rows[(sray + 1) * kRow + p] = round_to<T>(sy * src_inv);
    rows[(sray + 2) * kRow + p] = round_to<T>(sz * src_inv);
  }
  // Per-pixel rows: reference features, plane, reference ray, pose rows.
  for (int p = tid; p < kTile; p += kHidden) {
    const int pix = min(p0 + p, n - 1);
    const T* cur_p = cur + ((size_t)bi * n + pix) * c;
    for (int ch = 0; ch < c; ++ch) {
      rows[(k * c + ch) * kRow + p] = to_float(cur_p[ch]);
    }
    const float px = (pix % w) + 0.5f;
    const float py = (pix / w) + 0.5f;
    const float rx = ik[0] * px + ik[1] * py + ik[2];
    const float ry = ik[4] * px + ik[5] * py + ik[6];
    const float rz = ik[8] * px + ik[9] * py + ik[10];
    const float ref_inv = 1.0f / sqrtf(rx * rx + ry * ry + rz * rz + 1e-30f);
    rows[(meta + 2 * k) * kRow + p] = round_to<T>(plane);
    rows[(meta + 4 * k + 1) * kRow + p] = round_to<T>(rx * ref_inv);
    rows[(meta + 4 * k + 2) * kRow + p] = round_to<T>(ry * ref_inv);
    rows[(meta + 4 * k + 3) * kRow + p] = round_to<T>(rz * ref_inv);
    for (int jv = 0; jv < 3 * k; ++jv) {  // [penalty(k), R(k), t(k)]
      const int j = jv / k, view = jv % k;
      rows[(meta + 7 * k + 4 + jv) * kRow + p] =
          round_to<T>(pose_meta[(bi * k + view) * 3 + j]);
    }
  }
  __syncthreads();

  // ---- 2. the MLP -------------------------------------------------------
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

  if (tid < kTile && p0 + tid < n) {
    float o = 0.f;
    for (int j = 0; j < kHidden; ++j) {
      o = fmaf(rows[j * kRow + tid], to_float(w2[j]), o);
    }
    out[((size_t)bi * d + di) * n + p0 + tid] = o + b2[0];
  }
}

template <typename T>
int launch(const void* src, const void* cur, const void* proj,
           const void* invK, const void* planes, const void* pose_meta,
           const void* src_loc, const void* w0, const void* b0,
           const void* w1, const void* b1, const void* w2, const void* b2,
           void* out, int b, int k, int h, int w, int c, int d,
           cudaStream_t stream) {
  const int cin = (k + 1) * c + 10 * k + 4;
  const int n_rows = cin > kHidden ? cin : kHidden;
  const size_t smem = (size_t)n_rows * kRow * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_sweep_mlp_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((h * w + kTile - 1) / kTile, d, b);
  fused_sweep_mlp_kernel<T><<<grid, kHidden, smem, stream>>>(
      static_cast<const T*>(src), static_cast<const T*>(cur),
      static_cast<const float*>(proj), static_cast<const float*>(invK),
      static_cast<const float*>(planes), static_cast<const float*>(pose_meta),
      static_cast<const float*>(src_loc), static_cast<const T*>(w0),
      static_cast<const float*>(b0), static_cast<const T*>(w1),
      static_cast<const float*>(b1), static_cast<const T*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(out), k, h, w, c, d);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = success).
extern "C" int fused_sweep_mlp(int dtype, const void* src, const void* cur,
                               const void* proj, const void* invK,
                               const void* planes, const void* pose_meta,
                               const void* src_loc, const void* w0,
                               const void* b0, const void* w1, const void* b1,
                               const void* w2, const void* b2, void* out,
                               int b, int k, int h, int w, int c, int d,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(src, cur, proj, invK, planes, pose_meta, src_loc, w0,
                         b0, w1, b1, w2, b2, out, b, k, h, w, c, d, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(src, cur, proj, invK, planes, pose_meta,
                                 src_loc, w0, b0, w1, b1, w2, b2, out, b, k,
                                 h, w, c, d, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* fused_sweep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
