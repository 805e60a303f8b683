// The transpose of the sweeps' bilinear warp: each sample gradient d_s of
// a (pixel, plane, view) goes to the four taps it was sampled from, times
// their weights, summed into d_src (b, k, h, w, c). It serves K2
// (fused_sweep_bwd.cu, which writes the sample gradients d_s) and the dot
// model's backward (ops/cuda_cv.py::dot_sweep_backward, where d_s =
// mask * g * cur is formed here and never stored).
//
// It replaces the scatter half of the TPU kernel simplerecon_tpu/ops/
// pallas_cv.py::banded_warp_feature_volume_bwd (the d_img accumulation of
// _banded_bwd_kernel, :914-916), whose grid runs in order, so its sums
// come in one fixed order. Here blocks run in no order, and float32
// atomics would sum in another order on every run. So the sums are
// integers: each contribution w_tap * d_s (a float32 product) is scaled
// by 2^S and rounded to a 64-bit integer, the integers are added with
// 64-bit atomics (two's complement, so the order does not change the
// sum), and a last pass converts each sum to float32 times 2^-S. S comes
// from a bound M on |d_s| (K2: the largest |d_s|, which it finds with an
// order-free atomicMax; the dot model: max |g| * max |cur|): at most
// count = 4 * d * N contributions reach one element, each at most M, so
// with M < 2^e and count <= 2^L, S = 62 - L - e keeps every sum within
// 2^62. At hero b16 (d = 64, N = 12,288, L = 22) a contribution keeps
// the bits down to 2^-40 M, finer than float32's 2^-24 of M, so the sums
// are as exact as float32 sums and the same on every run.
// `sweep_scatter_reference` in ops/cuda_cv.py is the plain version: the
// same integers summed with index_add_ on int64.
//
// What bounds it on an H100: the atomics. At hero b16 there are b*d*N*k =
// 88 M samples, 4 taps of c = 16 channels each: 5.6 G 64-bit atomic adds
// into a 176 MB accumulator that L2 mostly holds, against 2.8 GB of bf16
// d_s read once (0.84 ms at 3.35 TB/s). The L2 serves atomics by the
// 32-byte sector, so the design makes each atomic instruction of a warp
// touch as few sectors as it can: a warp owns 32 neighbouring pixels at
// one (plane, batch element) and loops over the views; each lane
// projects its own pixel (`project_taps`, K1's and K2's arithmetic, whose
// expressions are those of K2's float32 `view_geom`) and leaves the taps
// in shared memory, and the warp copies its 32 d_s rows (contiguous in
// d_s, so the loads coalesce) beside them; then the warp takes its 32
// samples in turn, lane (tap q, channel ch) adding that tap's channel, so
// one instruction adds two taps' 16 channels (two 128-byte rows, 8
// sectors) where one lane per sample would touch 32 rows. Taps of zero
// weight, masked samples and contributions that round to zero are
// skipped.
//
// Inputs: d_s (b, k, d, N, c) in T (K2), or g (b, d, N) float32 and cur
// (b, N, c) in T (the dot model); proj = K @ src_T_cur (b, k, 4, 4),
// invK (b, 4, 4), planes (b, d) and max_abs (1) float32. acc (b, k, h*w,
// c) int64 is zeroed by the caller; d_src (b, k, h, w, c) float32 out.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sweep_common.cuh"

namespace {

constexpr int kScatterThreads = 256;  // pixels per block

// S of the fixed-point sums: 62 - L - e for max_abs < 2^e and count <=
// 2^L, clamped to [-100, 100] so that 2^S and 2^-S are normal floats; 0
// when max_abs is 0 or not finite.
__device__ __forceinline__ int fixed_point_shift(float max_abs,
                                                 long long count) {
  if (!(max_abs > 0.f) || !isfinite(max_abs)) return 0;
  int e;
  frexpf(max_abs, &e);
  const int l = 64 - __clzll(count - 1);
  return min(max(62 - l - e, -100), 100);
}

__device__ __forceinline__ float pow2(int s) {
  return __int_as_float((127 + s) << 23);
}

template <typename T, bool kDot>
__global__ void __launch_bounds__(kScatterThreads)
sweep_scatter_kernel(const T* __restrict__ d_s, const float* __restrict__ g,
                     const T* __restrict__ cur,
                     const float* __restrict__ proj,
                     const float* __restrict__ invK,
                     const float* __restrict__ planes,
                     const float* __restrict__ max_abs,
                     unsigned long long* __restrict__ acc, int k, int h,
                     int w, int c, int d) {
  // this view's taps of the block's pixels, and their factor m (the dot
  // model's mask * g; 1 for K2's samples; 0 past the last pixel); their
  // d_s rows (K2) or cur rows (the dot model), c float32 values each
  __shared__ int tap_pix[kScatterThreads][4];
  __shared__ float tap_wt[kScatterThreads][4];
  __shared__ float tap_m[kScatterThreads];
  extern __shared__ float row_s[];
  const int n = h * w;
  const int lane = threadIdx.x & 31;
  const int first = threadIdx.x & ~31;  // this warp's first slot
  const int pix0 = blockIdx.x * kScatterThreads + first;
  const int pix = pix0 + lane;
  const int di = blockIdx.y;
  const int bi = blockIdx.z;
  if (pix0 >= n) return;  // the whole warp is past the last pixel
  const bool inside = pix < n;
  const float scale = pow2(fixed_point_shift(*max_abs, 4LL * d * n));
  const float plane = planes[bi * d + di];
  const float3 ray = pixel_ray(invK + bi * 16, min(pix, n - 1), w);
  const float gv = kDot && inside ? g[((size_t)bi * d + di) * n + pix] : 1.f;
  // the warp's 32 rows are contiguous in d_s and in cur: lane i copies
  // elements i, i + 32, ... into shared memory (coalesced, conflict-free)
  float* rows_w = row_s + first * c;
  const int size = min(32, n - pix0) * c;
  if (kDot) {
    const T* src = cur + ((size_t)bi * n + pix0) * c;
    for (int i = lane; i < 32 * c; i += 32) {
      rows_w[i] = i < size ? to_float(src[i]) : 0.f;
    }
  }
  for (int view = 0; view < k; ++view) {
    const Taps t = project_taps(proj + (bi * k + view) * 16, ray.x * plane,
                                ray.y * plane, ray.z * plane, h, w);
    __syncwarp();  // the previous view's taps and rows are consumed
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      tap_pix[threadIdx.x][q] = t.pix[q];
      tap_wt[threadIdx.x][q] = t.wt[q];
    }
    tap_m[threadIdx.x] = inside ? (kDot ? t.mask * gv : 1.f) : 0.f;
    if (!kDot) {
      const T* src =
          d_s + ((((size_t)bi * k + view) * d + di) * n + pix0) * c;
      for (int i = lane; i < 32 * c; i += 32) {
        rows_w[i] = i < size ? to_float(src[i]) : 0.f;
      }
    }
    __syncwarp();
    unsigned long long* dst = acc + (size_t)(bi * k + view) * n * c;
    // lane (tap q, channel ch) of each of the warp's samples in turn: one
    // atomic instruction adds a tap's c channels, contiguous in d_src
    for (int e = lane; e < 4 * c; e += 32) {
      const int q = e / c, ch = e - q * c;
      for (int j = 0; j < 32; ++j) {
        const float m = tap_m[first + j];
        const float wt = tap_wt[first + j][q];
        if (m == 0.f || wt == 0.f) continue;
        const float v = rows_w[j * c + ch];
        const float ds = kDot ? __fmul_rn(m, v) : v;
        const long long fixed =
            __float2ll_rn(__fmul_rn(__fmul_rn(ds, wt), scale));
        if (fixed != 0) {
          atomicAdd(dst + (size_t)tap_pix[first + j][q] * c + ch,
                    static_cast<unsigned long long>(fixed));
        }
      }
    }
  }
}

// d_src = acc * 2^-S; NaN everywhere when max_abs is not finite (a
// non-finite d_s has no fixed-point form).
__global__ void fixed_to_float_kernel(const long long* __restrict__ acc,
                                      const float* __restrict__ max_abs,
                                      float* __restrict__ out, size_t size,
                                      long long count) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  const float m = *max_abs;
  out[i] = isfinite(m)
               ? __fmul_rn(__ll2float_rn(acc[i]),
                           pow2(-fixed_point_shift(m, count)))
               : m - m;
}

template <typename T>
int launch_scatter(int dot, const void* d_s, const void* g, const void* cur,
                   const void* proj, const void* invK, const void* planes,
                   const void* max_abs, void* acc, void* d_src, int b, int k,
                   int h, int w, int c, int d, cudaStream_t stream) {
  const int n = h * w;
  const dim3 grid((n + kScatterThreads - 1) / kScatterThreads, d, b);
  auto kernel = dot ? sweep_scatter_kernel<T, true>
                    : sweep_scatter_kernel<T, false>;
  const size_t smem = (size_t)kScatterThreads * c * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kScatterThreads, smem, stream>>>(
      static_cast<const T*>(d_s), static_cast<const float*>(g),
      static_cast<const T*>(cur), static_cast<const float*>(proj),
      static_cast<const float*>(invK), static_cast<const float*>(planes),
      static_cast<const float*>(max_abs),
      static_cast<unsigned long long*>(acc), k, h, w, c, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t size = (size_t)b * k * n * c;
  fixed_to_float_kernel<<<(unsigned)((size + 255) / 256), 256, 0, stream>>>(
      static_cast<const long long*>(acc), static_cast<const float*>(max_abs),
      static_cast<float*>(d_src), size, 4LL * d * n);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of d_s or cur). dot = 0: the samples'
// gradients d_s (g and cur unused, may be null); dot = 1: d_s = mask * g
// * cur (d_s unused). Returns a cudaError_t (0 = success).
extern "C" int sweep_scatter(int dtype, int dot, const void* d_s,
                             const void* g, const void* cur,
                             const void* proj, const void* invK,
                             const void* planes, const void* max_abs,
                             void* acc, void* d_src, int b, int k, int h,
                             int w, int c, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_scatter<float>(dot, d_s, g, cur, proj, invK, planes,
                                 max_abs, acc, d_src, b, k, h, w, c, d, s);
  }
  if (dtype == 1) {
    return launch_scatter<__nv_bfloat16>(dot, d_s, g, cur, proj, invK,
                                         planes, max_abs, acc, d_src, b, k,
                                         h, w, c, d, s);
  }
  return (int)cudaErrorInvalidValue;
}
