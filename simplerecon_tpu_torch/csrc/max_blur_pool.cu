// Fused anti-aliased max-blur-pool of the matching encoder's stem, and its
// backward: a 2x2 stride-1 VALID max-pool, a reflect pad (1, 2, 1, 2) and
// the depthwise [1,3,3,1] x [1,3,3,1] / 64 blur at stride 2, on NCHW maps.
//
// Replaces the TPU kernels simplerecon_tpu/ops/pallas_pool.py::
// max_blur_pool_pallas (forward: _fwd_pallas, body _fwd_kernel) and
// _bwd_pallas (body _bwd_kernel), which hold row tiles with halo rows in
// VMEM and run the W blur as a banded matrix product on the MXU. Here
// the blur is 16 taps a thread, read through L1, and the reflection is
// an index map.
//
// What bounds it on an H100: device memory. At hero b16 the input is
// (128, 64, 192, 256): the forward reads it once and writes a quarter of
// it (1.0 GB in bf16, 0.30 ms at 3.35 TB/s); the backward reads x and g
// and writes dx (1.81 GB, 0.54 ms). The arithmetic is a few dozen
// operations per element.
//
// Forward: one thread per output element (neighbouring threads on
// neighbouring output columns). It takes the sixteen 2x2 window maxima of
// its reflect-padded 4x4 neighbourhood on the fly, sums the separable
// blur in float32 and rounds once to the output dtype.
// Backward: a gather, with no atomics, in one tiled kernel. A block
// takes a 16 x 64 tile of one input plane. First each thread takes some
// of the 17 x 65 2x2 windows that touch the tile: the window's first
// maximum in row-major order and the blur transpose of g at the window,
// both into shared memory. The blur transpose is a fixed loop over the
// (at most three) padded positions that reflect onto the window's row
// and column and their two taps each, unrolled, so nothing indexes an
// array at run time. Then each input element sums the windows (up to
// four) of which it is the first maximum: the max-pool's routing in
// PyTorch (a later element wins only if it is greater, or NaN) and in
// XLA's select-and-scatter, which _bwd_kernel reproduces. Deterministic.
// Any H, W >= 4 (the reflect pad needs H - 1 > 2), odd ones included:
// out is ((H - 2) / 2 + 1, (W - 2) / 2 + 1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTileH = 16, kTileW = 64;  // input elements per bwd block
constexpr int kWinH = kTileH + 1, kWinW = kTileW + 1;  // its windows

__device__ __forceinline__ float tap(int a) {  // [1, 3, 3, 1] / 8
  return (a == 0 || a == 3) ? 0.125f : 0.375f;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Index of the reflect-padded max-pool map (padded index - 1) in [0, n).
__device__ __forceinline__ int reflect(int q, int n) {
  return q < 0 ? -q : (q >= n ? 2 * (n - 1) - q : q);
}

// The 2x2 window at (i, j) of a W-wide map: its first maximum in
// row-major order (0..3 for (0,0), (0,1), (1,0), (1,1)) and its value.
template <typename T>
__device__ __forceinline__ int first_max(const T* x, int W, int i, int j,
                                         float* value) {
  const T* r0 = x + (size_t)i * W + j;
  const float e[4] = {to_float(r0[0]), to_float(r0[1]), to_float(r0[W]),
                      to_float(r0[W + 1])};
  int best = 0;
  float m = e[0];
#pragma unroll
  for (int q = 1; q < 4; ++q) {
    if (e[q] > m || isnan(e[q])) {
      best = q;
      m = e[q];
    }
  }
  *value = m;
  return best;
}

// The e-th padded position q in [-1, n + 1] of the max-pool map (n long)
// that reflects onto index p: e = 0 is p itself, e = 1 the left pad's
// -1 (onto 1), e = 2 the right pad's 2 (n - 1) - p (q = n onto n - 2,
// q = n + 1 onto n - 3). Returns whether it exists.
__device__ __forceinline__ bool padded_source(int e, int p, int n, int* q) {
  if (e == 0) {
    *q = p;
    return true;
  }
  if (e == 1) {
    *q = -1;
    return p == 1;
  }
  *q = 2 * (n - 1) - p;
  return *q == n || *q == n + 1;
}

// The blur transpose of g (Ho x Wo) at max-pool cell (i, j) of an
// nh x nw map: the sum of tap(a) tap(b) g[o][s] over the outputs (o, s)
// whose taps 2 o + a - 1 and 2 s + b - 1 (padded positions) reflect onto
// (i, j). A padded position q is read by the taps a = r and r + 2, with
// r = (q + 1) mod 2, of the outputs (q + 1 - r) / 2 and one less. Away
// from the borders that is one position an axis and four loads of g.
template <typename T>
__device__ __forceinline__ float blur_transpose(const T* gp, int Ho, int Wo,
                                                int i, int j, int nh,
                                                int nw) {
  if (i >= 2 && i <= nh - 4 && j >= 2 && j <= nw - 4) {
    // inside: only (i, j) itself, both taps of each axis in range; the
    // same sums as the general loop below, in its order
    const int rr = (i + 1) & 1, o = (i + 1 - rr) >> 1;
    const int rc = (j + 1) & 1, s = (j + 1 - rc) >> 1;
    const T* g1 = gp + (size_t)o * Wo + s;
    const T* g0 = g1 - Wo;
    const float row1 =
        fmaf(tap(rc + 2), to_float(g1[-1]), tap(rc) * to_float(g1[0]));
    const float row0 =
        fmaf(tap(rc + 2), to_float(g0[-1]), tap(rc) * to_float(g0[0]));
    return fmaf(tap(rr + 2), row0, tap(rr) * row1);
  }
  float acc = 0.f;
#pragma unroll
  for (int er = 0; er < 3; ++er) {
    int qr;
    if (!padded_source(er, i, nh, &qr)) continue;
    const int rr = (qr + 1) & 1, o0 = (qr + 1 - rr) >> 1;
#pragma unroll
    for (int ar = 0; ar < 2; ++ar) {
      const int o = o0 - ar;
      if (o < 0 || o >= Ho) continue;
      float row = 0.f;
#pragma unroll
      for (int ec = 0; ec < 3; ++ec) {
        int qc;
        if (!padded_source(ec, j, nw, &qc)) continue;
        const int rc = (qc + 1) & 1, s0 = (qc + 1 - rc) >> 1;
#pragma unroll
        for (int ac = 0; ac < 2; ++ac) {
          const int s = s0 - ac;
          if (s < 0 || s >= Wo) continue;
          row = fmaf(tap(rc + 2 * ac), to_float(gp[(size_t)o * Wo + s]), row);
        }
      }
      acc = fmaf(tap(rr + 2 * ar), row, acc);
    }
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
max_blur_pool_fwd_kernel(const T* __restrict__ x, T* __restrict__ out,
                         long long planes, int H, int W) {
  const int Ho = (H - 2) / 2 + 1, Wo = (W - 2) / 2 + 1;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= planes * Ho * Wo) return;
  const int oj = (int)(idx % Wo);
  const int oi = (int)((idx / Wo) % Ho);
  const T* xp = x + (size_t)(idx / ((long long)Ho * Wo)) * H * W;
  float acc = 0.f;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = reflect(2 * oi + a - 1, H - 1);
    float row = 0.f;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      float m;
      first_max(xp, W, i, reflect(2 * oj + b - 1, W - 1), &m);
      row = fmaf(tap(b), m, row);
    }
    acc = fmaf(tap(a), row, acc);
  }
  out[idx] = from_float<T>(acc);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
max_blur_pool_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                         T* __restrict__ dx, int H, int W, int tiles_h,
                         int tiles_w) {
  __shared__ float win_grad[kWinH * kWinW];
  __shared__ unsigned char win_max[kWinH * kWinW];  // 0..3, 4: no window
  const int Ho = (H - 2) / 2 + 1, Wo = (W - 2) / 2 + 1;
  const int tx = (int)(blockIdx.x % tiles_w);
  const int ty = (int)((blockIdx.x / tiles_w) % tiles_h);
  const long long plane = blockIdx.x / ((long long)tiles_w * tiles_h);
  const int y0 = ty * kTileH, x0 = tx * kTileW;
  const T* xp = x + (size_t)plane * H * W;
  const T* gp = g + (size_t)plane * Ho * Wo;

  // 1. the windows (i, j), i in [y0 - 1, y0 + kTileH - 1] and j in
  //    [x0 - 1, x0 + kTileW - 1]: first maximum and blur transpose of g
  for (int s = threadIdx.x; s < kWinH * kWinW; s += kThreads) {
    const int i = y0 - 1 + s / kWinW, j = x0 - 1 + s % kWinW;
    unsigned char best = 4;
    float grad = 0.f;
    if (i >= 0 && i < H - 1 && j >= 0 && j < W - 1) {
      float m;
      best = (unsigned char)first_max(xp, W, i, j, &m);
      grad = blur_transpose(gp, Ho, Wo, i, j, H - 1, W - 1);
    }
    win_grad[s] = grad;
    win_max[s] = best;
  }
  __syncthreads();

  // 2. each element (yy, xx) of the tile sums the windows (yy - di,
  //    xx - dj) of which it is the first maximum, entry 2 di + dj
  for (int e = threadIdx.x; e < kTileH * kTileW; e += kThreads) {
    const int ly = e / kTileW, lx = e % kTileW;
    const int yy = y0 + ly, xx = x0 + lx;
    if (yy >= H || xx >= W) continue;
    float acc = 0.f;
#pragma unroll
    for (int di = 1; di >= 0; --di) {
#pragma unroll
      for (int dj = 1; dj >= 0; --dj) {
        const int s = (ly + 1 - di) * kWinW + (lx + 1 - dj);
        if (win_max[s] == 2 * di + dj) acc += win_grad[s];
      }
    }
    dx[(size_t)plane * H * W + (size_t)yy * W + xx] = from_float<T>(acc);
  }
}

template <typename T>
int launch_fwd(const void* x, void* out, long long planes, int H, int W,
               cudaStream_t stream) {
  const long long total =
      planes * ((H - 2) / 2 + 1) * (long long)((W - 2) / 2 + 1);
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  max_blur_pool_fwd_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), planes, H, W);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* g, void* dx, long long planes,
               int H, int W, cudaStream_t stream) {
  const int tiles_h = (H + kTileH - 1) / kTileH;
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const long long blocks = planes * tiles_h * tiles_w;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  max_blur_pool_bwd_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<T*>(dx), H, W, tiles_h, tiles_w);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; x (planes, H, W), out (planes, Ho, Wo)
// with planes = batch * channels. Returns a cudaError_t (0 = success).
extern "C" int max_blur_pool_fwd(int dtype, const void* x, void* out,
                                 long long planes, int H, int W,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd<float>(x, out, planes, H, W, s);
  if (dtype == 1) return launch_fwd<__nv_bfloat16>(x, out, planes, H, W, s);
  return (int)cudaErrorInvalidValue;
}

// g (planes, Ho, Wo) -> dx (planes, H, W), in x's dtype.
extern "C" int max_blur_pool_bwd(int dtype, const void* x, const void* g,
                                 void* dx, long long planes, int H, int W,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bwd<float>(x, g, dx, planes, H, W, s);
  if (dtype == 1) {
    return launch_bwd<__nv_bfloat16>(x, g, dx, planes, H, W, s);
  }
  return (int)cudaErrorInvalidValue;
}
