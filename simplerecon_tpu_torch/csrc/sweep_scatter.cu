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
// by 2^S and rounded to a 64-bit integer, the integers are added
// (two's complement, so neither the order nor the grouping changes the
// sum), and a last pass converts each sum to float32 times 2^-S. S comes
// from a bound M on |d_s| (K2: the largest |d_s|, which it finds with an
// order-free atomicMax; the dot model: max |g| * max |cur|): at most
// count = 4 * d * N contributions reach one element, each at most M, so
// with M < 2^e and count <= 2^L, S = 62 - L - e keeps every sum, and
// every partial sum, within 2^62. At hero b16 (d = 64, N = 12,288, L =
// 22) a contribution keeps the bits down to 2^-40 M, finer than
// float32's 2^-24 of M, so the sums are as exact as float32 sums and the
// same on every run. `sweep_scatter_reference` in ops/cuda_cv.py is the
// plain version: the same integers summed with index_add_ on int64.
//
// What bounds it on an H100: the adds. At hero b16 there are b*d*N*k =
// 88 M samples, 4 taps of c = 16 channels each: up to 5.6 G 64-bit adds
// into a 176 MB accumulator, against 2.8 GB of bf16 d_s read once (0.84
// ms at 3.35 TB/s). The first design sent every add to device memory as
// an atomic (12.8 ms at b16 with the training batch's cameras on an
// NVIDIA H100 80GB HBM3 at 700 W, scripts/in_turns.py). This one sums
// most of them in shared memory first:
// * A block owns one 16 x 16 tile of reference pixels of one (batch
//   element, view), a thread a pixel, and a run of up to kRun
//   consecutive planes.
// * It projects its taps (`project_taps`, K1's and K2's arithmetic,
//   whose expressions are those of K2's float32 `view_geom`) and takes,
//   for each plane, the bounding box of the taps that carry a
//   contribution (block reductions into shared memory).
// * It walks the planes in groups: consecutive planes join a group while
//   the union of their boxes, c sums a pixel, fits in the window
//   (kWindowBytes of shared memory). A group's contributions are added
//   into the window with shared-memory atomics, and each nonzero sum then
//   reaches the accumulator with one device-memory atomic. The H100 has
//   no 64-bit shared-memory add (a 64-bit atomicAdd there compiles to a
//   compare-and-swap loop, ATOMS.CAST.SPIN.64, which took 6.0 clocks a
//   warp instruction on an SM against 1.1 for the 32-bit ATOMS.ADD), so
//   the window keeps each sum as 32-bit sums of parts of the
//   contributions. A group adds at most kScatterThreads * kRun = 2,048
//   contributions to one element (a sample's four taps are four pixels).
//   Where the shape bounds every contribution below 2^41 (L >= 22, as at
//   hero widths), two parts: bits 21-63 as a signed sum (at most 2^30 in
//   size) and bits 0-20 (below 2^32). Elsewhere three: bits 32-63 (needed
//   only modulo 2^32), 16-31 and 0-15 (below 2^27). Either way the parts
//   give the group's int64 sum modulo 2^64, as the accumulator's adds
//   do. A contribution is added only where its tap has weight and it is
//   not zero, one test each (tests of each part cost more, and adds of
//   zeros too: scripts/sweep_floor.py times both). A plane whose
//   own box does not fit (near planes of a wide baseline) adds its
//   contributions straight to device memory, as the first design did.
//   Both paths add the same integers, so d_src has the same bits
//   whichever path a plane takes; `paths` counts the planes of each.
// * A thread adds its own sample's contributions, channel by channel
//   and tap by tap: its d_s row (K2) or cur row (the dot model) comes in
//   with 16-byte loads, and there is no staging and no shared-memory read
//   between the loads and the adds. The window stores channel ch of
//   pixel p at word ch * stride + p of each part, with an odd stride, so
//   the 32 lanes of an add (32 neighbouring pixels, one tap, one
//   channel) fall in distinct banks but where two rows of the tile
//   overlap, and the flush (consecutive channels of a pixel) too.
// With cameras a few centimetres apart, as in training, a tile's taps
// move less than a pixel a plane at most depths, so one group of kRun
// planes covers a box little larger than the tile, and the device-memory
// atomics fall by the ratio of kRun * 4 taps to the box's pixels over the
// tile's.
//
// Inputs: d_s (b, k, d, N, c) in T (K2), or g (b, d, N) float32 and cur
// (b, N, c) in T (the dot model); proj = K @ src_T_cur (b, k, 4, 4),
// invK (b, 4, 4), planes (b, d) and max_abs (1) float32. acc (b, k, h*w,
// c) int64 is zeroed by the caller; d_src (b, k, h, w, c) float32 out;
// paths (2) int64, zeroed by the caller: planes of a block summed in the
// window, and planes added straight to device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sweep_common.cuh"

namespace {

constexpr int kTileSide = 16;                       // tile: 16 x 16 pixels
constexpr int kScatterThreads = kTileSide * kTileSide;  // a thread a pixel
constexpr int kRun = 8;                              // planes per block
constexpr int kWindowBytes = 64 * 1024;              // the window's sums
constexpr int kChunk = 16;  // channels of a row a thread holds at once
constexpr int kSplit = 21;  // the low part's bits, with two window parts
// kScatterThreads * kRun = 2^11 low parts of 21 bits sum below 2^32
static_assert(kScatterThreads * kRun <= (1 << (32 - kSplit)),
              "low window sums overflow");
// the window's 16-bit parts sum at most this many contributions
static_assert(kScatterThreads * kRun <= 65536, "window sums overflow");

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

// One contribution w_tap * d_s as a fixed-point integer: the float32
// products of the first design, scaled by 2^S and rounded to the nearest
// integer (the dot mode's d_s is its float32 product m * cur).
__device__ __forceinline__ long long to_fixed(float ds, float wt,
                                              float scale) {
  return __float2ll_rn(__fmul_rn(__fmul_rn(ds, wt), scale));
}

// The window keeps each int64 sum as kParts 32-bit sums (see above):
// kParts = 3, bits 32-63 (needed only modulo 2^32), 16-31 and 0-15; or
// kParts = 2, bits kSplit-63 as a signed sum and 0-(kSplit - 1), where
// the shape bounds every contribution well enough (`launch_scatter`).
// Adds one contribution to element i (the parts `size` words apart).
template <int kParts>
__device__ __forceinline__ void add_window(unsigned* win, int size, int i,
                                           long long fixed) {
  const unsigned long long u = static_cast<unsigned long long>(fixed);
  if (kParts == 2) {
    atomicAdd(win + i, static_cast<unsigned>(fixed >> kSplit));
    atomicAdd(win + size + i,
              static_cast<unsigned>(u) & ((1u << kSplit) - 1u));
  } else {
    atomicAdd(win + i, static_cast<unsigned>(u >> 32));
    atomicAdd(win + size + i, static_cast<unsigned>(u >> 16) & 0xffffu);
    atomicAdd(win + 2 * size + i, static_cast<unsigned>(u) & 0xffffu);
  }
}

// Element i's int64 sum, modulo 2^64, from the window's parts.
template <int kParts>
__device__ __forceinline__ unsigned long long window_sum(const unsigned* win,
                                                         int size, int i) {
  if (kParts == 2) {
    const long long hi = static_cast<int>(win[i]);  // a signed sum
    return (static_cast<unsigned long long>(hi) << kSplit) + win[size + i];
  }
  return (static_cast<unsigned long long>(win[i]) << 32) +
         (static_cast<unsigned long long>(win[size + i]) << 16) +
         win[2 * size + i];
}

// Up to kChunk channels of one sample's row as float32: 16-byte loads
// where `vec` says the rows are 16-byte aligned and n_ch fills them.
template <typename T>
__device__ __forceinline__ void load_chunk(const T* row, int n_ch, bool vec,
                                           float (&v)[kChunk]) {
  constexpr int kPer = 16 / sizeof(T);  // channels a 16-byte load
  if (vec && n_ch == kChunk) {
#pragma unroll
    for (int i = 0; i < kChunk / kPer; ++i) {
      const uint4 u = reinterpret_cast<const uint4*>(row)[i];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < kPer; ++j) v[i * kPer + j] = to_float(e[j]);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < kChunk; ++i) v[i] = i < n_ch ? to_float(row[i]) : 0.f;
}

template <typename T, bool kDot, int kParts>
__global__ void __launch_bounds__(kScatterThreads, 3)
sweep_scatter_kernel(const T* __restrict__ d_s, const float* __restrict__ g,
                     const T* __restrict__ cur,
                     const float* __restrict__ proj,
                     const float* __restrict__ invK,
                     const float* __restrict__ planes,
                     const float* __restrict__ max_abs,
                     unsigned long long* __restrict__ acc,
                     unsigned long long* __restrict__ paths, int k, int h,
                     int w, int c, int d, int vec) {
  __shared__ int box[kRun][4];  // min x, max x, min y, max y of a plane
  extern __shared__ unsigned window[];
  // pixels a window holds: kParts parts of c channels of (pixels | 1)
  // words
  const int window_pixels = kWindowBytes / (4 * kParts * c) - 1;

  const int n = h * w;
  const int tiles_x = (w + kTileSide - 1) / kTileSide;
  const int tx0 = (blockIdx.x % tiles_x) * kTileSide;
  const int ty0 = (blockIdx.x / tiles_x) * kTileSide;
  const int d0 = blockIdx.y * kRun;
  const int runs = min(kRun, d - d0);
  const int bv = blockIdx.z;  // batch element * k + view
  const int bi = bv / k;
  const int px = tx0 + threadIdx.x % kTileSide;
  const int py = ty0 + threadIdx.x / kTileSide;
  const bool inside = px < w && py < h;
  const int pix = inside ? py * w + px : 0;
  const float scale = pow2(fixed_point_shift(*max_abs, 4LL * d * n));
  const float* P = proj + (size_t)bv * 16;
  const float3 ray = pixel_ray(invK + bi * 16, pix, w);
  unsigned long long* acc_v = acc + (size_t)bv * n * c;

  // the sample of this thread's pixel at plane d0 + r: its taps, and its
  // factor m (the dot model's mask * g, 1 for K2; 0 outside the image)
  auto sample = [&](int r, float& m) {
    const float plane = planes[bi * d + d0 + r];
    const Taps t = project_taps(P, ray.x * plane, ray.y * plane,
                                ray.z * plane, h, w);
    m = !inside ? 0.f
        : kDot  ? t.mask * g[((size_t)bi * d + d0 + r) * n + pix]
                : 1.f;
    return t;
  };

  // each plane's box of the taps that carry a contribution
  if (threadIdx.x < kRun * 4) {
    box[threadIdx.x >> 2][threadIdx.x & 3] =
        (threadIdx.x & 1) ? -1 : 0x7fffffff;
  }
  __syncthreads();
  for (int r = 0; r < runs; ++r) {
    float m;
    const Taps t = sample(r, m);
    int x_lo = 0x7fffffff, x_hi = -1, y_lo = 0x7fffffff, y_hi = -1;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (m != 0.f && t.wt[q] != 0.f) {
        const int y = t.pix[q] / w, x = t.pix[q] - y * w;
        x_lo = min(x_lo, x);
        x_hi = max(x_hi, x);
        y_lo = min(y_lo, y);
        y_hi = max(y_hi, y);
      }
    }
    x_lo = __reduce_min_sync(0xffffffffu, x_lo);
    x_hi = __reduce_max_sync(0xffffffffu, x_hi);
    y_lo = __reduce_min_sync(0xffffffffu, y_lo);
    y_hi = __reduce_max_sync(0xffffffffu, y_hi);
    if ((threadIdx.x & 31) == 0 && x_hi >= 0) {
      atomicMin(&box[r][0], x_lo);
      atomicMax(&box[r][1], x_hi);
      atomicMin(&box[r][2], y_lo);
      atomicMax(&box[r][3], y_hi);
    }
  }
  __syncthreads();

  // adds this thread's sample at plane d0 + r: into the window (the box
  // from (bx0, by0), bw pixels wide; channel ch of pixel p at word
  // ch * stride + p of each part, the parts `size` words apart), or, with
  // to_window false, into the accumulator acc_v
  auto add_plane = [&](int r, bool to_window, int bx0, int by0, int bw,
                       int stride, int size) {
    float m;
    const Taps t = sample(r, m);
    if (m == 0.f) return;
    const T* row = kDot ? cur + ((size_t)bi * n + pix) * c
                        : d_s + (((size_t)bv * d + d0 + r) * n + pix) * c;
    int off[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int y = t.pix[q] / w, x = t.pix[q] - y * w;
      // (a tap of zero weight adds nothing; its offset stays in range)
      off[q] = !to_window         ? t.pix[q]
               : t.wt[q] == 0.f ? 0
                                : (y - by0) * bw + (x - bx0);
    }
    for (int ch0 = 0; ch0 < c; ch0 += kChunk) {
      const int n_ch = min(kChunk, c - ch0);
      float v[kChunk];
      load_chunk(row + ch0, n_ch, vec != 0, v);
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        if (i >= n_ch) break;
        const float ds = kDot ? __fmul_rn(m, v[i]) : v[i];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (t.wt[q] == 0.f) continue;
          const long long fixed = to_fixed(ds, t.wt[q], scale);
          if (fixed == 0) continue;
          if (to_window) {
            add_window<kParts>(window, size, (ch0 + i) * stride + off[q],
                               fixed);
          } else {
            atomicAdd(acc_v + (size_t)off[q] * c + ch0 + i,
                      static_cast<unsigned long long>(fixed));
          }
        }
      }
    }
  };

  int r = 0;
  while (r < runs) {
    // the next group: planes from r while the union of their boxes fits
    int bx0 = box[r][0], bx1 = box[r][1], by0 = box[r][2], by1 = box[r][3];
    if (bx1 < 0) {  // nothing to add at this plane
      ++r;
      continue;
    }
    if ((bx1 - bx0 + 1) * (by1 - by0 + 1) > window_pixels) {
      // too wide for the window: straight to device memory
      add_plane(r, false, 0, 0, 0, 0, 0);
      if (threadIdx.x == 0) atomicAdd(paths + 1, 1ULL);
      ++r;
      continue;
    }
    int end = r + 1;
    while (end < runs) {
      if (box[end][1] < 0) {  // an empty plane joins any group
        ++end;
        continue;
      }
      const int x0 = min(bx0, box[end][0]), x1 = max(bx1, box[end][1]);
      const int y0 = min(by0, box[end][2]), y1 = max(by1, box[end][3]);
      if ((x1 - x0 + 1) * (y1 - y0 + 1) > window_pixels) break;
      bx0 = x0, bx1 = x1, by0 = y0, by1 = y1;
      ++end;
    }
    const int bw = bx1 - bx0 + 1;
    const int pixels = bw * (by1 - by0 + 1);
    // an odd stride: a warp's 32 words of one channel and of 32 pixels,
    // or of 16 channels and 2 pixels, fall in distinct banks
    const int stride = pixels | 1;
    const int size = stride * c;
    for (int i = threadIdx.x; i < kParts * size; i += kScatterThreads) {
      window[i] = 0;
    }
    __syncthreads();
    for (int rr = r; rr < end; ++rr) {
      if (box[rr][1] >= 0) add_plane(rr, true, bx0, by0, bw, stride, size);
    }
    __syncthreads();
    // each nonzero sum reaches the accumulator with one atomic
    for (int i = threadIdx.x; i < pixels * c; i += kScatterThreads) {
      const int p = i / c, ch = i - p * c;
      const unsigned long long v =
          window_sum<kParts>(window, size, ch * stride + p);
      if (v != 0) {
        const int y = by0 + p / bw, x = bx0 + p % bw;
        atomicAdd(acc_v + (size_t)(y * w + x) * c + ch, v);
      }
    }
    if (threadIdx.x == 0) atomicAdd(paths, (unsigned long long)(end - r));
    __syncthreads();  // the window is read before the next group zeroes it
    r = end;
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
                   const void* max_abs, void* acc, void* d_src, void* paths,
                   int b, int k, int h, int w, int c, int d,
                   cudaStream_t stream) {
  const int n = h * w;
  const int tiles = ((w + kTileSide - 1) / kTileSide) *
                    ((h + kTileSide - 1) / kTileSide);
  const dim3 grid(tiles, (d + kRun - 1) / kRun, b * k);
  // two parts when every group's high sums fit a signed 32-bit word: a
  // contribution is below 2^(62 - L) in size (count = 4 d N <= 2^L), a
  // group adds at most kScatterThreads * kRun = 2^11 of them to an
  // element, so the high parts (bits kSplit and up) sum to at most
  // 2^(73 - L - kSplit) in size (L >= 22 at hero widths)
  const long long count = 4LL * d * n;
  int l = 0;
  while ((1LL << l) < count) ++l;
  const bool two = 73 - l - kSplit <= 30;
  auto kernel = dot ? (two ? sweep_scatter_kernel<T, true, 2>
                           : sweep_scatter_kernel<T, true, 3>)
                    : (two ? sweep_scatter_kernel<T, false, 2>
                           : sweep_scatter_kernel<T, false, 3>);
  // rows of whole 16-byte vectors from a 16-byte-aligned start
  const void* rows = dot ? cur : d_s;
  const int vec = (c * sizeof(T)) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWindowBytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kScatterThreads, kWindowBytes, stream>>>(
      static_cast<const T*>(d_s), static_cast<const float*>(g),
      static_cast<const T*>(cur), static_cast<const float*>(proj),
      static_cast<const float*>(invK), static_cast<const float*>(planes),
      static_cast<const float*>(max_abs),
      static_cast<unsigned long long*>(acc),
      static_cast<unsigned long long*>(paths), k, h, w, c, d, vec);
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
                             void* acc, void* d_src, void* paths, int b,
                             int k, int h, int w, int c, int d,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_scatter<float>(dot, d_s, g, cur, proj, invK, planes,
                                 max_abs, acc, d_src, paths, b, k, h, w, c,
                                 d, s);
  }
  if (dtype == 1) {
    return launch_scatter<__nv_bfloat16>(dot, d_s, g, cur, proj, invK,
                                         planes, max_abs, acc, d_src, paths,
                                         b, k, h, w, c, d, s);
  }
  return (int)cudaErrorInvalidValue;
}
