// Fused plane sweep for the hero model's feature volume: projection,
// bilinear warp, 202-channel metadata and the MLP C_in -> 128 -> 128 -> 1,
// in one kernel.
//
// Replaces the TPU kernel simplerecon_tpu/ops/pallas_cv.py::
// banded_warp_feature_volume (mode "mlp"; body _banded_kernel, :248,
// launched by _banded_call, :354). That kernel samples with two-hot matrix products over
// y-banded source tiles, because gathers starve the TPU's matrix unit.
// Here each sample is four direct tap loads: one (b, view) feature map is
// h*w*c elements (2.75 MB for all 7 hero views in bf16), so the taps hit
// L2.
//
// What it computes per (pixel, plane): the MLP, 2*(202*128 + 128*128 +
// 128) = 84.7 kFLOP, 1.07 TFLOP at hero b16 (d=64, N=12288), or 1.08 ms
// at the H100's 989 TFLOP/s of bf16 tensor cores; the feature maps and
// the float32 output are 0.2 GB, 0.06 ms at 3.35 TB/s. The taps, 4 x 16
// channels a (pixel, plane, view) (3.6 KB a cell in bf16, 45 GB at b16),
// come through L1 and L2; once the MLP is on the tensor cores they are
// what sets the pace.
//
// Two kernels, by the compute dtype:
// * bf16, fused_sweep_mma_kernel (the training step's, the b8 forward's
//   and the b1 request's): the MLP on the tensor cores (sweep_mma.cuh).
//   Persistent blocks of 256 threads, one an SM, copy W0 (zero rows to
//   C_in = 208) and W1 into shared memory once with cp.async, then walk
//   work items of 128 cells (128 reference pixels at one plane): all
//   threads fill the bf16 input tile X (fill_inputs_bf16: 16-byte tap
//   loads, samples rounded once, dot rows from the unrounded samples),
//   then warp i runs rows [16i, 16i + 16) (`mlp_rows`, which K4 and K5
//   share): layer 0 from X and W0 in shared memory, h0 rounded into
//   layer 1's A fragments in registers, layer 1 from W1, the head as a
//   quad-shuffle dot with w2. Shared memory at hero widths: W0 56,576 B
//   + W1 34,816 + X (128 x 216) 55,296 + b0, b1, w2 1,536 = 148,224 B.
//   Registers: 182 a thread (64 accumulators, 32 for h0's fragments),
//   no spills (ptxas).
// * float32, fused_sweep_mlp_kernel: the first design, unchanged. The
//   card-against-CPU checks run it; tensor cores would take float32 as
//   TF32 and change its numbers. One block per (pixel tile of 64, plane,
//   batch element), one thread per hidden channel (128 threads),
//   assembles the tile's inputs in shared memory and runs the MLP there
//   in float32 FMAs (`mlp_tail` of sweep_common.cuh, shared with K4 and
//   K5).
// Inputs: src (b,k,h,w,c), cur (b,N,c), w0 (C_in,128), w1 (128,128),
// w2 (128,1) in the compute dtype T; proj = K @ src_T_cur (b,k,4,4),
// invK (b,4,4), planes (b,d), pose_meta (b,k,3), src_loc (b,k,3) and the
// biases in float32. Output (b,d,N) float32.
//
// The dot-product sweep (K1-dot, fused_sweep_dot below) is the same
// kernel's mode "dot" (banded_warp_dot_volume, _banded_kernel's dot
// branch): per (pixel, plane), the sum over views of mask * <sample, cur>
// with mask = z + eps > 0. Off-image taps carry zero weight. It has no
// MLP, so what bounds it on an H100 is the sampling. The least work per
// (view, plane, pixel) is the projection (9 FMAs), c dot FMAs for each
// of the four taps and 4 more to weight them (mask * sum_t w_t <tap_t,
// cur>), and about 16 more operations (divide, tap weights, mask): 170
// float32 operations at c = 16, 15 GFLOP at hero b16, or 0.22 ms on the
// CUDA cores; its device memory traffic (source maps, cur and the
// float32 output, about 101 MB at b16) takes 0.03 ms. The tap loads,
// 4 x 32 B a sample in bf16 (11 GB at b16), come from L1 and L2. The
// first design (one thread per (pixel, plane), each tap two or four
// 16-byte loads of its own) took 1.07-1.09 ms at b16 bf16; the same
// kernel with its tap loads alone took 0.87-0.95 ms, and with its
// arithmetic alone (the loads made coalesced) 0.71-0.72 (an NVIDIA H100
// 80GB HBM3 at 700 W, scripts/sweep_floor.py): the loads and the
// instructions both bound it. This design (fused_sweep_dot_kernel below)
// cuts instructions: a thread walks a run of planes of one pixel, with
// its cur in registers, and dots each tap with cur as the tap's channels
// arrive (4c + 4 FMAs), bf16 widened by a shift.
// In float32 four lanes share a pixel, each loading a 16-byte slice of
// every tap row, so a warp's load reads whole rows of 8 neighbouring
// pixels. Its d_cur mode, the dot model's gradient for the reference
// features, is the same loop with mask * g in place of cur.
// The dot model's matching features have c = 16, the only width K1-dot
// takes (the wrapper raises on others). K1 and K1-dot share the
// projection and taps (project_taps), so they sample at the same points:
// features are read in T and sampled and dotted in float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sweep_common.cuh"

namespace {

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
  const int cin = mlp_in_channels(k, c);
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
    const float3 ray = pixel_ray(ik, pix, w);
    const Taps t = project_taps(proj + (bi * k + view) * 16, ray.x * plane,
                                ray.y * plane, ray.z * plane, h, w);

    const T* img = src + (size_t)(bi * k + view) * n * c;
    const T* t_nw = img + (size_t)t.pix[0] * c;
    const T* t_ne = img + (size_t)t.pix[1] * c;
    const T* t_sw = img + (size_t)t.pix[2] * c;
    const T* t_se = img + (size_t)t.pix[3] * c;
    const T* cur_p = cur + ((size_t)bi * n + pix) * c;

    float dot = 0.f;
    for (int ch = 0; ch < c; ++ch) {
      const float s = bilinear(t, to_float(t_nw[ch]), to_float(t_ne[ch]),
                               to_float(t_sw[ch]), to_float(t_se[ch]));
      rows[(view * c + ch) * kRow + p] = round_to<T>(s);
      dot = fmaf(s, to_float(cur_p[ch]), dot);
    }
    view_meta_rows<T>(rows, p, view, k, meta, t.mask, t.z_eps, dot, ray,
                      plane, src_loc + (bi * k + view) * 3);
  }
  // Per-pixel rows: reference features, plane, reference ray, pose rows.
  for (int p = tid; p < kTile; p += kHidden) {
    const int pix = min(p0 + p, n - 1);
    pixel_meta_rows<T>(rows, p, k, c, meta, cur + ((size_t)bi * n + pix) * c,
                       pixel_ray(ik, pix, w), plane, pose_meta + bi * k * 3);
  }
  __syncthreads();

  mlp_tail<T>(rows, cin, w0, b0, w1, b1, w2, b2,
              out + ((size_t)bi * d + di) * n + p0, n - p0);
}

template <typename T>
int launch(const void* src, const void* cur, const void* proj,
           const void* invK, const void* planes, const void* pose_meta,
           const void* src_loc, const void* w0, const void* b0,
           const void* w1, const void* b1, const void* w2, const void* b2,
           void* out, int b, int k, int h, int w, int c, int d,
           cudaStream_t stream) {
  const size_t smem = tail_smem_bytes(mlp_in_channels(k, c));
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

// ---- K1 in bf16: the MLP on the tensor cores (see the note above) -------
__global__ void __launch_bounds__(kMmaThreads, 1)
fused_sweep_mma_kernel(const bf16* __restrict__ src,
                       const bf16* __restrict__ cur,
                       const float* __restrict__ proj,
                       const float* __restrict__ invK,
                       const float* __restrict__ planes,
                       const float* __restrict__ pose_meta,
                       const float* __restrict__ src_loc,
                       const bf16* __restrict__ w0,
                       const float* __restrict__ b0,
                       const bf16* __restrict__ w1,
                       const float* __restrict__ b1,
                       const bf16* __restrict__ w2,
                       const float* __restrict__ b2,
                       float* __restrict__ out, int b, int k, int h, int w,
                       int c, int d, int vec8) {
  extern __shared__ uint4 smem_u4[];
  const int n = h * w;
  const MlpTile s = load_mlp_tile(smem_u4, w0, b0, w1, b1, w2, b2,
                                  mlp_in_channels(k, c));
  const int tiles = (n + kMmaCells - 1) / kMmaCells;
  for (int item = blockIdx.x; item < b * d * tiles; item += gridDim.x) {
    const int tile = item % tiles;
    const int di = (item / tiles) % d;
    const int bi = item / (tiles * d);
    const int p0 = tile * kMmaCells;
    __syncthreads();  // weights loaded; the previous item's X consumed
    fill_inputs_bf16(s.X, s.xs, kMmaCells, src + (size_t)bi * k * n * c,
                     cur + (size_t)bi * n * c, proj + bi * k * 16,
                     invK + bi * 16, planes[bi * d + di],
                     pose_meta + bi * k * 3, src_loc + bi * k * 3, p0, n,
                     k, h, w, c, vec8 != 0);
    __syncthreads();
    mlp_tile_out(s, out + ((size_t)bi * d + di) * n + p0, n - p0);
  }
}

int launch_mma(const void* src, const void* cur, const void* proj,
               const void* invK, const void* planes, const void* pose_meta,
               const void* src_loc, const void* w0, const void* b0,
               const void* w1, const void* b1, const void* w2,
               const void* b2, void* out, int b, int k, int h, int w, int c,
               int d, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(mlp_in_channels(k, c));
  cudaError_t err = cudaFuncSetAttribute(
      fused_sweep_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks =
      persistent_blocks((long)b * d * ((h * w + kMmaCells - 1) / kMmaCells));
  const int vec8 = c % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(cur) % 16 == 0;
  fused_sweep_mma_kernel<<<blocks, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(src), static_cast<const bf16*>(cur),
      static_cast<const float*>(proj), static_cast<const float*>(invK),
      static_cast<const float*>(planes), static_cast<const float*>(pose_meta),
      static_cast<const float*>(src_loc), static_cast<const bf16*>(w0),
      static_cast<const float*>(b0), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(out), b, k, h, w, c,
      d, vec8);
  return (int)cudaGetLastError();
}

constexpr int kDotThreads = 256;
constexpr int kDotC = 16;    // channel count of the vector tap loads
constexpr int kDotRun = 8;   // planes a thread of the forward takes

// V channels of a tap row from 16-byte loads, as float32 (a bf16 value is
// the high half of a float32's bits, so the conversion is a shift or a
// mask).
template <int V>
__device__ __forceinline__ void load_slice(const float* p, float (&v)[V]) {
#pragma unroll
  for (int i = 0; i < V / 4; ++i) {
    const float4 f = reinterpret_cast<const float4*>(p)[i];
    v[4 * i + 0] = f.x;
    v[4 * i + 1] = f.y;
    v[4 * i + 2] = f.z;
    v[4 * i + 3] = f.w;
  }
}
template <int V>
__device__ __forceinline__ void load_slice(const __nv_bfloat16* p,
                                           float (&v)[V]) {
#pragma unroll
  for (int i = 0; i < V / 8; ++i) {
    const uint4 u = reinterpret_cast<const uint4*>(p)[i];
    const unsigned words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[8 * i + 2 * j + 0] = __uint_as_float(words[j] << 16);
      v[8 * i + 2 * j + 1] = __uint_as_float(words[j] & 0xffff0000u);
    }
  }
}

// Lanes that share a pixel, chosen by timing each count at hero b16
// (scripts/sweep_floor.py --parts lanes; PERF.md): in bf16 one (a lane
// loads both 16-byte halves of a tap row), in float32 four (4 channels,
// one 16-byte load a tap row each).
template <typename T>
struct DotLanes {
  static constexpr int L = sizeof(T) == 4 ? 4 : 1;
};

// K1-dot and its d_cur mode. L = DotLanes<T>::L lanes share a pixel
// (neighbouring lanes on its slices of V = 16 / L channels). Each lane
// walks the views and, inside, its planes, and takes each sample's taps
// with `project_taps` (every lane of a pixel computes them): the first
// design's points, bit for bit. (A projection stepped from plane to
// plane, 3 FMAs a plane, rounds the points otherwise, and moved the dot
// model's first float32 training step on the card from the CPU's by more
// than chip_smoke.py's phase 13 allows.)
// * forward (kCurGrad false): out = sum over views of mask * sum_q w_q
//   <tap_q, cur>, the lane's slice of each dot as its channels arrive,
//   the L slices summed by shuffles; a block takes 256 / L pixels and a
//   run of kDotRun planes, whose sums stay in registers.
// * d_cur (kCurGrad true): d_cur[pix, ch] = sum over views and planes of
//   mask * g[plane, pix] * sample[ch], with sample = sum_q w_q tap_q; a
//   block takes 128 / L pixels, its first 128 threads the first half of
//   the planes and the others the second half, each in view order and
//   plane order, and the first adds the second's sums from shared memory:
//   a fixed order, so two calls give the same bits.
template <typename T, bool kCurGrad>
__global__ void __launch_bounds__(kDotThreads)
fused_sweep_dot_kernel(const T* __restrict__ src, const T* __restrict__ cur,
                       const float* __restrict__ g,
                       const float* __restrict__ proj,
                       const float* __restrict__ invK,
                       const float* __restrict__ planes,
                       float* __restrict__ out, int k, int h, int w, int d) {
  constexpr int L = DotLanes<T>::L;
  constexpr int V = kDotC / L;  // channels a lane loads
  constexpr int kHalf = kDotThreads / 2;
  __shared__ float halves[kCurGrad ? kHalf * V : 1];
  const int n = h * w;
  const int bi = blockIdx.z;
  const int slice = threadIdx.x % L;
  const int part = kCurGrad ? threadIdx.x / kHalf : 0;
  const int pix = kCurGrad
                      ? blockIdx.x * (kHalf / L) + (threadIdx.x % kHalf) / L
                      : blockIdx.x * (kDotThreads / L) + threadIdx.x / L;
  const int p0 = kCurGrad ? (part ? d / 2 : 0) : blockIdx.y * kDotRun;
  const int p1 = kCurGrad ? (part ? d : d / 2) : min(d, p0 + kDotRun);
  // lanes past the last pixel take its taps (the shuffles and the barrier
  // want every lane) and store nothing
  const int pc = min(pix, n - 1);
  const float3 ray = pixel_ray(invK + bi * 16, pc, w);
  float cv[V], acc[V], total[kDotRun];
#pragma unroll
  for (int ch = 0; ch < V; ++ch) acc[ch] = 0.f;
#pragma unroll
  for (int j = 0; j < kDotRun; ++j) total[j] = 0.f;
  if (!kCurGrad) {
    load_slice<V>(cur + ((size_t)bi * n + pc) * kDotC + slice * V, cv);
  }

  for (int view = 0; view < k; ++view) {
    const float* P = proj + (bi * k + view) * 16;
    const T* img = src + (size_t)(bi * k + view) * n * kDotC + slice * V;
    // plane p0 + j of this view
    auto step = [&](int j) {
      const int di = p0 + j;
      const float plane = planes[bi * d + di];
      const Taps t = project_taps(P, ray.x * plane, ray.y * plane,
                                  ray.z * plane, h, w);
      float v[4][V];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        load_slice<V>(img + (size_t)t.pix[q] * kDotC, v[q]);
      }
      if (kCurGrad) {
        const float m = t.mask * g[((size_t)bi * d + di) * n + pc];
        const float m0 = m * t.wt[0], m1 = m * t.wt[1];
        const float m2 = m * t.wt[2], m3 = m * t.wt[3];
#pragma unroll
        for (int ch = 0; ch < V; ++ch) {
          acc[ch] += m0 * v[0][ch] + m1 * v[1][ch] + m2 * v[2][ch] +
                     m3 * v[3][ch];
        }
      } else {
        float dq[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          dq[q] = 0.f;
#pragma unroll
          for (int ch = 0; ch < V; ++ch) dq[q] = fmaf(v[q][ch], cv[ch], dq[q]);
        }
        total[j] += t.mask * (t.wt[0] * dq[0] + t.wt[1] * dq[1] +
                              t.wt[2] * dq[2] + t.wt[3] * dq[3]);
      }
    };
    if (kCurGrad) {
      for (int j = 0; j < p1 - p0; ++j) step(j);
    } else {
      // the forward's run unrolled, its sums in registers
#pragma unroll
      for (int j = 0; j < kDotRun; ++j) {
        if (p0 + j < p1) step(j);
      }
    }
  }
  if (!kCurGrad) {
#pragma unroll
    for (int j = 0; j < kDotRun; ++j) {
#pragma unroll
      for (int o = L / 2; o > 0; o /= 2) {
        total[j] += __shfl_xor_sync(0xffffffffu, total[j], o);
      }
      if (slice == 0 && pix < n && p0 + j < p1) {
        out[((size_t)bi * d + p0 + j) * n + pix] = total[j];
      }
    }
    return;
  }
  float* mine = halves + (threadIdx.x % kHalf) * V;
  if (part == 1) {
#pragma unroll
    for (int ch = 0; ch < V; ++ch) mine[ch] = acc[ch];
  }
  __syncthreads();
  if (part == 0 && pix < n) {
    float* dst = out + ((size_t)bi * n + pix) * kDotC + slice * V;
#pragma unroll
    for (int ch = 0; ch < V; ch += 4) {
      *reinterpret_cast<float4*>(dst + ch) =
          make_float4(acc[ch] + mine[ch], acc[ch + 1] + mine[ch + 1],
                      acc[ch + 2] + mine[ch + 2], acc[ch + 3] + mine[ch + 3]);
    }
  }
}

// cur_grad = 0: K1-dot, out (b, d, N) from cur; 1: d_cur (b, N, c) into
// out from g (b, d, N) float32.
template <typename T>
int launch_dot(int cur_grad, const void* src, const void* cur, const void* g,
               const void* proj, const void* invK, const void* planes,
               void* out, int b, int k, int h, int w, int c, int d,
               cudaStream_t stream) {
  if (c != kDotC || reinterpret_cast<uintptr_t>(src) % 16 != 0 ||
      (!cur_grad && reinterpret_cast<uintptr_t>(cur) % 16 != 0) ||
      (cur_grad && reinterpret_cast<uintptr_t>(out) % 16 != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  constexpr int L = DotLanes<T>::L;
  const int n = h * w;
  const T* s = static_cast<const T*>(src);
  const T* cu = static_cast<const T*>(cur);
  const float* gg = static_cast<const float*>(g);
  const float* P = static_cast<const float*>(proj);
  const float* ik = static_cast<const float*>(invK);
  const float* pl = static_cast<const float*>(planes);
  float* o = static_cast<float*>(out);
  if (cur_grad) {
    const int pixels = kDotThreads / 2 / L;
    const dim3 grid((n + pixels - 1) / pixels, 1, b);
    fused_sweep_dot_kernel<T, true><<<grid, kDotThreads, 0, stream>>>(
        s, cu, gg, P, ik, pl, o, k, h, w, d);
  } else {
    const int pixels = kDotThreads / L;
    const dim3 grid((n + pixels - 1) / pixels, (d + kDotRun - 1) / kDotRun,
                    b);
    fused_sweep_dot_kernel<T, false><<<grid, kDotThreads, 0, stream>>>(
        s, cu, gg, P, ik, pl, o, k, h, w, d);
  }
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
    return launch_mma(src, cur, proj, invK, planes, pose_meta, src_loc, w0,
                      b0, w1, b1, w2, b2, out, b, k, h, w, c, d, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The dot-product sweep (K1-dot). dtype as above; no MLP arguments.
extern "C" int fused_sweep_dot(int dtype, const void* src, const void* cur,
                               const void* proj, const void* invK,
                               const void* planes, void* out, int b, int k,
                               int h, int w, int c, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_dot<float>(0, src, cur, nullptr, proj, invK, planes, out,
                             b, k, h, w, c, d, s);
  }
  if (dtype == 1) {
    return launch_dot<__nv_bfloat16>(0, src, cur, nullptr, proj, invK,
                                     planes, out, b, k, h, w, c, d, s);
  }
  return (int)cudaErrorInvalidValue;
}

// K1-dot's d_cur mode: d_cur (b, N, c) float32 from the cotangent g
// (b, d, N) float32 of K1-dot's output. dtype as above (of src).
extern "C" int fused_sweep_dot_cur_grad(int dtype, const void* src,
                                        const void* g, const void* proj,
                                        const void* invK, const void* planes,
                                        void* d_cur, int b, int k, int h,
                                        int w, int c, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_dot<float>(1, src, nullptr, g, proj, invK, planes, d_cur,
                             b, k, h, w, c, d, s);
  }
  if (dtype == 1) {
    return launch_dot<__nv_bfloat16>(1, src, nullptr, g, proj, invK, planes,
                                     d_cur, b, k, h, w, c, d, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* fused_sweep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
