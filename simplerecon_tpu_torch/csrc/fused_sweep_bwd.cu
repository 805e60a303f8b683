// Backward of the fused plane sweep (csrc/fused_sweep.cu): given the
// cotangent g (b, d, N) of the scores, the gradients of the source and
// reference features and of the MLP weights. Geometry is data and gets
// none, as in the JAX package's custom VJP.
//
// Replaces the TPU kernel simplerecon_tpu/ops/pallas_cv.py::
// banded_warp_feature_volume_bwd (body _banded_bwd_kernel, :778,
// launched by _banded_bwd_call, :946). That kernel warps with two-hot
// matrix products over y-banded tiles and carries d_img, d_cur and the
// weight gradients from one grid step to the next, because the TPU grid
// runs in order. Here the taps are four direct loads, nothing carries
// between blocks, and the warp's transpose is a second kernel: this one
// writes each sample's gradient, and sweep_scatter.cu sums them into
// d_src in an order-free fixed-point form.
//
// What it computes per (pixel, plane): the recomputed forward (84.7
// kFLOP of MLP) and its transposes, d_w2, d_h1p, d_w1 += h0 x r1, d_h0 =
// r1 W1^T, d_h0p, d_w0 += x x r0 and d_x = r0 W0^T over the 135 rows
// that carry gradient (sampled, reference and dot): 236.8 kFLOP, 2.98
// TFLOP at hero b16, or 3.01 ms at the H100's 989 TFLOP/s of bf16
// tensor cores. The sample gradients it writes for the scatter are
// b*k*d*N*c values (2.8 GB in bf16 at b16, 0.84 ms of writes).
//
// Both kernels: persistent blocks, one per SM, walk pixel tiles of 32
// (tile = blockIdx.x, += gridDim.x) and, for each tile, all d planes.
//   * d_cur of the tile is summed in shared memory over all planes and
//     written once: no atomics, a fixed order.
//   * d_w0 (C_in x 128), d_w1 (128 x 128), d_b*, d_w2 are summed by each
//     block over every (pixel, plane) it sees, each element by one thread
//     in a fixed order; each block writes its partial sums once, and a
//     second kernel adds the blocks' partials in block order: the same
//     bits from run to run.
//   * d_src: every (pixel, plane, view) writes its sample gradient d_s
//     (c values in T, rounded where the plain version rounds it) to the
//     scratch d_s (b, k, d, N, c), and the largest |d_s| to d_s_max (an
//     atomicMax on the float's bits, which orders non-negative floats as
//     unsigned ints: order-free). The scatter (sweep_scatter.cu) then
//     adds w_tap * d_s into d_src as 64-bit fixed-point integers scaled
//     from that maximum: the same bits from run to run.
// * bf16, fused_sweep_bwd_mma_kernel (the training step's): the products
//   on the tensor cores (sweep_mma.cuh), 256 threads. Shared memory and
//   registers are what bound the design; the count is in the note at the
//   kernel.
//   d_w0 is summed in shared memory, d_w1 in registers; h0, r1 and r0
//   stay bf16 tiles that ldmatrix reads as they are or transposed, so
//   no transposed copy of a weight is needed.
// * float32, fused_sweep_bwd_kernel: the first design, on the CUDA cores
//   in float32 FMAs (bound by FMA issue): the card-against-CPU
//   checks run it, and tensor cores would take float32 as TF32 and change
//   its numbers. 256 threads; thread (j, half) owns hidden channel j and,
//   in column products, pixels [16 half, 16 half + 16); d_w0 and d_w1
//   sit in 169 KB of shared memory, thread (j, half) adding column j of
//   rows half, half + 2, ...
// Rounding points (T = compute dtype), the plain version's: the MLP input
// and h0, h1 as in the forward; d_h1p and d_h0p before the products that
// consume them; each sample gradient d_s before it is written. Sums are
// float32; d_b0, d_b1 sum the unrounded d_h0p, d_h1p.
//
// Inputs: src (b,k,h,w,c), cur (b,N,c), w0 (C_in,128), w0t (128,C_in),
// w1 and w1t (128,128), w2 (128,1) in T (w0t and w1t only for float32;
// null for bf16); proj = K @ src_T_cur (b,k,4,4),
// invK (b,4,4), planes (b,d), pose_meta (b,k,3), src_loc (b,k,3), b0, b1
// and g (b,d,N) in float32. Outputs: the sample gradients d_s
// (b,k,d,N,c) in T and the bits of max |d_s| in d_s_max (zeroed by the
// caller); in float32 d_cur (b,N,c) and d_params = [d_w0 (C_in,128) |
// d_w1 (128,128) | d_b0 | d_b1 | d_w2 | d_b2]; partials (blocks, size of
// d_params) is scratch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sweep_common.cuh"

namespace {

constexpr int kBwdTile = 32;            // pixels per tile
constexpr int kThreads = 2 * kHidden;   // two threads per hidden channel
constexpr int kHalf = kBwdTile / 2;     // pixels per thread, column products

// Projection and bilinear taps of one (pixel, view) at one plane, with
// fused_sweep.cu's arithmetic.
struct ViewGeom {
  float wt[4];   // tap weights nw, ne, sw, se (0 outside the image)
  int pix[4];    // tap pixel indices into the view's map (0 outside)
  float mask;    // z > 0
  float z_eps;
  float sray[3];  // unit ray from the source camera centre
  float angle;
};

__device__ __forceinline__ ViewGeom view_geom(const float* P,
                                              const float* loc, float rx,
                                              float ry, float rz,
                                              float plane, int h, int w) {
  ViewGeom g;
  const float wx = rx * plane, wy = ry * plane, wz = rz * plane;
  const float cx = P[0] * wx + P[1] * wy + P[2] * wz + P[3];
  const float cy = P[4] * wx + P[5] * wy + P[6] * wz + P[7];
  const float cz = P[8] * wx + P[9] * wy + P[10] * wz + P[11];
  g.z_eps = cz + 1e-8f;
  const float scale = fabsf(cz) > 1e-8f ? 1.0f / g.z_eps : 1.0f;
  const float u = cx * scale, v = cy * scale;
  g.mask = g.z_eps > 0.f ? 1.f : 0.f;

  const float ix = u - 0.5f, iy = v - 0.5f;
  const float x0 = floorf(ix), y0 = floorf(iy);
  const float x1 = x0 + 1.f, y1 = y0 + 1.f;
  const bool vx0 = x0 >= 0.f && x0 <= w - 1.f;
  const bool vx1 = x1 >= 0.f && x1 <= w - 1.f;
  const bool vy0 = y0 >= 0.f && y0 <= h - 1.f;
  const bool vy1 = y1 >= 0.f && y1 <= h - 1.f;
  const int xi0 = vx0 ? (int)x0 : 0, xi1 = vx1 ? (int)x1 : 0;
  const int yi0 = vy0 ? (int)y0 : 0, yi1 = vy1 ? (int)y1 : 0;
  g.wt[0] = (vx0 && vy0) ? (x1 - ix) * (y1 - iy) : 0.f;
  g.wt[1] = (vx1 && vy0) ? (ix - x0) * (y1 - iy) : 0.f;
  g.wt[2] = (vx0 && vy1) ? (x1 - ix) * (iy - y0) : 0.f;
  g.wt[3] = (vx1 && vy1) ? (ix - x0) * (iy - y0) : 0.f;
  g.pix[0] = yi0 * w + xi0;
  g.pix[1] = yi0 * w + xi1;
  g.pix[2] = yi1 * w + xi0;
  g.pix[3] = yi1 * w + xi1;

  const float ref_inv = 1.0f / sqrtf(rx * rx + ry * ry + rz * rz + 1e-30f);
  const float sx = wx - loc[0], sy = wy - loc[1], sz = wz - loc[2];
  const float src_inv = 1.0f / sqrtf(sx * sx + sy * sy + sz * sz + 1e-30f);
  g.sray[0] = sx * src_inv;
  g.sray[1] = sy * src_inv;
  g.sray[2] = sz * src_inv;
  g.angle = (rx * ref_inv) * g.sray[0] + (ry * ref_inv) * g.sray[1] +
            (rz * ref_inv) * g.sray[2];
  return g;
}

// float32 sample of channel ch: the forward's sum over the four taps.
template <typename T>
__device__ __forceinline__ float sample(const T* img, const ViewGeom& g,
                                        int c, int ch) {
  return g.wt[0] * to_float(img[(size_t)g.pix[0] * c + ch]) +
         g.wt[1] * to_float(img[(size_t)g.pix[1] * c + ch]) +
         g.wt[2] * to_float(img[(size_t)g.pix[2] * c + ch]) +
         g.wt[3] * to_float(img[(size_t)g.pix[3] * c + ch]);
}

// acc[q] += sum_i rows[i][p_lo + q] * wgt[i * stride + j], q < kHalf.
template <typename T>
__device__ __forceinline__ void column_product(const float* rows,
                                               int n_rows,
                                               const T* __restrict__ wgt,
                                               int stride, int j, int p_lo,
                                               float (&acc)[kHalf]) {
#pragma unroll
  for (int q = 0; q < kHalf; ++q) acc[q] = 0.f;
#pragma unroll 2
  for (int i = 0; i < n_rows; ++i) {
    const float wv = to_float(wgt[i * stride + j]);
    const float4* row = reinterpret_cast<const float4*>(rows + i * kBwdTile +
                                                        p_lo);
#pragma unroll
    for (int q = 0; q < kHalf / 4; ++q) {
      const float4 f = row[q];
      acc[4 * q + 0] = fmaf(f.x, wv, acc[4 * q + 0]);
      acc[4 * q + 1] = fmaf(f.y, wv, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(f.z, wv, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(f.w, wv, acc[4 * q + 3]);
    }
  }
}

// out[r * kHidden + j] += sum_p rows[r][p] * col[p] for r = r0, r0 + 2, ...
__device__ __forceinline__ void outer_rows(const float* rows, int n_rows,
                                           int r0, const float (&col)[kBwdTile],
                                           float* out, int j) {
#pragma unroll 2
  for (int r = r0; r < n_rows; r += 2) {
    const float4* row = reinterpret_cast<const float4*>(rows + r * kBwdTile);
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kBwdTile / 4; ++q) {
      const float4 f = row[q];
      s = fmaf(f.x, col[4 * q + 0], s);
      s = fmaf(f.y, col[4 * q + 1], s);
      s = fmaf(f.z, col[4 * q + 2], s);
      s = fmaf(f.w, col[4 * q + 3], s);
    }
    out[r * kHidden + j] += s;
  }
}

__device__ __forceinline__ void load_row(const float* rows, int j,
                                         float (&col)[kBwdTile]) {
  const float4* row = reinterpret_cast<const float4*>(rows + j * kBwdTile);
#pragma unroll
  for (int q = 0; q < kBwdTile / 4; ++q) {
    const float4 f = row[q];
    col[4 * q + 0] = f.x;
    col[4 * q + 1] = f.y;
    col[4 * q + 2] = f.z;
    col[4 * q + 3] = f.w;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
fused_sweep_bwd_kernel(const T* __restrict__ src, const T* __restrict__ cur,
                       const float* __restrict__ proj,
                       const float* __restrict__ invK,
                       const float* __restrict__ planes,
                       const float* __restrict__ pose_meta,
                       const float* __restrict__ src_loc,
                       const T* __restrict__ w0, const T* __restrict__ w0t,
                       const float* __restrict__ b0,
                       const T* __restrict__ w1, const T* __restrict__ w1t,
                       const float* __restrict__ b1,
                       const T* __restrict__ w2,
                       const float* __restrict__ g, T* __restrict__ d_s,
                       unsigned* __restrict__ d_s_max,
                       float* __restrict__ d_cur,
                       float* __restrict__ partials, int b, int k, int h,
                       int w, int c, int d) {
  extern __shared__ float4 smem4[];
  const int n = h * w;
  const int cin = (k + 1) * c + 10 * k + 4;
  const int meta = (k + 1) * c;        // first metadata row
  const int o_dot = meta + 2 * k + 1;  // first dot row
  const int n_feat = (k + 1) * c;      // sampled and reference rows
  const int n_dx = n_feat + k;         // rows of d_x that carry gradient
  const int n_params = cin * kHidden + kHidden * kHidden + 3 * kHidden + 1;

  float* acc_w0 = reinterpret_cast<float*>(smem4);  // (cin, 128)
  float* acc_w1 = acc_w0 + cin * kHidden;            // (128, 128)
  float* X = acc_w1 + kHidden * kHidden;  // cin x kBwdTile: MLP input, then d_x
  float* H = X + cin * kBwdTile;             // 128 x kBwdTile: h0, then r0
  float* R = H + kHidden * kBwdTile;         // 128 x kBwdTile: r1
  float* G = R + kHidden * kBwdTile;         // kBwdTile: g of this plane
  float* DC = G + kBwdTile;                  // kBwdTile x c: d_cur of the tile

  const int tid = threadIdx.x;
  const int j = tid % kHidden;
  const int half = tid / kHidden;
  const int p_lo = half * kHalf;
  unsigned ds_max = 0u;  // bits of this thread's largest |d_s|

  for (int i = tid; i < (cin + kHidden) * kHidden; i += kThreads) {
    acc_w0[i] = 0.f;
  }
  float db0 = 0.f, db1 = 0.f, dw2 = 0.f, db2 = 0.f;
  const float b0j = b0[j], b1j = b1[j], w2j = to_float(w2[j]);

  const int tiles_per_b = (n + kBwdTile - 1) / kBwdTile;
  for (int tile = blockIdx.x; tile < b * tiles_per_b; tile += gridDim.x) {
    const int bi = tile / tiles_per_b;
    const int p0 = (tile % tiles_per_b) * kBwdTile;
    const float* ik = invK + bi * 16;
    for (int i = tid; i < kBwdTile * c; i += kThreads) DC[i] = 0.f;

    for (int di = 0; di < d; ++di) {
      const float plane = planes[bi * d + di];
      // ---- 1. the forward's MLP inputs, rounded to T ---------------------
      for (int item = tid; item < kBwdTile * k; item += kThreads) {
        const int p = item % kBwdTile;
        const int view = item / kBwdTile;
        const int pix = min(p0 + p, n - 1);  // ragged tile: g is 0 there
        const float px = (pix % w) + 0.5f, py = (pix / w) + 0.5f;
        const float rx = ik[0] * px + ik[1] * py + ik[2];
        const float ry = ik[4] * px + ik[5] * py + ik[6];
        const float rz = ik[8] * px + ik[9] * py + ik[10];
        const ViewGeom vg =
            view_geom(proj + (bi * k + view) * 16,
                      src_loc + (bi * k + view) * 3, rx, ry, rz, plane, h, w);
        const T* img = src + (size_t)(bi * k + view) * n * c;
        const T* cur_p = cur + ((size_t)bi * n + pix) * c;
        float dot = 0.f;
        for (int ch = 0; ch < c; ++ch) {
          const float s = sample(img, vg, c, ch);
          X[(view * c + ch) * kBwdTile + p] = round_to<T>(s);
          dot = fmaf(s, to_float(cur_p[ch]), dot);
        }
        X[(meta + view) * kBwdTile + p] = vg.mask;
        X[(meta + k + view) * kBwdTile + p] = round_to<T>(vg.z_eps);
        X[(o_dot + view) * kBwdTile + p] = round_to<T>(dot * vg.mask);
        X[(meta + 3 * k + 1 + view) * kBwdTile + p] = round_to<T>(vg.angle);
        const int sray = meta + 4 * k + 4 + 3 * view;
        for (int e = 0; e < 3; ++e) {
          X[(sray + e) * kBwdTile + p] = round_to<T>(vg.sray[e]);
        }
      }
      for (int p = tid; p < kBwdTile; p += kThreads) {
        const int pix = min(p0 + p, n - 1);
        const T* cur_p = cur + ((size_t)bi * n + pix) * c;
        for (int ch = 0; ch < c; ++ch) {
          X[(k * c + ch) * kBwdTile + p] = to_float(cur_p[ch]);
        }
        const float px = (pix % w) + 0.5f, py = (pix / w) + 0.5f;
        const float rx = ik[0] * px + ik[1] * py + ik[2];
        const float ry = ik[4] * px + ik[5] * py + ik[6];
        const float rz = ik[8] * px + ik[9] * py + ik[10];
        const float ref_inv =
            1.0f / sqrtf(rx * rx + ry * ry + rz * rz + 1e-30f);
        X[(meta + 2 * k) * kBwdTile + p] = round_to<T>(plane);
        X[(meta + 4 * k + 1) * kBwdTile + p] = round_to<T>(rx * ref_inv);
        X[(meta + 4 * k + 2) * kBwdTile + p] = round_to<T>(ry * ref_inv);
        X[(meta + 4 * k + 3) * kBwdTile + p] = round_to<T>(rz * ref_inv);
        for (int jv = 0; jv < 3 * k; ++jv) {  // [penalty(k), R(k), t(k)]
          const int jj = jv / k, view = jv % k;
          X[(meta + 7 * k + 4 + jv) * kBwdTile + p] =
              round_to<T>(pose_meta[(bi * k + view) * 3 + jj]);
        }
        G[p] = p0 + p < n ? g[((size_t)bi * d + di) * n + p0 + p] : 0.f;
      }
      __syncthreads();

      // ---- 2. layer 0: h0 = round(lrelu(x W0 + b0)) ----------------------
      float acc[kHalf];
      column_product(X, cin, w0, kHidden, j, p_lo, acc);
      unsigned positive0 = 0u;
#pragma unroll
      for (int q = 0; q < kHalf; ++q) {
        const float pre = acc[q] + b0j;
        positive0 |= (pre > 0.f ? 1u : 0u) << q;
        H[j * kBwdTile + p_lo + q] = round_to<T>(leaky_relu(pre));
      }
      __syncthreads();

      // ---- 3. layer 1 and the head: d_w2, d_b1, r1 = round(d_h1p) --------
      column_product(H, kHidden, w1, kHidden, j, p_lo, acc);
#pragma unroll
      for (int q = 0; q < kHalf; ++q) {
        const float pre = acc[q] + b1j;
        const float gq = G[p_lo + q];
        dw2 = fmaf(round_to<T>(leaky_relu(pre)), gq, dw2);
        const float d_h1p = w2j * gq * (pre > 0.f ? 1.f : 0.01f);
        db1 += d_h1p;
        R[j * kBwdTile + p_lo + q] = round_to<T>(d_h1p);
      }
      if (tid == 0) {
        for (int p = 0; p < kBwdTile; ++p) db2 += G[p];
      }
      __syncthreads();

      // ---- 4. d_h0 = W1 r1, r0 = round(d_h0p); d_w1 += h0 x r1 ----------
      column_product(R, kHidden, w1t, kHidden, j, p_lo, acc);
#pragma unroll
      for (int q = 0; q < kHalf; ++q) {
        const float d_h0p = acc[q] * (((positive0 >> q) & 1u) ? 1.f : 0.01f);
        db0 += d_h0p;
        acc[q] = round_to<T>(d_h0p);
      }
      {
        float col[kBwdTile];
        load_row(R, j, col);
        outer_rows(H, kHidden, half, col, acc_w1, j);
      }
      __syncthreads();  // h0 and r1 are read by every thread
#pragma unroll
      for (int q = 0; q < kHalf; ++q) H[j * kBwdTile + p_lo + q] = acc[q];
      __syncthreads();

      // ---- 5. d_w0 += x x r0, then d_x = W0 r0 into X ---------------------
      {
        float col[kBwdTile];
        load_row(H, j, col);
        outer_rows(X, cin, half, col, acc_w0, j);
      }
      __syncthreads();  // x is read by every thread
      for (int item = tid; item < n_dx * (kBwdTile / 4); item += kThreads) {
        const int rr = item % n_dx;
        const int q4 = item / n_dx;
        const int row = rr < n_feat ? rr : o_dot + (rr - n_feat);
        float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
        for (int i = 0; i < kHidden; ++i) {
          const float wv = to_float(w0t[i * cin + row]);
          const float4 r0 = reinterpret_cast<const float4*>(H + i * kBwdTile)[q4];
          s.x = fmaf(wv, r0.x, s.x);
          s.y = fmaf(wv, r0.y, s.y);
          s.z = fmaf(wv, r0.z, s.z);
          s.w = fmaf(wv, r0.w, s.w);
        }
        reinterpret_cast<float4*>(X + row * kBwdTile)[q4] = s;
      }
      __syncthreads();

      // ---- 6. the dot split and the sample gradients ---------------------
      // Item (p, view) owns rows view*c.. and dot row o_dot + view of
      // column p: it reads d_x there, writes d_s, and leaves the float32
      // sample and d_dot in their place for the d_cur sum of phase 7.
      for (int item = tid; item < kBwdTile * k; item += kThreads) {
        const int p = item % kBwdTile;
        const int view = item / kBwdTile;
        const int pix = p0 + p;
        if (pix >= n) continue;
        const float px = (pix % w) + 0.5f, py = (pix / w) + 0.5f;
        const float rx = ik[0] * px + ik[1] * py + ik[2];
        const float ry = ik[4] * px + ik[5] * py + ik[6];
        const float rz = ik[8] * px + ik[9] * py + ik[10];
        const ViewGeom vg =
            view_geom(proj + (bi * k + view) * 16,
                      src_loc + (bi * k + view) * 3, rx, ry, rz, plane, h, w);
        const T* img = src + (size_t)(bi * k + view) * n * c;
        const T* cur_p = cur + ((size_t)bi * n + pix) * c;
        T* ds_out = d_s + ((((size_t)bi * k + view) * d + di) * n + pix) * c;
        const float d_dot = X[(o_dot + view) * kBwdTile + p] * vg.mask;
        X[(o_dot + view) * kBwdTile + p] = d_dot;
        for (int ch = 0; ch < c; ++ch) {
          float* x = X + (view * c + ch) * kBwdTile + p;
          const float ds = round_to<T>(*x + d_dot * to_float(cur_p[ch]));
          *x = sample(img, vg, c, ch);
          ds_out[ch] = ds;
          ds_max = max(ds_max, __float_as_uint(fabsf(ds)));
        }
      }
      __syncthreads();

      // ---- 7. d_cur += d_x[ref rows] + sum over views of d_dot * sample --
      for (int item = tid; item < kBwdTile * c; item += kThreads) {
        const int p = item / c;
        const int ch = item % c;
        float s = X[(k * c + ch) * kBwdTile + p];
        for (int view = 0; view < k; ++view) {
          s = fmaf(X[(o_dot + view) * kBwdTile + p],
                   X[(view * c + ch) * kBwdTile + p], s);
        }
        DC[item] += s;
      }
      __syncthreads();
    }

    for (int item = tid; item < kBwdTile * c; item += kThreads) {
      const int p = item / c;
      if (p0 + p < n) {
        d_cur[((size_t)bi * n + p0) * c + item] = DC[item];
      }
    }
    __syncthreads();
  }

  ds_max = __reduce_max_sync(0xffffffffu, ds_max);
  if ((tid & 31) == 0) atomicMax(d_s_max, ds_max);

  // ---- the block's partial sums ------------------------------------------
  float* part = partials + (size_t)blockIdx.x * n_params;
  for (int i = tid; i < (cin + kHidden) * kHidden; i += kThreads) {
    part[i] = acc_w0[i];
  }
  const int base = (cin + kHidden) * kHidden;
  if (half == 1) {
    R[j] = db0;
    R[kHidden + j] = db1;
    R[2 * kHidden + j] = dw2;
  }
  __syncthreads();
  if (half == 0) {
    part[base + j] = db0 + R[j];
    part[base + kHidden + j] = db1 + R[kHidden + j];
    part[base + 2 * kHidden + j] = dw2 + R[2 * kHidden + j];
  }
  if (tid == 0) part[base + 3 * kHidden] = db2;
}

// ---- K2 in bf16: the MLP and its transposes on the tensor cores --------
// A work item is one (tile, plane): 32 cells. Shared memory, counted
// before the kernel was written, at hero widths (C_in = 202, padded to
// 208; a block may use 232,448 B). Everything in shared memory (both
// weight gradients too) would be 333,824 B at 64 cells and does not fit;
// this layout keeps d_w1 in registers and d_w0 in shared memory:
//   W0, W1 bf16, 136 elements a row         91,392 B
//   d_w0 float32 (202 x 128, swizzled)     103,424 B
//   X (32 x 216 bf16) | H0 (32 x 136 bf16)  22,528 B, then d_x (32 x 148
//                                           float32, 18,944 B) over both
//   R (32 x 136 bf16): r1, then r0           8,704 B
//   g (32), d_cur of the tile (32 x c)       2,176 B
//   b0, b1, w2 float32                       1,536 B
//   the block's d_b0, d_b1, d_w2             1,536 B
//   total                                  231,296 B
// d_w1 (128 x 128): warp i owns rows [16i, 16i + 16), 64 float32
// registers a thread for the block's whole run (237 registers a thread
// in all, no spills, by ptxas).
// Warp i's tile of the (32 x 128) products (layer 0, layer 1, d_h0) is
// rows [16 (i % 2), +16) x columns [32 (i / 2), +32); its threads keep
// the slope of h0's pre-activations as bits; d_b0, d_b1 and d_w2 are
// summed over each item's rows (shuffles, then the two warps that share
// the columns) and added to the block's sums in shared memory.
constexpr int kBwdMmaCells = 32;

__host__ __device__ __forceinline__ int dx_cols(int k, int c) {
  return ((k + 1) * c + k + 15) / 16 * 16;  // d_x columns, in pairs of n-tiles
}

__host__ __device__ __forceinline__ size_t xh_bytes(int cinp, int dxc) {
  const size_t xh = (size_t)kBwdMmaCells * ((cinp + 8) + kWs) * 2;
  const size_t dx = (size_t)kBwdMmaCells * (dxc + 4) * 4;
  return ((xh > dx ? xh : dx) + 15) / 16 * 16;
}

inline size_t bwd_mma_smem_bytes(int k, int c) {
  const int cin = mlp_in_channels(k, c);
  const int cinp = padded_cin(cin);
  return (size_t)(cinp + kHidden) * kWs * 2 + (size_t)cin * kHidden * 4 +
         xh_bytes(cinp, dx_cols(k, c)) + (size_t)kBwdMmaCells * kWs * 2 +
         (size_t)kBwdMmaCells * (1 + c) * 4 + 6 * kHidden * 4;
}

// Sums v[i], this lane's partial for column fn + 8 (i / 2) + 2 t + i % 2,
// over the warp's 8 row groups (lanes 4 apart): every lane gets the sum.
__device__ __forceinline__ void sum_over_rows(float (&v)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int s = 4; s < 32; s <<= 1) {
      v[i] += __shfl_xor_sync(0xffffffffu, v[i], s);
    }
  }
}

// sums[column] += v[i] for the columns of `sum_over_rows` (lane t of
// the warp's first row group calls it).
__device__ __forceinline__ void add_columns(float* sums, const float (&v)[8],
                                            int fn, int t) {
#pragma unroll
  for (int i = 0; i < 8; ++i) sums[fn + 8 * (i / 2) + 2 * t + i % 2] += v[i];
}

// d_w0's shared layout: columns swizzled by row, so the float2 of a
// fragment's eight rows fall in distinct banks.
__device__ __forceinline__ int dw0_at(int r, int col) {
  return r * kHidden + (col ^ ((r & 3) << 3));
}

__global__ void __launch_bounds__(kMmaThreads, 1)
fused_sweep_bwd_mma_kernel(const bf16* __restrict__ src,
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
                           const float* __restrict__ g,
                           bf16* __restrict__ d_s,
                           unsigned* __restrict__ d_s_max,
                           float* __restrict__ d_cur,
                           float* __restrict__ partials, int b, int k,
                           int h, int w, int c, int d, int vec8) {
  extern __shared__ uint4 smem_u4[];
  constexpr int M = kBwdMmaCells;
  const int n = h * w;
  const int cin = mlp_in_channels(k, c);
  const int cinp = padded_cin(cin);
  const int xs = cinp + 8;
  const int nf = (k + 1) * c;          // sampled and reference columns
  const int o_dot = nf + 2 * k + 1;    // first dot column of X
  const int dxc = dx_cols(k, c);
  const int dxs = dxc + 4;
  const int n_params = cin * kHidden + kHidden * kHidden + 3 * kHidden + 1;

  bf16* W0 = reinterpret_cast<bf16*>(smem_u4);
  bf16* W1 = W0 + cinp * kWs;
  unsigned char* xh = reinterpret_cast<unsigned char*>(W1 + kHidden * kWs);
  bf16* X = reinterpret_cast<bf16*>(xh);
  bf16* H0 = X + M * xs;
  float* DX = reinterpret_cast<float*>(xh);  // d_x, over X and H0
  bf16* R = reinterpret_cast<bf16*>(xh + xh_bytes(cinp, dxc));
  float* DW0 = reinterpret_cast<float*>(R + M * kWs);
  float* G = DW0 + cin * kHidden;
  float* DC = G + M;
  float* B0 = DC + M * c;  // b0, b1 and w2 as float32
  float* B1 = B0 + kHidden;
  float* W2 = B1 + kHidden;
  float* SUMS = W2 + kHidden;  // the block's d_b0 | d_b1 | d_w2

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, t = lane & 3;
  const int fm = (warp & 1) * 16;   // rows of the (32 x 128) products
  const int fn = (warp >> 1) * 32;  // their columns

  load_weights(W0, W1, w0, w1, cin);
  for (int i = tid; i < cin * kHidden; i += kMmaThreads) DW0[i] = 0.f;
  for (int i = tid; i < kHidden; i += kMmaThreads) {
    B0[i] = b0[i];
    B1[i] = b1[i];
    W2[i] = __bfloat162float(w2[i]);
  }
  for (int i = tid; i < 3 * kHidden; i += kMmaThreads) SUMS[i] = 0.f;
  float db2 = 0.f;
  unsigned ds_max = 0u;  // bits of this thread's largest |d_s|
  float dw1[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j) dw1[j][0] = dw1[j][1] = dw1[j][2] = dw1[j][3] = 0.f;

  const int tiles_per_b = (n + M - 1) / M;
  for (int tile = blockIdx.x; tile < b * tiles_per_b; tile += gridDim.x) {
    const int bi = tile / tiles_per_b;
    const int p0 = (tile % tiles_per_b) * M;
    const bf16* src_b = src + (size_t)bi * k * n * c;
    const bf16* cur_b = cur + (size_t)bi * n * c;
    const float* proj_b = proj + bi * k * 16;
    const float* ik = invK + bi * 16;
    bf16* d_s_b = d_s + (size_t)bi * k * d * n * c;
    __syncthreads();  // the previous tile's d_cur is written out
    for (int i = tid; i < M * c; i += kMmaThreads) DC[i] = 0.f;

    for (int di = 0; di < d; ++di) {
      const float plane = planes[bi * d + di];
      // ---- 1. the forward's input tile and g --------------------------------
      __syncthreads();  // the previous plane's d_x is consumed
      for (int i = tid; i < M * (cinp - cin); i += kMmaThreads) {
        // layer 0 reads the padding columns, which d_x overwrote
        X[(i / (cinp - cin)) * xs + cin + i % (cinp - cin)] =
            __float2bfloat16_rn(0.f);
      }
      fill_inputs_bf16(X, xs, M, src_b, cur_b, proj_b, ik, plane,
                       pose_meta + bi * k * 3, src_loc + bi * k * 3, p0, n,
                       k, h, w, c, vec8 != 0);
      for (int m = tid; m < M; m += kMmaThreads) {
        G[m] = p0 + m < n ? g[((size_t)bi * d + di) * n + p0 + m] : 0.f;
      }
      __syncthreads();
      if (tid == 0) {
        for (int m = 0; m < M; ++m) db2 += G[m];
      }

      // ---- 2. layer 0: h0 = round(lrelu(x W0 + b0)) -----------------------
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      warp_product<4>(acc, X, xs, fm, W0, kWs, fn, cinp);
      unsigned positive0 = 0u;  // bit 4j + 2 half + e: pre0 > 0
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float2 bj =
              *reinterpret_cast<const float2*>(B0 + fn + 8 * j + 2 * t);
          const float p0v = acc[j][2 * half] + bj.x;
          const float p1v = acc[j][2 * half + 1] + bj.y;
          positive0 |= (p0v > 0.f ? 1u : 0u) << (4 * j + 2 * half);
          positive0 |= (p1v > 0.f ? 1u : 0u) << (4 * j + 2 * half + 1);
          *reinterpret_cast<uint32_t*>(
              H0 + (fm + gq + 8 * half) * kWs + fn + 8 * j + 2 * t) =
              pack_bf16(leaky_relu(p0v), leaky_relu(p1v));
        }
      }
      __syncthreads();

      // ---- 3. layer 1 and the head: d_w2, d_b1, r1 = round(d_h1p) ---------
      // this thread's sums over its rows, for its 8 columns
      float db1[8] = {}, dw2[8] = {};
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      warp_product<4>(acc, H0, kWs, fm, W1, kWs, fn, kHidden);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float gv = G[fm + gq + 8 * half];
          float r[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = fn + 8 * j + 2 * t + e;
            const float pre = acc[j][2 * half + e] + B1[col];
            dw2[2 * j + e] = fmaf(round_to<bf16>(leaky_relu(pre)), gv,
                                  dw2[2 * j + e]);
            r[e] = W2[col] * gv * (pre > 0.f ? 1.f : 0.01f);
            db1[2 * j + e] += r[e];
          }
          *reinterpret_cast<uint32_t*>(
              R + (fm + gq + 8 * half) * kWs + fn + 8 * j + 2 * t) =
              pack_bf16(r[0], r[1]);
        }
      }
      // this item's d_b1 and d_w2 into the block's sums: the warps of rows
      // [0, 16) first, then those of rows [16, 32), a fixed order
      sum_over_rows(db1);
      sum_over_rows(dw2);
      if (fm == 0 && gq == 0) {
        add_columns(SUMS + kHidden, db1, fn, t);
        add_columns(SUMS + 2 * kHidden, dw2, fn, t);
      }
      __syncthreads();
      if (fm == 16 && gq == 0) {
        add_columns(SUMS + kHidden, db1, fn, t);
        add_columns(SUMS + 2 * kHidden, dw2, fn, t);
      }

      // ---- 4. d_w1 += h0^T r1; d_h0 = r1 W1^T, r0 = round(d_h0p) ----------
#pragma unroll
      for (int kk = 0; kk < M / 16; ++kk) {
        uint32_t a[4];
        load_a_t(a, H0, kWs, 16 * warp, 16 * kk);
#pragma unroll
        for (int j = 0; j < 16; j += 2) {
          uint32_t bf[4];
          load_b(bf, R, kWs, 16 * kk, 8 * j);
          mma_bf16(dw1[j], a, bf[0], bf[1]);
          mma_bf16(dw1[j + 1], a, bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      for (int k0 = 0; k0 < kHidden; k0 += 16) {
        uint32_t a[4];
        load_a(a, R, kWs, fm, k0);
#pragma unroll
        for (int j = 0; j < 4; j += 2) {
          uint32_t bf[4];
          load_b_t(bf, W1 + b_t_row(fn + 8 * j) * kWs, k0);
          mma_bf16(acc[j], a, bf[0], bf[1]);
          mma_bf16(acc[j + 1], a, bf[2], bf[3]);
        }
      }
      uint32_t r0[4][2];
      float db0[8] = {};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool pos = (positive0 >> (4 * j + 2 * half + e)) & 1u;
            v[e] = acc[j][2 * half + e] * (pos ? 1.f : 0.01f);
            db0[2 * j + e] += v[e];
          }
          r0[j][half] = pack_bf16(v[0], v[1]);
        }
      }
      sum_over_rows(db0);  // into SUMS as d_b1 and d_w2 in phase 3
      if (fm == 0 && gq == 0) add_columns(SUMS, db0, fn, t);
      __syncthreads();  // r1 and h0 consumed
      if (fm == 16 && gq == 0) add_columns(SUMS, db0, fn, t);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          *reinterpret_cast<uint32_t*>(
              R + (fm + gq + 8 * half) * kWs + fn + 8 * j + 2 * t) =
              r0[j][half];
        }
      }
      __syncthreads();

      // ---- 5. d_w0 += x^T r0 (shared), then d_x = r0 W0^T ------------------
      for (int u = warp; u < (cinp / 16) * 4; u += kMmaThreads / 32) {
        const int r0w = (u >> 2) * 16;  // rows (input channels)
        const int n0 = (u & 3) * 32;
        float dacc[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = r0w + gq + 8 * half;
            float2 v = make_float2(0.f, 0.f);
            if (r < cin) {
              v = *reinterpret_cast<const float2*>(
                  DW0 + dw0_at(r, n0 + 8 * j + 2 * t));
            }
            dacc[j][2 * half] = v.x;
            dacc[j][2 * half + 1] = v.y;
          }
        }
#pragma unroll
        for (int kk = 0; kk < M / 16; ++kk) {
          uint32_t a[4];
          load_a_t(a, X, xs, r0w, 16 * kk);
#pragma unroll
          for (int j = 0; j < 4; j += 2) {
            uint32_t bf[4];
            load_b(bf, R, kWs, 16 * kk, n0 + 8 * j);
            mma_bf16(dacc[j], a, bf[0], bf[1]);
            mma_bf16(dacc[j + 1], a, bf[2], bf[3]);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = r0w + gq + 8 * half;
            if (r < cin) {
              *reinterpret_cast<float2*>(DW0 + dw0_at(r, n0 + 8 * j + 2 * t)) =
                  make_float2(dacc[j][2 * half], dacc[j][2 * half + 1]);
            }
          }
        }
      }
      __syncthreads();  // x consumed: d_x goes over it
      for (int u = warp; u < 2 * (dxc / 16); u += kMmaThreads / 32) {
        const int m0 = (u & 1) * 16;
        const int n0 = (u >> 1) * 16;
        // this lane's W0 row for column n of d_x: sampled and reference
        // rows, then the dot rows, then a zero row
        const int col = b_t_row(n0);
        const int row = col < nf ? col
                                 : (col < nf + k ? o_dot + col - nf : cinp - 1);
        float xacc[2][4] = {};
        for (int k0 = 0; k0 < kHidden; k0 += 16) {
          uint32_t a[4], bf[4];
          load_a(a, R, kWs, m0, k0);
          load_b_t(bf, W0 + row * kWs, k0);
          mma_bf16(xacc[0], a, bf[0], bf[1]);
          mma_bf16(xacc[1], a, bf[2], bf[3]);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            *reinterpret_cast<float2*>(DX + (m0 + gq + 8 * half) * dxs + n0 +
                                       8 * j + 2 * t) =
                make_float2(xacc[j][2 * half], xacc[j][2 * half + 1]);
          }
        }
      }
      __syncthreads();

      // ---- 6. the dot split and the sample gradients -----------------------
      // Item (p, view) owns d_x's columns view*c.. and nf + view of row p:
      // it writes d_s and leaves the float32 sample and d_dot there for
      // phase 7.
      for (int item = tid; item < M * k; item += kMmaThreads) {
        const int p = item % M;
        const int view = item / M;
        const int pix = p0 + p;
        if (pix >= n) continue;
        const float3 ray = pixel_ray(ik, pix, w);
        const Taps tp = project_taps(proj_b + view * 16, ray.x * plane,
                                     ray.y * plane, ray.z * plane, h, w);
        const bf16* img = src_b + (size_t)view * n * c;
        const bf16* cur_p = cur_b + (size_t)pix * c;
        bf16* ds_out = d_s_b + (((size_t)view * d + di) * n + pix) * c;
        float* dx = DX + p * dxs;
        const float d_dot = dx[nf + view] * tp.mask;
        dx[nf + view] = d_dot;
        if (vec8) {
          for (int ch0 = 0; ch0 < c; ch0 += 8) {
            float s[8], cv[8], ds[8];
            sample8(img, c, tp, ch0, s);
            load8(cur_p + ch0, cv);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              float* x = dx + view * c + ch0 + e;
              ds[e] = round_to<bf16>(*x + d_dot * cv[e]);
              *x = s[e];
              ds_max = max(ds_max, __float_as_uint(fabsf(ds[e])));
            }
            *reinterpret_cast<uint4*>(ds_out + ch0) =
                make_uint4(pack_bf16(ds[0], ds[1]), pack_bf16(ds[2], ds[3]),
                           pack_bf16(ds[4], ds[5]), pack_bf16(ds[6], ds[7]));
          }
        } else {
          for (int ch = 0; ch < c; ++ch) {
            float* x = dx + view * c + ch;
            const float ds =
                round_to<bf16>(*x + d_dot * __bfloat162float(cur_p[ch]));
            *x = sample1(img, c, tp, ch);
            ds_out[ch] = __float2bfloat16_rn(ds);
            ds_max = max(ds_max, __float_as_uint(fabsf(ds)));
          }
        }
      }
      __syncthreads();

      // ---- 7. d_cur += d_x[ref columns] + sum over views of d_dot * sample --
      for (int item = tid; item < M * c; item += kMmaThreads) {
        const int p = item / c;
        const int ch = item % c;
        const float* dx = DX + p * dxs;
        float s = dx[k * c + ch];
        for (int view = 0; view < k; ++view) {
          s = fmaf(dx[nf + view], dx[view * c + ch], s);
        }
        DC[item] += s;
      }
    }
    __syncthreads();
    for (int item = tid; item < M * c; item += kMmaThreads) {
      if (p0 + item / c < n) d_cur[((size_t)bi * n + p0) * c + item] = DC[item];
    }
  }

  ds_max = __reduce_max_sync(0xffffffffu, ds_max);
  if (lane == 0) atomicMax(d_s_max, ds_max);

  // ---- the block's partial sums ------------------------------------------
  __syncthreads();
  float* part = partials + (size_t)blockIdx.x * n_params;
  for (int i = tid; i < cin * kHidden; i += kMmaThreads) {
    part[i] = DW0[dw0_at(i / kHidden, i % kHidden)];
  }
  float* pw1 = part + cin * kHidden;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float* at = pw1 + (16 * warp + gq + 8 * half) * kHidden + 8 * j + 2 * t;
      at[0] = dw1[j][2 * half];  // partials rows are not 8-byte aligned
      at[1] = dw1[j][2 * half + 1];
    }
  }
  const int base = (cin + kHidden) * kHidden;
  for (int i = tid; i < 3 * kHidden; i += kMmaThreads) part[base + i] = SUMS[i];
  if (tid == 0) part[base + 3 * kHidden] = db2;
}

// out[i] = sum over blocks of partials[block][i], in block order.
__global__ void sum_partials_kernel(const float* __restrict__ partials,
                                    float* __restrict__ out, int blocks,
                                    int n_params) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_params) return;
  float s = 0.f;
  for (int blk = 0; blk < blocks; ++blk) {
    s += partials[(size_t)blk * n_params + i];
  }
  out[i] = s;
}

template <typename T>
int launch_bwd(const void* src, const void* cur, const void* proj,
               const void* invK, const void* planes, const void* pose_meta,
               const void* src_loc, const void* w0, const void* w0t,
               const void* b0, const void* w1, const void* w1t,
               const void* b1, const void* w2, const void* g, void* d_s,
               void* d_s_max, void* d_cur, void* partials, void* d_params,
               int blocks, int b, int k, int h, int w, int c, int d,
               cudaStream_t stream) {
  const int cin = (k + 1) * c + 10 * k + 4;
  const int n_params = cin * kHidden + kHidden * kHidden + 3 * kHidden + 1;
  const size_t smem =
      ((size_t)(cin + kHidden) * kHidden + (size_t)(cin + 2 * kHidden) * kBwdTile +
       kBwdTile + (size_t)kBwdTile * c) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_sweep_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_sweep_bwd_kernel<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(src), static_cast<const T*>(cur),
      static_cast<const float*>(proj), static_cast<const float*>(invK),
      static_cast<const float*>(planes), static_cast<const float*>(pose_meta),
      static_cast<const float*>(src_loc), static_cast<const T*>(w0),
      static_cast<const T*>(w0t), static_cast<const float*>(b0),
      static_cast<const T*>(w1), static_cast<const T*>(w1t),
      static_cast<const float*>(b1), static_cast<const T*>(w2),
      static_cast<const float*>(g), static_cast<T*>(d_s),
      static_cast<unsigned*>(d_s_max), static_cast<float*>(d_cur),
      static_cast<float*>(partials), b, k, h, w, c, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<(n_params + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(partials), static_cast<float*>(d_params),
      blocks, n_params);
  return (int)cudaGetLastError();
}

int launch_bwd_mma(const void* src, const void* cur, const void* proj,
                   const void* invK, const void* planes,
                   const void* pose_meta, const void* src_loc,
                   const void* w0, const void* b0, const void* w1,
                   const void* b1, const void* w2, const void* g,
                   void* d_s, void* d_s_max, void* d_cur, void* partials,
                   void* d_params, int blocks, int b, int k, int h, int w,
                   int c, int d, cudaStream_t stream) {
  const int cin = mlp_in_channels(k, c);
  const int n_params = cin * kHidden + kHidden * kHidden + 3 * kHidden + 1;
  const size_t smem = bwd_mma_smem_bytes(k, c);
  cudaError_t err = cudaFuncSetAttribute(
      fused_sweep_bwd_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec8 = c % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(cur) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(d_s) % 16 == 0;
  fused_sweep_bwd_mma_kernel<<<blocks, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(src), static_cast<const bf16*>(cur),
      static_cast<const float*>(proj), static_cast<const float*>(invK),
      static_cast<const float*>(planes), static_cast<const float*>(pose_meta),
      static_cast<const float*>(src_loc), static_cast<const bf16*>(w0),
      static_cast<const float*>(b0), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(g), static_cast<bf16*>(d_s),
      static_cast<unsigned*>(d_s_max), static_cast<float*>(d_cur),
      static_cast<float*>(partials), b, k, h, w, c, d, vec8);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<(n_params + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(partials), static_cast<float*>(d_params),
      blocks, n_params);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = success).
extern "C" int fused_sweep_mlp_bwd(
    int dtype, const void* src, const void* cur, const void* proj,
    const void* invK, const void* planes, const void* pose_meta,
    const void* src_loc, const void* w0, const void* w0t, const void* b0,
    const void* w1, const void* w1t, const void* b1, const void* w2,
    const void* g, void* d_s, void* d_s_max, void* d_cur, void* partials,
    void* d_params, int blocks, int b, int k, int h, int w, int c, int d,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_bwd<float>(src, cur, proj, invK, planes, pose_meta,
                             src_loc, w0, w0t, b0, w1, w1t, b1, w2, g, d_s,
                             d_s_max, d_cur, partials, d_params, blocks, b,
                             k, h, w, c, d, s);
  }
  if (dtype == 1) {
    return launch_bwd_mma(src, cur, proj, invK, planes, pose_meta, src_loc,
                          w0, b0, w1, b1, w2, g, d_s, d_s_max, d_cur,
                          partials, d_params, blocks, b, k, h, w, c, d, s);
  }
  return (int)cudaErrorInvalidValue;
}
