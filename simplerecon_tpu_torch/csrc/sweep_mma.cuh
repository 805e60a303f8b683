// The warp-level bf16 tile that the bf16 sweep kernels (K1 in
// fused_sweep.cu, K2 in fused_sweep_bwd.cu, K4 and K5 in early_sweeps.cu)
// run their MLP products on: mma.sync m16n8k16 with bf16 operands and
// float32 accumulation, fed by ldmatrix from shared memory. Raw PTX, no
// CUTLASS, so nvcc stays at seconds. `mlp_rows` at the end is the forward
// MLP that K1, K4 and K5 share.
//
// The JAX kernels run the same products as bf16 matrix products with
// float32 accumulation (simplerecon_tpu/ops/pallas_cv.py:343-350 forward,
// :859-888 backward), and the plain versions round at the same points, so
// moving a product onto the tensor cores changes only the order of its
// float32 sums.
//
// Fragments of one m16n8k16 product, lane = 4 * g + t (g = lane / 4,
// t = lane % 4), each register two bf16 (lower index in the low half):
//   A (16 x 16): a[0] = A[g][2t..2t+1], a[1] = A[g+8][2t..], a[2] =
//                A[g][2t+8..], a[3] = A[g+8][2t+8..];
//   B (16 x 8):  b[0] = B[2t..2t+1][g], b[1] = B[2t+8..2t+9][g];
//   C (16 x 8):  c[0], c[1] = C[g][2t], C[g][2t+1]; c[2], c[3] = row g+8.
// C of n-tiles 2kk and 2kk+1 is, element for element, the A fragment of
// k-step kk of the next product (`accum_to_a`), so a hidden layer can
// stay in registers.
//
// Shared-memory operands are bf16, row-major, s elements a row, with s / 2
// words an odd multiple of 4 modulo 32, so the eight 16-byte rows that
// one ldmatrix phase reads fall in distinct banks: s = cols + 8 for cols
// a multiple of 16.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kHidden = 128;       // MLP width
constexpr int kWs = kHidden + 8;   // weight row stride in shared memory

__device__ __forceinline__ float leaky_relu(float x) {
  return x > 0.f ? x : 0.01f * x;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a * b for one 16 x 8 x 16 tile.
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rounds a float32 value to bf16 (round to nearest even) and back.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A fragment of rows [m0, m0 + 16) and columns [k0, k0 + 16) of a
// row-major A (s elements a row).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* A,
                                       int s, int m0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, smem_addr(A + (m0 + (lane & 15)) * s + k0 + (lane >> 4) * 8));
}

// The same fragment of A = S^T, S row-major (rows k, columns m).
__device__ __forceinline__ void load_a_t(uint32_t (&a)[4], const bf16* S,
                                         int s, int m0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(a, smem_addr(S + (k0 + (lane & 7) + ((lane >> 4) << 3)) * s +
                         m0 + ((lane >> 3) & 1) * 8));
}

// B fragments of n-tiles [n0, n0 + 8) (b[0], b[1]) and [n0 + 8, n0 + 16)
// (b[2], b[3]) at rows [k0, k0 + 16) of a row-major B (rows k).
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* B,
                                       int s, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(b, smem_addr(B + (k0 + (lane & 15)) * s + n0 + (lane >> 4) * 8));
}

// The same fragments of B = S^T, S row-major (rows n): this lane's row
// of S is `row`, which the caller picks (n0 + (lane & 7) + ((lane >> 4)
// << 3) for a plain transpose; `b_t_row` gives it).
__device__ __forceinline__ void load_b_t(uint32_t (&b)[4], const bf16* row,
                                         int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(b, smem_addr(row + k0 + ((lane >> 3) & 1) * 8));
}

__device__ __forceinline__ int b_t_row(int n0) {
  const int lane = threadIdx.x & 31;
  return n0 + (lane & 7) + ((lane >> 4) << 3);
}

// The A fragment of k-step kk of a product whose A is the accumulators
// c[n-tile][4] of the previous one, rounded to bf16.
template <int NT>
__device__ __forceinline__ void accum_to_a(uint32_t (&a)[4],
                                           const float (&c)[NT][4], int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// c[j] += A[m0..m0+16) x B[.., n0 + 8j ..) over k in [0, kdim), j < NT
// (NT even): A row-major (sa), B row-major with rows k (sb).
template <int NT>
__device__ __forceinline__ void warp_product(float (&c)[NT][4],
                                             const bf16* A, int sa, int m0,
                                             const bf16* B, int sb, int n0,
                                             int kdim) {
  for (int k0 = 0; k0 < kdim; k0 += 16) {
    uint32_t a[4];
    load_a(a, A, sa, m0, k0);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      load_b(b, B, sb, k0, n0 + 8 * j);
      mma_bf16(c[j], a, b[0], b[1]);
      mma_bf16(c[j + 1], a, b[2], b[3]);
    }
  }
}

// Copies `rows` rows of `cols` bf16 (a multiple of 8) from global src
// (row-major, dense) to shared dst (s elements a row): 16-byte cp.async
// where src is 16-byte aligned, else 2-byte loads. Every thread of the
// block calls it; the caller waits (`copy_wait`) and syncs.
__device__ __forceinline__ void copy_rows(bf16* dst, int s,
                                          const bf16* __restrict__ src,
                                          int rows, int cols) {
  const int chunks = cols / 8;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
      const int r = i / chunks, q = i % chunks;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem_addr(dst + r * s + q * 8)),
                   "l"(src + (size_t)r * cols + q * 8));
    }
    asm volatile("cp.async.commit_group;\n" ::);
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
      dst[(i / cols) * s + i % cols] = src[i];
    }
  }
}

__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// The MLP C_in -> 128 -> 128 -> 1 with LeakyReLU(0.01) of one warp's 16
// rows [m0, m0 + 16) of the bf16 input tile X (xs elements a row, its
// first cinp columns read; cinp a multiple of 16). W0 (cinp rows) and W1
// (128 rows) are bf16 in shared memory, kWs elements a row; b0, b1 and
// w2 float32 in shared memory. Layer 0 from X and W0; h0 =
// round(lrelu(x W0 + b0)) goes into layer 1's A fragments in registers
// (`accum_to_a`); layer 1 from W1; the head round(lrelu(h1p + b1)) . w2
// as a dot over each quad's columns, then a quad shuffle. Returns the
// scores of rows m0 + g and m0 + g + 8 (g = lane / 4) without b2; every
// lane of a quad holds them. Every lane of the warp calls it.
__device__ __forceinline__ float2 mlp_rows(const bf16* X, int xs, int m0,
                                           int cinp, const bf16* W0,
                                           const bf16* W1, const float* B0,
                                           const float* B1,
                                           const float* W2) {
  const int t = threadIdx.x & 3;
  // layer 0: h0 = round(lrelu(x W0 + b0)), 16 rows x 128
  float acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }
  warp_product<16>(acc, X, xs, m0, W0, kWs, 0, cinp);
  uint32_t a1[8][4];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 bj = *reinterpret_cast<const float2*>(B0 + 8 * j + 2 * t);
    acc[j][0] = leaky_relu(acc[j][0] + bj.x);
    acc[j][1] = leaky_relu(acc[j][1] + bj.y);
    acc[j][2] = leaky_relu(acc[j][2] + bj.x);
    acc[j][3] = leaky_relu(acc[j][3] + bj.y);
  }
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) accum_to_a(a1[kk], acc, kk);

  // layer 1 from registers
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
    for (int j = 0; j < 16; j += 2) {
      uint32_t bf[4];
      load_b(bf, W1, kWs, 16 * kk, 8 * j);
      mma_bf16(acc[j], a1[kk], bf[0], bf[1]);
      mma_bf16(acc[j + 1], a1[kk], bf[2], bf[3]);
    }
  }

  // head: round(lrelu(h1p + b1)) . w2, rows g and g + 8
  float lo = 0.f, hi = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = 8 * j + 2 * t;
    const float2 bj = *reinterpret_cast<const float2*>(B1 + col);
    const float2 wj = *reinterpret_cast<const float2*>(W2 + col);
    lo = fmaf(round_bf16(leaky_relu(acc[j][0] + bj.x)), wj.x, lo);
    lo = fmaf(round_bf16(leaky_relu(acc[j][1] + bj.y)), wj.y, lo);
    hi = fmaf(round_bf16(leaky_relu(acc[j][2] + bj.x)), wj.x, hi);
    hi = fmaf(round_bf16(leaky_relu(acc[j][3] + bj.y)), wj.y, hi);
  }
#pragma unroll
  for (int s = 1; s < 4; s <<= 1) {
    lo += __shfl_xor_sync(0xffffffffu, lo, s);
    hi += __shfl_xor_sync(0xffffffffu, hi, s);
  }
  return make_float2(lo, hi);
}

}  // namespace
