// Fused anti-aliased max-blur-pool of the matching encoder's stem, and its
// backward: a 2x2 stride-1 VALID max-pool, a reflect pad (1, 2, 1, 2) and
// the depthwise [1,3,3,1] x [1,3,3,1] / 64 blur at stride 2, on NCHW maps.
//
// Replaces the TPU kernels simplerecon_tpu/ops/pallas_pool.py::
// max_blur_pool_pallas (forward: _fwd_pallas, body _fwd_kernel) and
// _bwd_pallas (body _bwd_kernel), which hold row tiles with halo rows in
// VMEM and run the W blur as a banded matrix product on the MXU.
//
// What bounds it on an H100: device memory. At the dot model's b16
// training step the input is (128, 64, 192, 256): the forward reads it
// once and writes a quarter of it (1.007 GB in bf16, 0.3005 ms at 3.35
// TB/s); the backward reads x and g and writes dx (1.812 GB, 0.541 ms).
// The arithmetic is a few dozen operations an element, so the design
// keeps each element's loads and operations few enough that the copies
// between device and shared memory set the pace:
//
// - A block owns a tile of one plane: rows of the output (forward) or of
//   dx (backward), up to 128 columns wide, 256 input columns with their
//   halo. It stages the input rows the tile needs into shared memory with
//   16-byte cp.async copies, and writes its outputs with 16-byte stores
//   (8 bf16 or 4 float32 values a lane). Rows whose pitch or base is not
//   16-byte aligned (the wrapper decides from the pointers and the
//   width) are staged and stored element by element instead; the
//   arithmetic is the same. A block takes one tile, and 3 to 6 blocks are
//   resident on an SM, so one block's copies overlap another's
//   arithmetic. Two staging buffers a block (the next tile's copies in
//   flight) and blocks that walk over many tiles were measured too, and
//   were slower in both kernels.
// - Each 2x2 window's maximum is taken once per tile, from the staged
//   rows: the maximum of each horizontal pair, then of two pairs, the
//   pair of one row shared by the windows above and below it. Only the
//   halo windows are taken again: a forward tile's edges, and in the
//   backward one window column and one window row in nine. The
//   forward needs the value only: max.NaN, two bf16 at a time, gives the
//   same blur bit for bit (a zero's sign cannot reach an fma chain that
//   starts from +0, and the card's fma returns one NaN for any NaN). The
//   backward needs which element is the first maximum.
// - The reflect pad is an index map applied to max-pool rows and columns
//   as they are read, never a copy in device memory.
//
// Forward, two phases a tile. (1) The reflect-padded max-pool map of the
// tile, (2 TH + 2) x (2 TW + 2) for TH x TW outputs, into shared memory
// in the input dtype (each entry is one of the inputs, so exactly). (2)
// Each thread takes 8 output columns of 2 output rows: the horizontal
// 4-tap blur at stride 2 of the 6 padded rows they read, then the
// vertical 4-tap, each as a float32 fma chain from 0, in the order of the
// first design (one thread an output, 16 window maxima each), so the
// outputs are the same bits; rounded once to the output dtype.
//
// Backward, a gather with no atomics. A thread takes 8 columns of dx
// and kBwdRows / kBwdGroups rows of the tile, and walks down them with
// the 9 windows left and right of its columns in registers, for two
// window rows at a time: each window's first maximum in row-major order
// (as bit masks) and its gradient, the blur transpose of g along the
// width (the padded positions that reflect onto its column and their
// taps), then along the height. Each element of dx then sums the windows
// (up to four) of which it is the first maximum, in a fixed order: the
// max-pool's routing in PyTorch (a later element wins only if it is
// greater, or NaN) and in XLA's select-and-scatter, which _bwd_kernel
// reproduces. The sums are those of the first design, term for term and
// in its order, so dx is the same bits. Deterministic.
//
// Any H, W >= 4 (the reflect pad needs H - 1 > 2), odd ones included:
// out is ((H - 2) / 2 + 1, (W - 2) / 2 + 1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// forward tile: outputs; 2 output rows x 8 columns an item of phase 2
constexpr int kFwdRows = 16, kFwdCols = 128, kFwdItemRows = 2;
constexpr int kPadRows = 2 * kFwdRows + 2;   // padded max-pool map
constexpr int kPadPitch = 2 * kFwdCols + 8;  // 33 chunks of 8 columns
constexpr int kFwdXRows = 2 * kFwdRows + 3;  // staged input rows
constexpr int kFwdRun = 12;                  // padded rows a phase-1 unit
// backward tile: elements of dx, in kBwdGroups groups of rows, each
// walked by kBwdCols / 8 threads of 8 columns
constexpr int kBwdRows = 64, kBwdCols = 128;
constexpr int kBwdGroups = kThreads / (kBwdCols / 8);
constexpr int kBwdXRows = kBwdRows + 2;
constexpr int kBwdGRows = kBwdRows / 2 + 4;

__host__ __device__ constexpr int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

template <typename T>
struct Tile {
  static constexpr int kVec = 16 / (int)sizeof(T);  // elements in 16 bytes
  // staged row pitches (elements): a tile's columns, its halo and up to
  // a chunk of slack on each side for the 16-byte copies
  static constexpr int kFwdPitch =
      round_up(2 * kFwdCols + 1 + 2 * kVec, kVec);
  static constexpr int kBwdPitch = round_up(kBwdCols + 2 * kVec, kVec);
  static constexpr int kGPitch = round_up(kBwdCols / 2 + 2 + 2 * kVec, kVec);
  static constexpr int kFwdSmem =
      (kFwdXRows * kFwdPitch + kPadRows * kPadPitch) * (int)sizeof(T);
  static constexpr int kBwdSmem =
      (kBwdXRows * kBwdPitch + kBwdGRows * kGPitch) * (int)sizeof(T);
};

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

// 8 consecutive values from 16-byte aligned shared memory, as float32.
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v[2 * q] = __uint_as_float(w[q] << 16);
    v[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
  }
}

// 4 consecutive values from (4-element) aligned shared memory.
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(a.x << 16);
  v[1] = __uint_as_float(a.x & 0xffff0000u);
  v[2] = __uint_as_float(a.y << 16);
  v[3] = __uint_as_float(a.y & 0xffff0000u);
}

// 8 values to 16-byte aligned memory (shared or global), rounded once.
__device__ __forceinline__ void store8(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  unsigned w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
    w[q] = *reinterpret_cast<const unsigned*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// Writes `n` (at most 8) values of v to dst, rounded once: one or two
// 16-byte stores for all 8 when `vec` (dst then 16-byte aligned), else
// element stores.
template <typename T>
__device__ __forceinline__ void write_row(T* dst, const float* v, int n,
                                          bool vec) {
  if (vec && n == 8) {
    store8(dst, v);
    return;
  }
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    if (t < n) dst[t] = from_float<T>(v[t]);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// Waits for all of this thread's copies.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Copies rows [r0, r0 + nrows) and columns [c0, c1] of a W-wide plane to
// shared memory, `pitch` elements a row, column c at c - cb with cb = c0
// rounded down to a 16-byte chunk: 16-byte cp.async copies of whole
// chunks when `vec` (the plane's rows 16-byte aligned), else one element
// a load. The caller waits for the copies (cp_async_wait_all) and
// synchronises.
template <typename T>
__device__ void stage(T* sm, int pitch, const T* plane, int W, int r0,
                      int nrows, int c0, int c1, bool vec) {
  constexpr int V = Tile<T>::kVec;
  const int cb = c0 & ~(V - 1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (vec) {
    const int chunks = (c1 - cb) / V + 1;
    for (int r = warp; r < nrows; r += kWarps) {
      const T* src = plane + (size_t)(r0 + r) * W + cb;
      for (int k = lane; k < chunks; k += 32) {
        cp_async16(sm + r * pitch + k * V, src + k * V);
      }
    }
    return;
  }
  for (int r = warp; r < nrows; r += kWarps) {
    const T* src = plane + (size_t)(r0 + r) * W;
    for (int c = c0 + lane; c <= c1; c += 32) {
      sm[r * pitch + c - cb] = src[c];
    }
  }
}

// Index of the reflect-padded max-pool map (padded index - 1) in [0, n).
__device__ __forceinline__ int reflect(int q, int n) {
  return q < 0 ? -q : (q >= n ? 2 * (n - 1) - q : q);
}

// The lowest index that reflect(q, n) takes for q in [a, b] (b <= n + 1).
__device__ __forceinline__ int reflect_low(int a, int b, int n) {
  const int lo = a < 0 ? 0 : a;
  return b >= n ? min(lo, 2 * (n - 1) - b) : lo;
}

// Whether b replaces a as the first maximum so far in row-major order: a
// later element wins only if it is greater, or NaN.
__device__ __forceinline__ bool takes(float b, float a) {
  return b > a || isnan(b);
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

// ---------------------------------------------------------------- forward

// The larger of a and b, NaN if either is. The forward needs only each
// window's maximum as a value: zeros of either sign give the same blur
// (each output is an fma chain from +0), and a NaN gives a NaN.
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ unsigned max_nan_bf16x2(unsigned a, unsigned b) {
  unsigned r;
  asm("max.NaN.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// 8 consecutive maxima of one max-pool row or of one input row's
// horizontal pairs, in the input dtype: 8 floats, or 4 bf16 pairs.
template <typename T>
struct Maxima;
template <>
struct Maxima<float> {
  float v[8];
};
template <>
struct Maxima<__nv_bfloat16> {
  unsigned v[4];
};

// The maxima of the horizontal pairs (c, c + 1) of one staged row for 8
// max-pool columns: the columns s .. s + 8 (s + 1 16-byte aligned) when
// `inside`, else the columns cols[t] and cols[t] + 1.
__device__ __forceinline__ void pair_max(const float* row, int s, bool inside,
                                         const int (&cols)[8],
                                         Maxima<float>* hp) {
  if (inside) {
    float v[9];
    v[0] = row[s];
    load8(row + s + 1, v + 1);
#pragma unroll
    for (int t = 0; t < 8; ++t) hp->v[t] = max_nan(v[t], v[t + 1]);
    return;
  }
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    hp->v[t] = max_nan(row[cols[t]], row[cols[t] + 1]);
  }
}
__device__ __forceinline__ void pair_max(const __nv_bfloat16* row, int s,
                                         bool inside, const int (&cols)[8],
                                         Maxima<__nv_bfloat16>* hp) {
  const unsigned short* r = reinterpret_cast<const unsigned short*>(row);
  if (inside) {
    // w[k] holds (x[s + 2k + 1], x[s + 2k + 2]); pairing each with
    // (x[s + 2k], x[s + 2k + 1]) gives the maxima 2k and 2k + 1
    const uint4 q = *reinterpret_cast<const uint4*>(r + s + 1);
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
    unsigned prev = r[s];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      hp->v[k] = max_nan_bf16x2(__byte_perm(prev, w[k], 0x5410), w[k]);
      prev = w[k] >> 16;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned a = r[cols[2 * k]] | (unsigned)r[cols[2 * k + 1]] << 16;
    const unsigned b =
        r[cols[2 * k] + 1] | (unsigned)r[cols[2 * k + 1] + 1] << 16;
    hp->v[k] = max_nan_bf16x2(a, b);
  }
}

// The window maxima of two pair rows, stored to 16-byte aligned shared
// memory.
__device__ __forceinline__ void store_max(float* dst, const Maxima<float>& a,
                                          const Maxima<float>& b) {
  float m[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) m[t] = max_nan(a.v[t], b.v[t]);
  store8(dst, m);
}
__device__ __forceinline__ void store_max(__nv_bfloat16* dst,
                                          const Maxima<__nv_bfloat16>& a,
                                          const Maxima<__nv_bfloat16>& b) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(
      max_nan_bf16x2(a.v[0], b.v[0]), max_nan_bf16x2(a.v[1], b.v[1]),
      max_nan_bf16x2(a.v[2], b.v[2]), max_nan_bf16x2(a.v[3], b.v[3]));
}

// Where a forward tile lies: plane, output rows [oi0, oi0 + nro) and
// columns [oc0, oc0 + nco); padded row k is max-pool row
// reflect(qr0 + k, nh) and padded column c column reflect(qc0 + c, nw),
// k <= 2 nro + 1 and c <= 2 nco + 1, which read max-pool rows [mr0, mr1]
// and columns [mc0, mc1].
struct FwdTile {
  int plane, oi0, oc0, nro, nco, qr0, qc0, qc1, mr0, mr1, mc0, mc1;
  __device__ FwdTile(int t, int H, int W, int tiles_h, int tiles_w) {
    const int Ho = (H - 2) / 2 + 1, Wo = (W - 2) / 2 + 1;
    const int nh = H - 1, nw = W - 1;
    const int per_plane = tiles_h * tiles_w, in_plane = t % per_plane;
    plane = t / per_plane;
    oi0 = in_plane / tiles_w * kFwdRows;
    oc0 = in_plane % tiles_w * kFwdCols;
    nro = min(kFwdRows, Ho - oi0);
    nco = min(kFwdCols, Wo - oc0);
    qr0 = 2 * oi0 - 1;
    qc0 = 2 * oc0 - 1;
    const int qr1 = 2 * (oi0 + nro);
    qc1 = 2 * (oc0 + nco);
    mr0 = reflect_low(qr0, qr1, nh);
    mr1 = min(qr1, nh - 1);
    mc0 = reflect_low(qc0, qc1, nw);
    mc1 = min(qc1, nw - 1);
  }
};

// A block takes a tile of kFwdRows x kFwdCols outputs.
template <typename T>
__global__ void __launch_bounds__(kThreads)
max_blur_pool_fwd_kernel(const T* __restrict__ x, T* __restrict__ out,
                         int H, int W, int tiles_h, int tiles_w, int vec_in,
                         int vec_out) {
  constexpr int XP = Tile<T>::kFwdPitch, V = Tile<T>::kVec;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);  // staged input rows
  T* ms = xs + kFwdXRows * XP;         // the padded max-pool map
  const int Ho = (H - 2) / 2 + 1, Wo = (W - 2) / 2 + 1;
  const int nh = H - 1, nw = W - 1;  // max-pool map
  const FwdTile f(blockIdx.x, H, W, tiles_h, tiles_w);
  stage(xs, XP, x + (size_t)f.plane * H * W, W, f.mr0, f.mr1 - f.mr0 + 2,
        f.mc0, f.mc1 + 1, vec_in != 0);
  cp_async_wait_all();
  __syncthreads();
  const int cb = f.mc0 & ~(V - 1);

  // 1. the padded max-pool map, a unit 8 columns of up to kFwdRun rows
  const int prows = 2 * f.nro + 2, pcols = 2 * f.nco + 2;
  const int chunks = (pcols + 7) / 8;
  for (int u = threadIdx.x;
       u < chunks * ((prows + kFwdRun - 1) / kFwdRun); u += kThreads) {
    const int cc = u % chunks, k0 = u / chunks * kFwdRun;
    const int k1 = min(prows, k0 + kFwdRun);
    const int q0 = f.qc0 + 8 * cc;
    const bool inside = q0 >= 0 && q0 + 7 <= nw - 1 && 8 * cc + 8 <= pcols;
    int cols[8];  // staged column of each padded column's pair
#pragma unroll
    for (int t8 = 0; t8 < 8; ++t8) {
      cols[t8] = reflect(min(q0 + t8, f.qc1), nw) - cb;
    }
    Maxima<T> top, bot;
    int prev = -2;  // max-pool row of the last padded row
    for (int k = k0; k < k1; ++k) {
      const int r = reflect(f.qr0 + k, nh);
      if (r == prev + 1) {
        top = bot;
      } else {
        pair_max(xs + (r - f.mr0) * XP, q0 - cb, inside, cols, &top);
      }
      pair_max(xs + (r + 1 - f.mr0) * XP, q0 - cb, inside, cols, &bot);
      prev = r;
      store_max(ms + k * kPadPitch + 8 * cc, top, bot);
    }
  }
  __syncthreads();

  // 2. an item: 8 output columns of kFwdItemRows rows; the horizontal
  //    blur of each padded row it reads, then the vertical
  const int ccs = (f.nco + 7) / 8;
  T* op = out + (size_t)f.plane * Ho * Wo;
  for (int u = threadIdx.x;
       u < ccs * ((f.nro + kFwdItemRows - 1) / kFwdItemRows);
       u += kThreads) {
    const int cc = u % ccs, r0 = u / ccs * kFwdItemRows;
    const int nr = min(kFwdItemRows, f.nro - r0);
    const int nc = min(8, f.nco - 8 * cc);
    float hb[2 * kFwdItemRows + 2][8];
#pragma unroll
    for (int k = 0; k < 2 * kFwdItemRows + 2; ++k) {
      if (k >= 2 * nr + 2) break;
      const T* mrow = ms + (2 * r0 + k) * kPadPitch + 16 * cc;
      float m[18];
      load8(mrow, m);
      load8(mrow + 8, m + 8);
      m[16] = to_float(mrow[16]);
      m[17] = to_float(mrow[17]);
#pragma unroll
      for (int t8 = 0; t8 < 8; ++t8) {
        float row = 0.f;
#pragma unroll
        for (int b = 0; b < 4; ++b) row = fmaf(tap(b), m[2 * t8 + b], row);
        hb[k][t8] = row;
      }
    }
#pragma unroll
    for (int a0 = 0; a0 < kFwdItemRows; ++a0) {
      if (a0 >= nr) break;
      float acc[8];
#pragma unroll
      for (int t8 = 0; t8 < 8; ++t8) {
        acc[t8] = 0.f;
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          acc[t8] = fmaf(tap(a), hb[2 * a0 + a][t8], acc[t8]);
        }
      }
      write_row(op + (size_t)(f.oi0 + r0 + a0) * Wo + f.oc0 + 8 * cc, acc,
                nc, vec_out != 0);
    }
  }
}

// --------------------------------------------------------------- backward

// The blur transpose of g row `grow` (indexed by g column) along the
// width at the 9 window columns j0 .. j0 + 8: the sum of tap(b) g[s] over
// the outputs s whose taps 2 s + b - 1 (padded positions) reflect onto j.
// A padded position q is read by the taps b = r and r + 2, with
// r = (q + 1) mod 2, of the outputs (q + 1 - r) / 2 and one less. Inside
// (every j in [2, nw - 4]) that is j itself and two taps: j0 + 1 is even,
// so window j0 + t reads g columns s - 1 and s, s = s1 + t / 2, with taps
// (2, 0) for even t and (3, 1) for odd t. 0 where there is no window.
template <typename T>
__device__ __forceinline__ void transpose_row(const T* grow, int j0,
                                              bool inside, unsigned exists,
                                              int nw, int Wo, float* v) {
  if (inside) {
    const int s1 = (j0 + 1) >> 1;
    float gv[6];
    gv[0] = to_float(grow[s1 - 1]);
    load4(grow + s1, gv + 1);
    gv[5] = to_float(grow[s1 + 4]);
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int rc = t & 1;
      v[t] = fmaf(tap(rc + 2), gv[t >> 1],
                  fmaf(tap(rc), gv[(t >> 1) + 1], 0.f));
    }
    return;
  }
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const int j = j0 + t;
    float row = 0.f;
    if (exists >> t & 1) {
#pragma unroll
      for (int ec = 0; ec < 3; ++ec) {
        int qc;
        if (!padded_source(ec, j, nw, &qc)) continue;
        const int rc = (qc + 1) & 1, s0 = (qc + 1 - rc) >> 1;
#pragma unroll
        for (int ac = 0; ac < 2; ++ac) {
          const int s = s0 - ac;
          if (s < 0 || s >= Wo) continue;
          row = fmaf(tap(rc + 2 * ac), to_float(grow[s]), row);
        }
      }
    }
    v[t] = row;
  }
}

// The maxima of the horizontal pairs (j, j + 1) of one staged x row for
// the 9 windows j = j0 .. j0 + 8, and which of each pair is the first
// maximum: bit t of the result is set for the second. `row` is indexed by
// x column; columns j0 .. j0 + 9 when `inside` (j0 + 1 16-byte
// aligned), else clamped to [lo, hi].
template <typename T>
__device__ __forceinline__ unsigned pair_first_max(const T* row, int j0,
                                                   bool inside, int lo,
                                                   int hi, float* v) {
  float e[10];
  if (inside) {
    e[0] = to_float(row[j0]);
    load8(row + j0 + 1, e + 1);
    e[9] = to_float(row[j0 + 9]);
  } else {
#pragma unroll
    for (int t = 0; t < 10; ++t) {
      e[t] = to_float(row[min(max(j0 + t, lo), hi)]);
    }
  }
  unsigned second = 0;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const bool s = takes(e[t + 1], e[t]);
    v[t] = s ? e[t + 1] : e[t];
    if (s) second |= 1u << t;
  }
  return second;
}

// Where a backward tile lies: plane, dx rows [y0, y0 + nr) and columns
// [x0, x0 + nc). Its windows (i, j), i in [y0 - 1, y0 + nr - 1] and j in
// [x0 - 1, x0 + nc - 1], those that exist (0 <= i < nh, 0 <= j < nw),
// read x rows [xr0, xr1] and columns [xc0, xc1], and g rows [gr0, gr1]
// and columns [gc0, gc1], with the padded positions that reflect onto
// them.
struct BwdTile {
  int plane, y0, x0, nr, nc, xr0, xr1, xc0, xc1, gr0, gr1, gc0, gc1;
  __device__ BwdTile(int t, int H, int W, int tiles_h, int tiles_w) {
    const int Ho = (H - 2) / 2 + 1, Wo = (W - 2) / 2 + 1;
    const int per_plane = tiles_h * tiles_w, in_plane = t % per_plane;
    plane = t / per_plane;
    y0 = in_plane / tiles_w * kBwdRows;
    x0 = in_plane % tiles_w * kBwdCols;
    nr = min(kBwdRows, H - y0);
    nc = min(kBwdCols, W - x0);
    xr0 = max(y0 - 1, 0);
    xr1 = min(y0 + nr, H - 1);
    xc0 = max(x0 - 1, 0);
    xc1 = min(x0 + nc, W - 1);
    const int ihi = min(y0 + nr - 1, H - 2), jhi = min(x0 + nc - 1, W - 2);
    gr0 = max(0, ((xr0 + 1) >> 1) - 1);
    gr1 = min(Ho - 1, ((ihi + 1) >> 1) + 1);
    gc0 = max(0, ((xc0 + 1) >> 1) - 1);
    gc1 = min(Wo - 1, ((jhi + 1) >> 1) + 1);
  }
};

// A block takes a tile of kBwdRows x kBwdCols elements of dx; a thread
// takes 8 of its columns and kBwdRows / kBwdGroups of its rows, and walks
// down them: each window row i (the 9 windows left and right of its
// columns) in registers, its first maxima and gradients, then dx row i
// from window rows i - 1 and i.
template <typename T>
__global__ void __launch_bounds__(kThreads)
max_blur_pool_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                         T* __restrict__ dx, int H, int W, int tiles_h,
                         int tiles_w, int vec_x, int vec_g) {
  constexpr int XP = Tile<T>::kBwdPitch, GP = Tile<T>::kGPitch;
  constexpr int V = Tile<T>::kVec;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);  // staged x rows
  T* gs = xs + kBwdXRows * XP;         // staged g rows
  const int Ho = (H - 2) / 2 + 1, Wo = (W - 2) / 2 + 1;
  const int nh = H - 1, nw = W - 1;
  const BwdTile b(blockIdx.x, H, W, tiles_h, tiles_w);
  stage(xs, XP, x + (size_t)b.plane * H * W, W, b.xr0, b.xr1 - b.xr0 + 1,
        b.xc0, b.xc1, vec_x != 0);
  stage(gs, GP, g + (size_t)b.plane * Ho * Wo, Wo, b.gr0, b.gr1 - b.gr0 + 1,
        b.gc0, b.gc1, vec_g != 0);
  cp_async_wait_all();
  __syncthreads();

  const int cc = threadIdx.x % (kBwdCols / 8);
  const int rows = kBwdRows / kBwdGroups;
  const int ya = b.y0 + threadIdx.x / (kBwdCols / 8) * rows;
  const int yb = min(ya + rows, b.y0 + b.nr);
  if (8 * cc >= b.nc || ya >= yb) return;
  const int n = min(8, b.nc - 8 * cc);
  const int j0 = b.x0 - 1 + 8 * cc;  // windows j0 .. j0 + 8
  const T* xrow = xs - b.xr0 * XP - (b.xc0 & ~(V - 1));  // by x row, column
  const T* grow = gs - b.gr0 * GP - (b.gc0 & ~(V - 1));  // by g row, column
  unsigned exists = 0;  // bit t: window j0 + t exists
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    if (j0 + t >= 0 && j0 + t <= nw - 1 && j0 + t <= b.x0 + b.nc - 1) {
      exists |= 1u << t;
    }
  }
  const bool inside = j0 >= 0 && j0 + 8 <= nw - 1 && j0 + 8 <= b.x0 + b.nc - 1;
  const bool g_inside = inside && j0 >= 2 && j0 + 8 <= nw - 4;

  // window row i: gradient gb[t] of window j0 + t, and bit t of mb[q]
  // set where its first maximum is q (0..3 for (i, j), (i, j + 1),
  // (i + 1, j), (i + 1, j + 1)), no bit where there is no window; row
  // i - 1 in ga, ma
  float ga[9], gb[9];
  unsigned ma[4] = {0, 0, 0, 0}, mb[4];
  float tv[9];         // pair maxima of x row i
  unsigned ts = 0;     // and which of each pair is the first maximum
  int top_row = -2;    // the x row they hold
  float r0[9], r1[9];  // the width transposes of g rows o - 1 and o
  int o_held = -2;     // the o they hold
  for (int i = ya - 1; i < yb; ++i) {
    if (i < 0 || i > nh - 1) {
#pragma unroll
      for (int t = 0; t < 9; ++t) gb[t] = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) mb[q] = 0;
    } else {
      if (top_row != i) ts = pair_first_max(xrow + i * XP, j0, inside, b.xc0,
                                            b.xc1, tv);
      float bv[9];
      const unsigned bs = pair_first_max(xrow + (i + 1) * XP, j0, inside,
                                         b.xc0, b.xc1, bv);
      unsigned lower = 0;  // bit t: the bottom pair holds the first maximum
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        if (takes(bv[t], tv[t])) lower |= 1u << t;
        tv[t] = bv[t];
      }
      mb[0] = ~lower & ~ts & exists;
      mb[1] = ~lower & ts & exists;
      mb[2] = lower & ~bs & exists;
      mb[3] = lower & bs & exists;
      ts = bs;
      top_row = i + 1;
      // the gradient: sum over the padded positions that reflect onto
      // row i and their taps, of the width transposes of g's rows
      if (i >= 2 && i <= nh - 4) {
        const int rr = (i + 1) & 1, o = (i + 1 - rr) >> 1;
        if (o != o_held) {
          if (o == o_held + 1) {
#pragma unroll
            for (int t = 0; t < 9; ++t) r0[t] = r1[t];
          } else {
            transpose_row(grow + (o - 1) * GP, j0, g_inside, exists, nw, Wo,
                          r0);
          }
          transpose_row(grow + o * GP, j0, g_inside, exists, nw, Wo, r1);
          o_held = o;
        }
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          gb[t] = fmaf(tap(rr + 2), r0[t], fmaf(tap(rr), r1[t], 0.f));
        }
      } else {
#pragma unroll
        for (int t = 0; t < 9; ++t) gb[t] = 0.f;
#pragma unroll
        for (int er = 0; er < 3; ++er) {
          int qr;
          if (!padded_source(er, i, nh, &qr)) continue;
          const int rr = (qr + 1) & 1, o0 = (qr + 1 - rr) >> 1;
#pragma unroll
          for (int ar = 0; ar < 2; ++ar) {
            const int o = o0 - ar;
            if (o < 0 || o >= Ho) continue;
            float rv[9];
            transpose_row(grow + o * GP, j0, g_inside, exists, nw, Wo, rv);
#pragma unroll
            for (int t = 0; t < 9; ++t) {
              gb[t] = fmaf(tap(rr + 2 * ar), rv[t], gb[t]);
            }
          }
        }
      }
    }
    if (i >= ya) {
      // dx row i: element (i, x) sums the windows (i - di, x - dj) of
      // which it is the first maximum, entry 2 di + dj, in the order
      // (1, 1), (1, 0), (0, 1), (0, 0)
      float acc[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        acc[t] = 0.f;
        if (ma[3] >> t & 1) acc[t] += ga[t];
        if (ma[2] >> (t + 1) & 1) acc[t] += ga[t + 1];
        if (mb[1] >> t & 1) acc[t] += gb[t];
        if (mb[0] >> (t + 1) & 1) acc[t] += gb[t + 1];
      }
      write_row(dx + (size_t)b.plane * H * W + (size_t)i * W + b.x0 + 8 * cc,
                acc, n, vec_x != 0);
    }
#pragma unroll
    for (int t = 0; t < 9; ++t) ga[t] = gb[t];
#pragma unroll
    for (int q = 0; q < 4; ++q) ma[q] = mb[q];
  }
}

bool misaligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 != 0;
}

// Lets `kernel` use `smem` bytes of dynamic shared memory, and as much
// of the SM for shared memory as it can, so that more blocks are
// resident: once a device (bit d of *prepared for device d < 32), since
// each call costs the host microseconds a launch.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem,
                    std::atomic<unsigned>* prepared) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const unsigned bit = device < 32 ? 1u << device : 0u;
  if (prepared->load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) prepared->fetch_or(bit);
  return err;
}

template <typename T>
int launch_fwd(const void* x, void* out, long long planes, int H, int W,
               int vec_in, int vec_out, cudaStream_t stream) {
  const int Ho = (H - 2) / 2 + 1, Wo = (W - 2) / 2 + 1;
  if ((vec_in && (misaligned(x) || W * sizeof(T) % 16 != 0)) ||
      (vec_out && (misaligned(out) || Wo * sizeof(T) % 16 != 0))) {
    return (int)cudaErrorMisalignedAddress;
  }
  const int tiles_h = (Ho + kFwdRows - 1) / kFwdRows;
  const int tiles_w = (Wo + kFwdCols - 1) / kFwdCols;
  const long long tiles = planes * tiles_h * tiles_w;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (tiles == 0) return 0;
  static std::atomic<unsigned> prepared{0};
  const cudaError_t err =
      prepare(max_blur_pool_fwd_kernel<T>, Tile<T>::kFwdSmem, &prepared);
  if (err != cudaSuccess) return (int)err;
  max_blur_pool_fwd_kernel<T>
      <<<(unsigned)tiles, kThreads, Tile<T>::kFwdSmem, stream>>>(
          static_cast<const T*>(x), static_cast<T*>(out), H, W, tiles_h,
          tiles_w, vec_in, vec_out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* g, void* dx, long long planes,
               int H, int W, int vec_x, int vec_g, cudaStream_t stream) {
  const int Wo = (W - 2) / 2 + 1;
  if ((vec_x && (misaligned(x) || misaligned(dx) ||
                 W * sizeof(T) % 16 != 0)) ||
      (vec_g && (misaligned(g) || Wo * sizeof(T) % 16 != 0))) {
    return (int)cudaErrorMisalignedAddress;
  }
  const int tiles_h = (H + kBwdRows - 1) / kBwdRows;
  const int tiles_w = (W + kBwdCols - 1) / kBwdCols;
  const long long tiles = planes * tiles_h * tiles_w;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (tiles == 0) return 0;
  static std::atomic<unsigned> prepared{0};
  const cudaError_t err =
      prepare(max_blur_pool_bwd_kernel<T>, Tile<T>::kBwdSmem, &prepared);
  if (err != cudaSuccess) return (int)err;
  max_blur_pool_bwd_kernel<T>
      <<<(unsigned)tiles, kThreads, Tile<T>::kBwdSmem, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(g),
          static_cast<T*>(dx), H, W, tiles_h, tiles_w, vec_x, vec_g);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; x (planes, H, W), out (planes, Ho, Wo)
// with planes = batch * channels. vec_in: x's rows are staged with 16-byte
// copies (x 16-byte aligned, W * element size a multiple of 16); vec_out:
// out is written with 16-byte stores (the same for out and Wo). Returns a
// cudaError_t (0 = success; cudaErrorMisalignedAddress when a flag asks
// for what the pointers or widths do not allow).
extern "C" int max_blur_pool_fwd(int dtype, const void* x, void* out,
                                 long long planes, int H, int W, int vec_in,
                                 int vec_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_fwd<float>(x, out, planes, H, W, vec_in, vec_out, s);
  }
  if (dtype == 1) {
    return launch_fwd<__nv_bfloat16>(x, out, planes, H, W, vec_in, vec_out,
                                     s);
  }
  return (int)cudaErrorInvalidValue;
}

// g (planes, Ho, Wo) -> dx (planes, H, W), in x's dtype. vec_x: x and dx
// by 16 bytes (both 16-byte aligned, W * element size a multiple of 16);
// vec_g: g by 16 bytes (the same for g and Wo).
extern "C" int max_blur_pool_bwd(int dtype, const void* x, const void* g,
                                 void* dx, long long planes, int H, int W,
                                 int vec_x, int vec_g, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_bwd<float>(x, g, dx, planes, H, W, vec_x, vec_g, s);
  }
  if (dtype == 1) {
    return launch_bwd<__nv_bfloat16>(x, g, dx, planes, H, W, vec_x, vec_g,
                                     s);
  }
  return (int)cudaErrorInvalidValue;
}
