"""Times K1-dot and the scatter against floors of their own source, and
the device operations the scatter's window rests on.

    python -m simplerecon_tpu_torch.scripts.sweep_floor [--batch 16]
        [--source PATH] [--parts ops,dot,lanes,scatter]

- ops: blocks of 256 threads add into distinct shared-memory words, with
  a 64-bit and with a 32-bit `atomicAdd` and with a plain 64-bit
  read-modify-write, and convert float32 to int64 with `__float2ll_rn`
  (the scatter's fixed-point rounding); the SASS instruction each
  compiles to (`cuobjdump -sass`) and its clocks per warp instruction on
  an SM, at the card's boost clock of 1.755 GHz (NVIDIA's data sheet,
  H100 SXM).
- dot: K1-dot (`fused_sweep_dot` of `csrc/fused_sweep.cu`, or of the file
  `--source` names, such as a parent checkout's; both of its designs
  are known) built three ways: as it is; with its tap loads alone (the
  loaded bits folded with XOR, no arithmetic on them); and with its
  arithmetic alone (each tap load reads the pixel's own row instead, so
  the loads coalesce and hit L1).
- lanes: K1-dot and its d_cur mode built with each number of lanes a
  pixel (`DotLanes`) that its 16-byte loads allow.
- scatter: `csrc/sweep_scatter.cu` as it is, with its window adds
  replaced by a sum in a register, with its fixed-point conversion
  replaced by the float's bits, with both, with the adds of zero
  contributions made too (no test a lane), and with three window parts
  where two would do, on seeded sample gradients (K2's mode).
Each at the sweep shape of the dot model and of the hero model (they
are the same) for `--batch` samples, in bf16 and float32 (the scatter
in bf16), with the cameras of both `testing.GEOMETRIES`. Builds with the
port's nvcc flags into `build/sweep_floor/`, loads with ctypes, and
prints the median CUDA-event ms of 20 calls after 3 warm-up calls.
Needs a CUDA card.
"""

import argparse
import ctypes
import hashlib
import statistics
import subprocess
from pathlib import Path

import torch

from simplerecon_tpu_torch.ops import _build
from simplerecon_tpu_torch.testing import (GEOMETRIES, dot_case,
                                           scatter_case, sweep_cotangent)

SWEEP = (7, 96, 128, 16, 64)  # k, h, w, c, d of the dot model's sweep
BOOST_HZ = 1.755e9            # H100 SXM boost clock
OUT = _build.BUILD_DIR.parent / "sweep_floor"

# the two designs of K1-dot, as fused_sweep.cu has had them
FIRST_LOADS = "".join(
    f"    load16(img + (size_t)t.pix[{q}] * kDotC, {name});\n"
    for q, name in enumerate(("nw", "ne", "sw", "se")))
FIRST_DOT = """    float dot = 0.f;
#pragma unroll
    for (int ch = 0; ch < kDotC; ++ch) {
      dot = fmaf(bilinear(t, nw[ch], ne[ch], sw[ch], se[ch]), cur_v[ch], dot);
    }
"""
FIRST_FOLD = """    unsigned bits = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4* row =
          reinterpret_cast<const uint4*>(img + (size_t)t.pix[q] * kDotC);
#pragma unroll
      for (int i = 0; i < (int)(kDotC * sizeof(T) / 16); ++i) {
        bits ^= row[i].x ^ row[i].y ^ row[i].z ^ row[i].w;
      }
    }
    float dot = __uint_as_float(bits & 0x007fffffu);
"""
SECOND_LOADS = """      float v[4][V];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        load_slice<V>(img + (size_t)t.pix[q] * kDotC, v[q]);
      }
"""
SECOND_END = """        total[j] += t.mask * (t.wt[0] * dq[0] + t.wt[1] * dq[1] +
                              t.wt[2] * dq[2] + t.wt[3] * dq[3]);
      }
"""
SECOND_FOLD = """      unsigned bits = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint4 u =
            *reinterpret_cast<const uint4*>(img + (size_t)t.pix[q] * kDotC);
        bits ^= u.x ^ u.y ^ u.z ^ u.w;
      }
      total[j] += __uint_as_float(bits & 0x007fffffu);
"""
# for each design of K1-dot: its tap loads (replaced by loads of the
# pixel's own row for "arithmetic only"), and the text from its loads to
# the end of its forward's arithmetic (replaced by the fold for "tap
# loads only")
DESIGNS = {
    "first": (FIRST_LOADS, "    float nw[kDotC]", FIRST_DOT, FIRST_FOLD),
    "second": (SECOND_LOADS, SECOND_LOADS, SECOND_END, SECOND_FOLD),
}

# K1-dot's lanes a pixel, as fused_sweep.cu sets them, and the lanes
# each dtype's 16-byte slices allow
LANES = "  static constexpr int L = sizeof(T) == 4 ? 4 : 1;\n"
LANE_CHOICES = {torch.bfloat16: (1, 2), torch.float32: (1, 2, 4)}

# the scatter's window adds and fixed-point conversion, and where a sum
# in a register is declared and kept alive
SCATTER_ADD = ("            add_window<kParts>(window, size, (ch0 + i) * "
               "stride + off[q],\n                               fixed);\n")
SCATTER_CONVERT = ("          const long long fixed = to_fixed(ds, t.wt[q], "
                   "scale);\n")
SCATTER_TESTS = ("          if (t.wt[q] == 0.f) continue;\n",
                 "          if (fixed == 0) continue;\n")
SCATTER_START = "  unsigned long long* acc_v = acc + (size_t)bv * n * c;\n"
SCATTER_TWO = "  const bool two = 73 - l - kSplit <= 30;\n"
SCATTER_END = "    r = end;\n  }\n}\n"

ATOMICS = r"""
#include <cuda_runtime.h>
template <typename U, bool kAtomic>
__global__ void adds(U* out, int iters) {
  __shared__ U s[4096];
  for (int i = threadIdx.x; i < 4096; i += blockDim.x) s[i] = 0;
  __syncthreads();
  const unsigned base = (threadIdx.x & 31) + (threadIdx.x >> 5) * 97;
  const U v = (U)(threadIdx.x + 1);
  for (int it = 0; it < iters; ++it) {
    const unsigned a = (base + it * 37) & 4095;  // distinct in a warp
    if (kAtomic) {
      atomicAdd(&s[a], v);
    } else {
      s[a] += v;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) out[blockIdx.x] = s[blockIdx.x & 4095];
}
__global__ void converts(long long* out, int iters) {
  float f = 1.5f + threadIdx.x;
  long long sum = 0;
  for (int it = 0; it < iters; ++it) {
    sum += __float2ll_rn(f * 1048576.f);
    f += 0.25f;
  }
  if (sum == 42) out[blockIdx.x] = sum;
}
// the same rounding in float64: the exact widening, then the add and
// subtract of 1.5 * 2^52
__global__ void converts_f64(long long* out, int iters) {
  float f = 1.5f + threadIdx.x;
  double sum = 0.0;
  for (int it = 0; it < iters; ++it) {
    const double v = (double)(f * 1048576.f);
    sum += __dsub_rn(__dadd_rn(v, 6755399441055744.0), 6755399441055744.0);
    f += 0.25f;
  }
  if (sum == 42.0) out[blockIdx.x] = (long long)sum;
}
__global__ void adds_f64(long long* out, int iters) {
  __shared__ double s[4096];
  for (int i = threadIdx.x; i < 4096; i += blockDim.x) s[i] = 0;
  __syncthreads();
  const unsigned base = (threadIdx.x & 31) + (threadIdx.x >> 5) * 97;
  const double v = threadIdx.x + 1.0;
  for (int it = 0; it < iters; ++it) {
    atomicAdd(&s[(base + it * 37) & 4095], v);
  }
  __syncthreads();
  if (threadIdx.x == 0) out[blockIdx.x] = (long long)s[blockIdx.x & 4095];
}
extern "C" int run(int which, void* out, int blocks, int iters, void* st) {
  cudaStream_t s = (cudaStream_t)st;
  if (which == 3) {
    converts<<<blocks, 256, 0, s>>>((long long*)out, iters);
  } else if (which == 4) {
    converts_f64<<<blocks, 256, 0, s>>>((long long*)out, iters);
  } else if (which == 5) {
    adds_f64<<<blocks, 256, 0, s>>>((long long*)out, iters);
  } else if (which == 0) {
    adds<unsigned long long, true><<<blocks, 256, 0, s>>>(
        (unsigned long long*)out, iters);
  } else if (which == 1) {
    adds<unsigned, true><<<blocks, 256, 0, s>>>((unsigned*)out, iters);
  } else {
    adds<unsigned long long, false><<<blocks, 256, 0, s>>>(
        (unsigned long long*)out, iters);
  }
  return (int)cudaGetLastError();
}
"""


def compile_so(name: str, source: str, include: Path) -> Path:
    """Builds `source` into a library named by `name` and the source's
    hash (a process loads a path once)."""
    OUT.mkdir(parents=True, exist_ok=True)
    tag = f"{name}_{hashlib.sha256(source.encode()).hexdigest()[:12]}"
    cu, so = OUT / f"{tag}.cu", OUT / f"{tag}.so"
    cu.write_text(source)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(include), "-shared", "-o", str(so), str(cu)],
                   check=True, capture_output=True)
    return so


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def variants(source: str) -> dict:
    """K1-dot's source as it is, with its tap loads alone, and with its
    arithmetic alone."""
    for name, (loads, first, last, fold) in DESIGNS.items():
        if source.count(loads) != 1 or source.count(last) != 1:
            continue
        coalesced = loads
        for tap in ("t.pix[0]", "t.pix[1]", "t.pix[2]", "t.pix[3]",
                    "t.pix[q]"):
            coalesced = coalesced.replace(
                tap, "pix" if name == "first" else "pc")
        start = source.index(first)
        end = source.index(last) + len(last)
        print(f"[sweep_floor] K1-dot: the {name} design")
        return {"kernel": source,
                "tap loads only": source[:start] + fold + source[end:],
                "arithmetic only": source.replace(loads, coalesced)}
    raise SystemExit("no known K1-dot design in the source")


def dot_floors(source_path: Path, batch: int, device, stream):
    libs = {}
    for name, text in variants(source_path.read_text()).items():
        lib = ctypes.CDLL(str(compile_so(name.replace(" ", "_"), text,
                                         source_path.parent)))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.fused_sweep_dot.argtypes = [ci] + [vp] * 6 + [ci] * 6 + [vp]
        libs[name] = lib
    k, h, w, c, d = SWEEP
    for geometry in GEOMETRIES:
        for dtype in (torch.bfloat16, torch.float32):
            src, cur, extr, Ks, invK, planes = dot_case(
                batch, *SWEEP, dtype=dtype, device=device, seed=1,
                geometry=geometry)
            proj = torch.matmul(Ks, extr).contiguous()
            out = torch.empty((batch, d, h * w), dtype=torch.float32,
                              device=device)
            code = _build.DTYPE_CODES[dtype]
            ms = {}
            for name, lib in libs.items():
                def call(lib=lib):
                    assert lib.fused_sweep_dot(
                        code, src.data_ptr(), cur.data_ptr(),
                        proj.data_ptr(), invK.data_ptr(), planes.data_ptr(),
                        out.data_ptr(), batch, k, h, w, c, d, stream) == 0
                ms[name] = cuda_ms(call)
            print(f"[sweep_floor] K1-dot {geometry} {str(dtype)[6:]} "
                  f"(b={batch}): " + ", ".join(
                      f"{name} {t:.4f} ms" for name, t in ms.items()),
                  flush=True)


def device_ops(device, stream):
    so = compile_so("device_ops", ATOMICS, OUT)
    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)],
                          capture_output=True, text=True).stdout
    kernel = "?"
    seen = {}
    for line in sass.splitlines():
        if "Function" in line:
            kernel = line.split(":")[-1].strip()
        elif "ATOMS" in line or "F2I" in line or "F2F" in line:
            seen.setdefault(kernel, line.split(";")[0].split("*/")[-1]
                            .strip())
    for kernel, instr in seen.items():
        print(f"[sweep_floor] SASS of {kernel}: {instr}")
    lib = ctypes.CDLL(str(so))
    lib.run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                        ctypes.c_int, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks, iters = sms * 8, 4096
    out = torch.zeros(blocks, dtype=torch.int64, device=device)
    warp_ops = blocks * 8 * iters / sms   # per SM
    for which, name in ((0, "shared 64-bit atomicAdd"),
                        (1, "shared 32-bit atomicAdd"),
                        (2, "shared 64-bit read-modify-write"),
                        (3, "float32 to int64 __float2ll_rn"),
                        (4, "float32 to a rounded float64"),
                        (5, "shared float64 atomicAdd")):
        ms = cuda_ms(lambda: lib.run(which, out.data_ptr(), blocks, iters,
                                     stream))
        print(f"[sweep_floor] {name}: {ms:.4f} ms, "
              f"{ms * 1e-3 * BOOST_HZ / warp_ops:.2f} clocks a warp "
              "instruction on an SM", flush=True)


def dot_lanes(batch: int, device, stream):
    """K1-dot and its d_cur mode with each number of lanes a pixel."""
    path = _build.CSRC_DIR / "fused_sweep.cu"
    source = path.read_text()
    assert source.count(LANES) == 1
    vp, ci = ctypes.c_void_p, ctypes.c_int
    k, h, w, c, d = SWEEP
    for dtype, choices in LANE_CHOICES.items():
        libs = {}
        for lanes in choices:
            forced = LANES.replace("sizeof(T) == 4 ? 4 : 1", str(lanes))
            lib = ctypes.CDLL(str(compile_so(
                f"lanes{lanes}", source.replace(LANES, forced), path.parent)))
            for entry in (lib.fused_sweep_dot, lib.fused_sweep_dot_cur_grad):
                entry.argtypes = [ci] + [vp] * 6 + [ci] * 6 + [vp]
            libs[lanes] = lib
        for geometry in GEOMETRIES:
            src, cur, extr, Ks, invK, planes = dot_case(
                batch, *SWEEP, dtype=dtype, device=device, seed=1,
                geometry=geometry)
            g = sweep_cotangent(batch, d, h * w, device, seed=2)
            proj = torch.matmul(Ks, extr).contiguous()
            out = torch.empty((batch, d, h * w), device=device)
            d_cur = torch.empty((batch, h * w, c), device=device)
            code = _build.DTYPE_CODES[dtype]
            line = []
            for lanes, lib in libs.items():
                def fwd(lib=lib):
                    assert lib.fused_sweep_dot(
                        code, src.data_ptr(), cur.data_ptr(),
                        proj.data_ptr(), invK.data_ptr(), planes.data_ptr(),
                        out.data_ptr(), batch, k, h, w, c, d, stream) == 0

                def bwd(lib=lib):
                    assert lib.fused_sweep_dot_cur_grad(
                        code, src.data_ptr(), g.data_ptr(), proj.data_ptr(),
                        invK.data_ptr(), planes.data_ptr(), d_cur.data_ptr(),
                        batch, k, h, w, c, d, stream) == 0
                line.append(f"{lanes} lanes: K1-dot {cuda_ms(fwd):.4f} ms, "
                            f"d_cur mode {cuda_ms(bwd):.4f} ms")
            print(f"[sweep_floor] lanes a pixel, {geometry} "
                  f"{str(dtype)[6:]} (b={batch}): " + "; ".join(line),
                  flush=True)


def scatter_floors(batch: int, device, stream):
    """The scatter as it is, without its window adds, without its
    conversion, and without both."""
    path = _build.CSRC_DIR / "sweep_scatter.cu"
    source = path.read_text()
    for anchor in (SCATTER_ADD, SCATTER_CONVERT, SCATTER_START, SCATTER_END,
                   SCATTER_TWO) + SCATTER_TESTS:
        assert source.count(anchor) == 1, anchor
    kept = (source.replace(SCATTER_START, SCATTER_START
                           + "  long long sink = 0;\n")
            .replace(SCATTER_END, "    r = end;\n  }\n"
                     "  if (sink == 0x5eed) paths[0] = 0;\n}\n"))
    no_adds = kept.replace(SCATTER_ADD, "            sink += fixed;\n")
    bits = ("          const long long fixed = __float_as_int("
            "__fmul_rn(ds, t.wt[q]));\n")
    untested = source
    for test in SCATTER_TESTS:
        untested = untested.replace(test, "")
    variants_ = {"kernel": source, "no window adds": no_adds,
                 "no conversion": kept.replace(SCATTER_CONVERT, bits),
                 "neither": no_adds.replace(SCATTER_CONVERT, bits),
                 "adds of zeros too": untested,
                 "three parts": source.replace(SCATTER_TWO,
                                               "  const bool two = false;\n")}
    vp, ci = ctypes.c_void_p, ctypes.c_int
    libs = {}
    for name, text in variants_.items():
        lib = ctypes.CDLL(str(compile_so(
            "scatter_" + name.replace(" ", "_"), text, path.parent)))
        lib.sweep_scatter.argtypes = [ci, ci] + [vp] * 10 + [ci] * 6 + [vp]
        libs[name] = lib
    k, h, w, c, d = SWEEP
    for geometry in GEOMETRIES:
        args, grads = scatter_case(batch, *SWEEP, dtype=torch.bfloat16,
                                   device=device, seed=1, geometry=geometry)
        proj, invK, planes, bound = args[:4]
        d_s = grads["d_s_bkdNc"]
        acc = torch.zeros((batch, k, h, w, c), dtype=torch.int64,
                          device=device)
        d_src = torch.empty((batch, k, h, w, c), device=device)
        paths = torch.zeros(2, dtype=torch.int64, device=device)
        ms = {}
        for name, lib in libs.items():
            def call(lib=lib):
                assert lib.sweep_scatter(
                    1, 0, d_s.data_ptr(), 0, 0, proj.data_ptr(),
                    invK.data_ptr(), planes.data_ptr(), bound.data_ptr(),
                    acc.data_ptr(), d_src.data_ptr(), paths.data_ptr(),
                    batch, k, h, w, c, d, stream) == 0
            ms[name] = cuda_ms(call)
        print(f"[sweep_floor] scatter {geometry} bfloat16 (b={batch}): "
              + ", ".join(f"{name} {t:.4f} ms" for name, t in ms.items()),
              flush=True)
        del args, grads, d_s, acc, d_src


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--source", type=Path,
                        default=_build.CSRC_DIR / "fused_sweep.cu")
    parser.add_argument("--parts", default="ops,dot,lanes,scatter")
    opts = parser.parse_args()
    device = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(device).cuda_stream
    print(torch.cuda.get_device_name(0))
    parts = opts.parts.split(",")
    if "ops" in parts:
        device_ops(device, stream)
    if "dot" in parts:
        dot_floors(opts.source.resolve(), opts.batch, device, stream)
    if "lanes" in parts:
        dot_lanes(opts.batch, device, stream)
    if "scatter" in parts:
        scatter_floors(opts.batch, device, stream)


if __name__ == "__main__":
    main()
