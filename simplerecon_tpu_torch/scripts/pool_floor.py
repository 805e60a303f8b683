"""Times the stem pool's kernels (K3-fwd, K3-bwd) against their floor:
the same source with each kernel's arithmetic replaced by writing zeros,
so that what is left is the tile's staging into shared memory and its
stores. The gap between the two is the arithmetic's share of the time.

    python -m simplerecon_tpu_torch.scripts.pool_floor [--batch 16]

Builds both versions of `csrc/max_blur_pool.cu` with the port's nvcc
flags into `build/pool_floor/`, loads them with ctypes, and prints for
float32 and bf16 the median CUDA-event ms of 20 calls (after 3 warm-up
calls) of each kernel and of its floor, at the stem pool's shape for
`--batch` samples of 8 views, beside the bytes bound (each input read
once, each output written once, at 3.35 TB/s). Needs a CUDA card.
"""

import argparse
import ctypes
import statistics
import subprocess

import torch

from simplerecon_tpu_torch.ops import _build, pool
from simplerecon_tpu_torch.testing import pool_case, pool_cotangent

STEM = (64, 192, 256)  # c, h, w at the stem pool, per view
PEAK_BYTES = 3.35e12   # H100 SXM HBM3
# (anchor, code put after it): the floor of each kernel writes zeros to
# the outputs of its tile right after the tile is staged, and returns
FLOORS = (
    ("  const bool g_inside = inside && j0 >= 2 && j0 + 8 <= nw - 4;\n",
     """  float zeros[8] = {};
  for (int i = ya; i < yb; ++i) {
    write_row(dx + (size_t)b.plane * H * W + (size_t)i * W + b.x0 + 8 * cc,
              zeros, n, vec_x != 0);
  }
  if (W > 0) return;
"""),
    ("  const int cb = f.mc0 & ~(V - 1);\n",
     """  const int chunks_out = (f.nco + 7) / 8;
  float zeros[8] = {};
  for (int u = threadIdx.x; u < chunks_out * f.nro; u += kThreads) {
    const int c8 = 8 * (u % chunks_out);
    write_row(out + (size_t)f.plane * Ho * Wo +
                  (size_t)(f.oi0 + u / chunks_out) * Wo + f.oc0 + c8,
              zeros, min(8, f.nco - c8), vec_out != 0);
  }
  if (W > 0) return;
"""),
)


def build(name: str, source: str) -> ctypes.CDLL:
    out = _build.BUILD_DIR.parent / "pool_floor"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{name}.cu").write_text(source)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    str(out / f"{name}.so"), str(out / f"{name}.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out / f"{name}.so"))
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.max_blur_pool_fwd.argtypes = [ci, vp, vp, ll, ci, ci, ci, ci, vp]
    lib.max_blur_pool_bwd.argtypes = [ci, vp, vp, vp, ll, ci, ci, ci, ci, vp]
    return lib


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


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batch", type=int, default=16)
    opts = parser.parse_args()
    source = (_build.CSRC_DIR / "max_blur_pool.cu").read_text()
    floor = source
    for anchor, code in FLOORS:
        assert floor.count(anchor) == 1, anchor
        floor = floor.replace(anchor, anchor + code)
    libs = {"kernel": build("kernel", source), "floor": build("floor", floor)}
    device = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(device).cuda_stream
    shape = (8 * opts.batch,) + STEM
    b, c, h, w = shape
    planes = b * c
    print(torch.cuda.get_device_name(0))
    for dtype in (torch.float32, torch.bfloat16):
        x = pool_case(shape, dtype, device, seed=3)
        g = pool_cotangent((b, c) + pool.output_size(h, w), dtype, device,
                           seed=4, positive=True)
        out, dx = torch.empty_like(g), torch.empty_like(x)
        code = _build.DTYPE_CODES[dtype]
        esize = x.element_size()
        bounds = {"fwd": (x.numel() + g.numel()) * esize / PEAK_BYTES * 1e3,
                  "bwd": (2 * x.numel() + g.numel()) * esize / PEAK_BYTES
                  * 1e3}
        for part in ("fwd", "bwd"):
            ms = {}
            for name, lib in libs.items():
                if part == "fwd":
                    def call(lib=lib):
                        assert lib.max_blur_pool_fwd(
                            code, x.data_ptr(), out.data_ptr(), planes, h, w,
                            1, 1, stream) == 0
                else:
                    def call(lib=lib):
                        assert lib.max_blur_pool_bwd(
                            code, x.data_ptr(), g.data_ptr(), dx.data_ptr(),
                            planes, h, w, 1, 1, stream) == 0
                ms[name] = cuda_ms(call)
            print(f"[pool_floor] K3-{part} {str(dtype)[6:]} {shape}: kernel "
                  f"{ms['kernel']:.4f} ms, floor (staging and stores) "
                  f"{ms['floor']:.4f} ms, bytes bound {bounds[part]:.4f} ms",
                  flush=True)
        del x, g, out, dx


if __name__ == "__main__":
    main()
