"""Builds the port's CUDA kernels and loads them through ctypes.

Every `csrc/*.cu` file is compiled by its own `nvcc` process, all
started together, and the objects are linked into one shared library
with a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c -o <obj> csrc/<source>.cu   (each)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o <name>.so <objs>

The library lands in `build/kernels/` at the root of the checkout, named
by a hash of the sources and flags, so an edited source rebuilds at first
use and an unchanged one loads at once. `ptxas`'s report of registers,
shared memory and spills is kept beside it as `<name>.ptxas.txt`.
Nothing is built when the module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from simplerecon_tpu_torch import tracing

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")


def sources() -> list:
    return sorted(list(CSRC_DIR.glob("*.cu")) + list(CSRC_DIR.glob("*.cuh")))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"srtt_kernels_{h.hexdigest()[:16]}.so"


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (Path(cuda_home) / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise FileNotFoundError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the port's CUDA kernels are built from source at first use")


def build() -> tuple:
    """Compiles the kernels if their library is missing.

    Returns (library path, seconds spent compiling; 0.0 if it existed).
    """
    lib = library_path()
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{lib.stem}.{os.getpid()}"
    cus = [src for src in sources() if src.suffix == ".cu"]
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in cus]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(cus, objs)]
    report = [proc.communicate()[0] for proc in procs]
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
    failed = [(proc.args, out) for proc, out in zip(procs, report)
              if proc.returncode != 0]
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            failed = [(link, proc.stdout + proc.stderr)]
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        cmd, out = failed[0]
        raise RuntimeError(f"nvcc failed:\n{' '.join(cmd)}\n{out}")
    seconds = time.perf_counter() - t0
    lib.with_suffix(".ptxas.txt").write_text("".join(report))
    os.replace(tmp, lib)  # atomic: no reader sees a half-written file
    return lib, seconds


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Builds (if needed) and loads the kernels, declaring each C entry
    point's argument types: c_void_p for every pointer and the stream."""
    with tracing.span("sr.kernel_build"):
        path = build()[0]
    lib = ctypes.CDLL(str(path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.fused_sweep_mlp.argtypes = [ci] + [vp] * 14 + [ci] * 6 + [vp]
    lib.fused_sweep_mlp.restype = ci
    lib.fused_sweep_mlp_bwd.argtypes = [ci] + [vp] * 20 + [ci] * 7 + [vp]
    lib.fused_sweep_mlp_bwd.restype = ci
    lib.sweep_scatter.argtypes = [ci, ci] + [vp] * 10 + [ci] * 6 + [vp]
    lib.sweep_scatter.restype = ci
    lib.fused_sweep_dot.argtypes = [ci] + [vp] * 6 + [ci] * 6 + [vp]
    lib.fused_sweep_dot.restype = ci
    lib.fused_sweep_dot_cur_grad.argtypes = [ci] + [vp] * 6 + [ci] * 6 + [vp]
    lib.fused_sweep_dot_cur_grad.restype = ci
    lib.fused_feature_volume.argtypes = [ci] + [vp] * 15 + [ci] * 5 + [vp]
    lib.fused_feature_volume.restype = ci
    lib.fused_warp_feature_volume.argtypes = ([ci] + [vp] * 14 + [ci] * 6
                                              + [vp])
    lib.fused_warp_feature_volume.restype = ci
    ll = ctypes.c_longlong
    lib.max_blur_pool_fwd.argtypes = [ci, vp, vp, ll, ci, ci, ci, ci, vp]
    lib.max_blur_pool_fwd.restype = ci
    lib.max_blur_pool_bwd.argtypes = [ci, vp, vp, vp, ll, ci, ci, ci, ci,
                                      vp]
    lib.max_blur_pool_bwd.restype = ci
    lib.fused_sweep_error_string.argtypes = [ci]
    lib.fused_sweep_error_string.restype = ctypes.c_char_p
    return lib


# kernel dtype codes of the C entry points
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def kernel_device(t: torch.Tensor, name: str):
    """None for a CPU tensor (the plain version runs), the device for a
    CUDA tensor; raises for any other device."""
    if t.device.type == "cpu":
        return None
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA, not {t.device}")
    return t.device


def check(name, t, dtype, shape, device):
    """Raises unless `t` is a contiguous `dtype` tensor of `shape` on
    `device`."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def raise_on_error(lib, name: str, rc: int):
    """Raises when a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.fused_sweep_error_string(rc).decode())
