"""Native C++ host kernels, built with g++ at first use and bound with
ctypes: `rasterizer.cpp` (the synthetic scene's renderer) and
`marching_cubes.cpp` (mesh extraction from a TSDF). Copies of the JAX
package's sources, built with the same flags.

Each library is built into `build/native/` at the root of the checkout
(which git ignores), never beside its source, under a name keyed on its
source, the compiler flags and the host CPU (`-march=native`), so a
build directory copied to another machine is never reused there. A
failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

SOURCE_DIR = Path(__file__).resolve().parent
BUILD_DIR = SOURCE_DIR.parents[1] / "build" / "native"
_LOCK = threading.Lock()
_LIBS = {}


FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]


def _host_cpu() -> str:
    """The host CPU's model and feature flags, as the kernel lists them."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [line for line in f
                     if line.startswith(("model name", "flags"))]
        return "".join(sorted(set(lines)))
    except OSError:
        return platform.processor() or platform.machine()


def _build(name: str, src: Path, out: Path):
    out.parent.mkdir(parents=True, exist_ok=True)
    # a process-private name, then a rename, so that two processes that
    # build at once never load a half-written library
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, str(src), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except (OSError, subprocess.CalledProcessError) as e:
        detail = getattr(e, "stderr", None) or str(e)
        raise RuntimeError(
            f"failed to build native library {name}:\n{detail}") from e
    os.replace(tmp, out)


def load_library(name: str) -> ctypes.CDLL:
    """The shared library of `<name>.cpp`, built first if this source,
    these flags and this CPU have none yet."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        src = SOURCE_DIR / f"{name}.cpp"
        key = hashlib.sha256(src.read_bytes() + " ".join(FLAGS).encode()
                             + _host_cpu().encode()).hexdigest()[:16]
        out = BUILD_DIR / f"lib{name}-{key}.so"
        if not out.exists():
            _build(name, src, out)
        lib = ctypes.CDLL(str(out))
        _LIBS[name] = lib
        return lib
