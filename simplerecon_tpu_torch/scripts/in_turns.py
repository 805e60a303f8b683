"""Runs phases of `chip_smoke.py`, or times the bf16 sweep kernels, in
several checkouts in turns on one card, so that two versions of the
kernels are compared on the same card in one call (parent, change,
change, parent).

    python -m simplerecon_tpu_torch.scripts.in_turns [--phases P,...]
        [--batches B,...] TREE [TREE ...]

Each TREE is the root of a checkout; each runs in its own process (its
own `simplerecon_tpu_torch`, its own kernel build), in the order given.
`--phases` names `chip_smoke.py` functions that take the device, such as
phase_kernel, phase_backward and phase_early_kernels (default: those
three); the phases print their own lines. Two phases are this script's,
for each batch size of `--batches` (default 1,8,16) at the hero sweep
shape, in bf16: "sweep_times" times K1 and K2, and in a tree that has it
the scatter of K2's d_src alone, in both its modes, on seeded gradients;
"early_times" times K5 (one chunk of planes) and K4; "pool_times" times
K3-fwd and K3-bwd at the stem pool's shape for each batch size (8
views a sample) and at a small odd shape, in float32 and bf16, through
`ops/pool.py`'s public wrappers only, so a tree from before the phase
runs it too; "scatter_times" times the scatter in both of its modes and
both dtypes at a small odd shape and each batch size, with the cameras
of both `testing.GEOMETRIES`, checks two calls give the same bits and,
in a tree that counts them, prints the planes of each of its paths;
"dot_times" times K1-dot, the dot backward and, in a tree that has it,
K1-dot's d_cur mode, at the same shapes and geometries. The inputs of
the last two come from the `testing.py` of the checkout that runs this
script, so every tree gets the same ones. All give the median CUDA-event
ms of 5 to 20 calls after 3 warm-up calls, and a digest of each output
(its bytes' SHA-256), so that two trees' outputs can be compared bit for
bit; "early_times" also digests the float32 K1, K5 and K4 at b=1. Every
line a tree prints is prefixed with its name. Needs a CUDA card.
"""

import argparse
import os
import subprocess
import sys

from simplerecon_tpu_torch import testing

CASES = os.path.abspath(testing.__file__)

TREE_CODE = r"""
import hashlib, importlib.util, statistics, sys, torch
import chip_smoke
from simplerecon_tpu_torch.ops import cuda_cv, early_sweeps, pool
from simplerecon_tpu_torch.testing import (pool_case, pool_cotangent,
                                           stack_case, sweep_case,
                                           sweep_cotangent, warp_case)
try:
    from simplerecon_tpu_torch.testing import scatter_case
except ImportError:  # a tree from before the scatter
    pass
# the inputs of "scatter_times" and "dot_times" come from the testing
# module of the checkout that runs this script, so every tree gets the
# same inputs, in both geometries, whatever its own testing module has
spec = importlib.util.spec_from_file_location("case_maker", sys.argv[3])
case_maker = importlib.util.module_from_spec(spec)
spec.loader.exec_module(case_maker)

def digest(t):
    data = t.detach().cpu().contiguous().flatten().view(torch.uint8)
    return hashlib.sha256(data.numpy().tobytes()).hexdigest()[:16]

def sweep_times(device, batches):
    for b in batches:
        shape = (b,) + chip_smoke.HERO_SWEEP
        args = sweep_case(*shape, dtype=torch.bfloat16, device=device,
                          seed=1)
        g = sweep_cotangent(b, shape[-1], shape[2] * shape[3], device,
                            seed=2)
        with torch.no_grad():
            out = digest(cuda_cv.fused_sweep(*args))
            k1 = chip_smoke.cuda_ms(lambda: cuda_cv.fused_sweep(*args), 10)
        k2 = chip_smoke.cuda_ms(lambda: cuda_cv.fused_sweep_bwd(*args, g), 10)
        print(f"[sweep_times] bf16 {shape}: K1 {k1:.3f} ms, K2 {k2:.3f} ms; "
              f"K1 output {out}", flush=True)
        if not hasattr(cuda_cv, "sweep_scatter"):
            continue
        del args
        for dot in (False, True):
            sargs, grads = scatter_case(*shape, dtype=torch.bfloat16,
                                        device=device, seed=1, dot=dot)
            out = digest(cuda_cv.sweep_scatter(*sargs, **grads))
            ms = chip_smoke.cuda_ms(
                lambda: cuda_cv.sweep_scatter(*sargs, **grads), 10)
            mode = " (dot)" if dot else ""
            print(f"[sweep_times] bf16 {shape}: scatter{mode} {ms:.3f} ms; "
                  f"output {out}", flush=True)
            del sargs, grads

EARLY = {"K5": (stack_case, early_sweeps.fused_feature_volume),
         "K4": (warp_case, early_sweeps.fused_warp_feature_volume)}

def early_times(device, batches):
    k, h, w, c, d = chip_smoke.HERO_SWEEP
    for b in batches:
        for name, (make_case, fn) in EARLY.items():
            planes = (early_sweeps.stack_plane_chunk(b, k, h * w, c, d)
                      if name == "K5" else d)
            shape = (b, k, h, w, c, planes)
            args = make_case(*shape, dtype=torch.bfloat16, device=device,
                             seed=1)
            with torch.no_grad():
                out = digest(fn(*args))
                ms = chip_smoke.cuda_ms(lambda: fn(*args), 10)
            print(f"[early_times] {name} bf16 {shape}: {ms:.3f} ms; output "
                  f"{out}", flush=True)
            del args
    shape = (1,) + chip_smoke.HERO_SWEEP
    for name, make_case, fn in (("K1", sweep_case, cuda_cv.fused_sweep),
                                ("K5",) + EARLY["K5"], ("K4",) + EARLY["K4"]):
        args = make_case(*shape, dtype=torch.float32, device=device, seed=1)
        with torch.no_grad():
            print(f"[early_times] {name} float32 {shape}: output "
                  f"{digest(fn(*args))}", flush=True)

def pool_times(device, batches):
    shapes = [(2, 3, 13, 22)] + [(8 * b,) + chip_smoke.STEM for b in batches]
    for shape in shapes:
        b, c, h, w = shape
        for dtype in (torch.float32, torch.bfloat16):
            x = pool_case(shape, dtype, device, seed=3)
            g = pool_cotangent((b, c) + pool.output_size(h, w), dtype,
                               device, seed=4, positive=True)
            out = digest(pool.max_blur_pool(x))
            dx = digest(pool.max_blur_pool_bwd(x, g))
            fwd = chip_smoke.cuda_ms(lambda: pool.max_blur_pool(x), 10)
            bwd = chip_smoke.cuda_ms(lambda: pool.max_blur_pool_bwd(x, g), 10)
            name = str(dtype).split(".")[-1]
            print(f"[pool_times] {name} {shape}: K3-fwd {fwd:.4f} ms, "
                  f"K3-bwd {bwd:.4f} ms; output {out}, dx {dx}", flush=True)
            del x, g

ODD = (2, 3, 13, 21, 16, 5)        # the dot model needs c = 16
ODD_SCATTER = (2, 3, 13, 21, 8, 5)

def scatter_times(device, batches):
    for geometry in ("wide", "close"):
        shapes = [ODD_SCATTER] + [(b,) + chip_smoke.HERO_SWEEP
                                  for b in batches]
        for shape in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                for dot in (False, True):
                    args, grads = case_maker.scatter_case(
                        *shape, dtype=dtype, device=device, seed=1, dot=dot,
                        geometry=geometry)
                    out = cuda_cv.sweep_scatter(*args, **grads)
                    again = cuda_cv.sweep_scatter(*args, **grads)
                    same = torch.equal(out, again)
                    paths = getattr(cuda_cv.sweep_scatter, "paths", None)
                    paths = ("" if paths is None else
                             "; window/global planes "
                             + "/".join(map(str, paths.tolist())))
                    ms = chip_smoke.cuda_ms(
                        lambda: cuda_cv.sweep_scatter(*args, **grads), 10)
                    name = str(dtype).split(".")[-1]
                    mode = "dot" if dot else "samples"
                    print(f"[scatter_times] {geometry} {mode} {name} "
                          f"{shape}: {ms:.3f} ms; d_src {digest(out)}, "
                          f"two calls {'equal' if same else 'DIFFER'}"
                          f"{paths}", flush=True)
                    del args, grads, out, again

def dot_times(device, batches):
    dcur = getattr(cuda_cv, "dot_sweep_dcur", None)
    for geometry in ("wide", "close"):
        shapes = [ODD] + [(b,) + chip_smoke.HERO_SWEEP for b in batches]
        for shape in shapes:
            b, k, h, w, c, d = shape
            for dtype in (torch.float32, torch.bfloat16):
                args = case_maker.dot_case(*shape, dtype=dtype, device=device,
                                           seed=1, geometry=geometry)
                g = case_maker.sweep_cotangent(b, d, h * w, device, seed=2)
                out = digest(cuda_cv.dot_sweep(*args))
                ms = chip_smoke.cuda_ms(lambda: cuda_cv.dot_sweep(*args), 20)
                bwd = chip_smoke.cuda_ms(
                    lambda: cuda_cv.dot_sweep_backward(*args, g), 5)
                d_src, d_cur = cuda_cv.dot_sweep_backward(*args, g)
                line = (f"[dot_times] {geometry} {str(dtype).split('.')[-1]} "
                        f"{shape}: K1-dot {ms:.3f} ms, output {out}; dot "
                        f"backward {bwd:.3f} ms, d_src {digest(d_src)}, "
                        f"d_cur {digest(d_cur)}")
                if dcur is not None:
                    dargs = [args[0]] + list(args[2:]) + [g]
                    dms = chip_smoke.cuda_ms(lambda: dcur(*dargs), 20)
                    line += f"; d_cur mode {dms:.3f} ms"
                print(line, flush=True)
                del args, g, d_src, d_cur

device = torch.device("cuda", 0)
chip_smoke.phase_card()
chip_smoke.phase_build()
batches = [int(x) for x in sys.argv[2].split(",")]
for name in sys.argv[1].split(","):
    if name in ("sweep_times", "early_times", "pool_times", "scatter_times",
                "dot_times"):
        globals()[name](device, batches)
    else:
        getattr(chip_smoke, name)(device)
"""


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("trees", nargs="+")
    parser.add_argument("--phases", default="phase_kernel,phase_backward,"
                        "phase_early_kernels")
    parser.add_argument("--batches", default="1,8,16")
    opts = parser.parse_args()
    failed = []
    for i, tree in enumerate(opts.trees):
        root = os.path.abspath(tree)
        tag = f"[turn {i + 1}: {tree}]"
        env = dict(os.environ, PYTHONPATH=root)
        proc = subprocess.Popen(
            [sys.executable, "-c", TREE_CODE, opts.phases, opts.batches,
             CASES],
            cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        for line in proc.stdout:
            print(f"{tag} {line.rstrip()}", flush=True)
        if proc.wait() != 0:
            failed.append(tree)
    if failed:
        raise SystemExit(f"failed in {failed}")


if __name__ == "__main__":
    main()
