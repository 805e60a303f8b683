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
three); the phases print their own lines. The phase "sweep_times" is this
script's: K1 and K2 in bf16 at the hero sweep shape for each batch size
of `--batches` (default 1,8,16), median CUDA-event ms of 10 calls after
3 warm-up calls. Every line a tree prints is prefixed with its name.
Needs a CUDA card.
"""

import argparse
import os
import subprocess
import sys

TREE_CODE = r"""
import statistics, sys, torch
import chip_smoke
from simplerecon_tpu_torch.ops import cuda_cv
from simplerecon_tpu_torch.testing import sweep_case, sweep_cotangent

def sweep_times(device, batches):
    for b in batches:
        shape = (b,) + chip_smoke.HERO_SWEEP
        args = sweep_case(*shape, dtype=torch.bfloat16, device=device,
                          seed=1)
        g = sweep_cotangent(b, shape[-1], shape[2] * shape[3], device,
                            seed=2)
        with torch.no_grad():
            k1 = chip_smoke.cuda_ms(lambda: cuda_cv.fused_sweep(*args), 10)
        k2 = chip_smoke.cuda_ms(lambda: cuda_cv.fused_sweep_bwd(*args, g), 10)
        print(f"[sweep_times] bf16 {shape}: K1 {k1:.3f} ms, K2 {k2:.3f} ms",
              flush=True)

device = torch.device("cuda", 0)
chip_smoke.phase_card()
chip_smoke.phase_build()
batches = [int(x) for x in sys.argv[2].split(",")]
for name in sys.argv[1].split(","):
    if name == "sweep_times":
        sweep_times(device, batches)
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
            [sys.executable, "-c", TREE_CODE, opts.phases, opts.batches],
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
