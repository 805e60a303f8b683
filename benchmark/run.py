"""Runs one cell of the benchmark once and prints its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>
    python3 -m benchmark.run ...                    (the same)

from the root of a checkout. With `--trace 0` the line carries the
cell's end-to-end metrics, with `--trace 1` its per-layer metrics, read
from a profiled stretch after the window. The numbers that decide
`correct` are printed beside their limits as the last lines of standard
error and, under "checks", last in the result line, which is the last
line of standard output. A run without a CUDA card, or with fewer cards
than the cell asks for, or whose process holds JAX or the JAX package
once the window has closed, exits with a code other than 0 and prints no
result.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark import harness

    bench = harness.load_benchmark()
    cell = harness.cell_entry(bench, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: cell {cell['name']} needs {cell['chips']} CUDA "
              f"card(s); found {found}", file=sys.stderr)
        return 2
    # one host thread: the program's host side is one dispatching thread,
    # and idle OpenMP workers spinning beside it on a shared host make
    # the window's times swing
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    line, table = harness.run_cell(args.workload, args.seed, args.seconds,
                                   bool(args.trace), device)
    found = harness.forbidden_modules()
    if found:
        print("benchmark: the process holds " + ", ".join(found)
              + "; no result", file=sys.stderr)
        return 3
    if args.trace:
        print(f"card: {power_limit()}", file=sys.stderr)
    for name, row in table.items():
        print(f"check {name}: {row['value']} (limit {row['limit']})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
