"""The readings that a cell's limits are set from, on the card at the
cell's own sizes, without a measured window: the `readings` of the loop
of the cell's mix (`benchmark/loops/<kind>.py`):

- the program against the reference, on each of `--seeds` (the lower
  readings: what sound runs give);
- on each of `--control-seeds`, the control against the reference: the
  reference itself computed at fp8 (e4m3 operands, e5m2 gradients) where
  the program computes in bf16, the step below the configuration's
  precision (the upper readings); for training, also the program with
  its loss taken over half of each batch (a fault planted), and the
  program in float32, a witness of what bf16 alone moves. A step that
  returns its state unchanged reads 1 on the norms by construction and is
  not run.

    python3 benchmark/control.py --workload hero_train_b16 \
        --seeds 1,2,3 --control-seeds 1,2,3 [--out file.jsonl]

One JSON line a seed and reading goes to standard output (and to
`--out`).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch
    from benchmark import harness
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    bench = harness.load_benchmark()
    cell = harness.cell_entry(bench, args.workload)
    config = harness.load_json(harness.config_path(bench, cell))
    mix = harness.load_json(harness.traffic_path(cell))
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    loop = harness.load_loop(mix["kind"])
    device = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None
    try:
        for seed in sorted(set(seeds) | control):
            t0 = time.perf_counter()
            for row in loop.readings(config, mix, seed, device,
                                     seed in control):
                row["seconds"] = time.perf_counter() - t0
                line = json.dumps({"workload": args.workload, **row})
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
