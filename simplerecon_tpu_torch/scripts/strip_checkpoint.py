"""Strips a training checkpoint to its weights for distribution
(counterpart of `simplerecon_tpu/scripts/strip_checkpoint.py`): the
model's state_dict, the step and the options, without the optimizer
state, under `<dst>/step_<N>/`.

    python -m simplerecon_tpu_torch.scripts.strip_checkpoint \
        --src <log_dir>/<name>/checkpoints --dst <stripped dir> [--step N]

`--src` is a checkpoint directory (its newest step unless `--step` is
given) or a step directory. The result loads wherever weights do
(`--load_weights_from_checkpoint`). Needs no card.
"""

from __future__ import annotations

import argparse

from simplerecon_tpu_torch.utils import checkpoint as ckpt_lib


def main(argv=None) -> str:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True,
                    help="checkpoint directory (step_N subdirectories) or "
                         "a step directory")
    ap.add_argument("--dst", required=True)
    ap.add_argument("--step", type=int, default=None)
    args = ap.parse_args(argv)
    out = ckpt_lib.strip_checkpoint(args.src, args.dst, step=args.step)
    print(f"stripped checkpoint -> {out}")
    return out


if __name__ == "__main__":
    main()
