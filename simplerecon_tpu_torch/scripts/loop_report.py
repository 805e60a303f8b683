"""Summaries of grand-loop runs from their logs: each run's training
losses against a JAX loop's log, and each `--trace_from` trace's
gradient norms, running variances, breaks and bf16-against-float32
probes (`scripts/grand_loop.py`).

    python -m simplerecon_tpu_torch.scripts.loop_report \
        --jax_log experiments/grand_loop_r5/run.log \
        --metrics RUN/logs/grand_loop/metrics.jsonl ... \
        --traces RUN/trace.jsonl ...

Prints one JSON object a line. Reads files only; runs anywhere.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import statistics


def train_losses(path: str) -> dict:
    """{step: training loss} of a run's `metrics.jsonl`."""
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return {r["step"]: r["train/loss"] for r in rows if "train/loss" in r}


def jax_losses(path: str) -> dict:
    """{step: training loss} of the JAX training CLI's log."""
    out = {}
    with open(path) as f:
        for line in f:
            m = re.match(r"step (\d+): loss=([\d.]+)", line)
            if m:
                out[int(m.group(1))] = float(m.group(2))
    return out


def against_jax(runs: dict, jax: dict) -> dict:
    """At the JAX log's steps: how often its loss lies within the runs'
    range, the steps where it lies above or below, and each run's and
    JAX's mean loss over the second half of those steps."""
    steps = sorted(s for s in jax if all(s in r for r in runs.values()))
    above, below = [], []
    for s in steps:
        vals = [r[s] for r in runs.values()]
        if jax[s] > max(vals):
            above.append(s)
        elif jax[s] < min(vals):
            below.append(s)
    half = steps[len(steps) // 2:]
    means = {name: statistics.mean(r[s] for s in half)
             for name, r in {**runs, "jax": jax}.items()}
    return {"steps": len(steps), "inside": len(steps) - len(above)
            - len(below), "above": above, "below": below,
            "second_half_mean": means}


def trace_summary(path: str) -> dict:
    """A trace's steps, largest finite gradient norm, range of the largest
    running variance, broken steps, and with bf16-against-float32 probes
    each module's largest output difference, the largest loss difference
    and each top-level module's median gradient difference."""
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    norms = [r["grad_norm"] for r in rows]
    var = [r["bn_max_var"] for r in rows if "bn_max_var" in r]
    out = {"steps": [rows[0]["step"], rows[-1]["step"]],
           "max_grad_norm": max(n for n in norms if math.isfinite(n)),
           "non_finite": sum(not math.isfinite(n) for n in norms),
           "max_loss": max(r["loss"] for r in rows),
           "bn_max_var": [min(var), max(var)],
           "breaks": [r["step"] for r in rows if "break" in r]}
    probes = [r["shadow"] for r in rows if "shadow" in r]
    if probes:
        out["probes"] = len(probes)
        out["max_out_rel"] = {m: max(p["out_rel"][m] for p in probes)
                              for m in probes[0]["out_rel"]}
        out["max_loss_rel"] = max(abs(p["loss_bf16"] - p["loss_fp32"])
                                  / abs(p["loss_fp32"]) for p in probes)
        out["median_grad_rel"] = {
            m: statistics.median(p["grad_rel"][m] for p in probes)
            for m in probes[0]["grad_rel"]}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--jax_log")
    ap.add_argument("--metrics", nargs="*", default=[])
    ap.add_argument("--traces", nargs="*", default=[])
    args = ap.parse_args(argv)
    if args.metrics and args.jax_log:
        runs = {path: train_losses(path) for path in args.metrics}
        print(json.dumps({"against_jax": against_jax(
            runs, jax_losses(args.jax_log))}))
    for path in args.traces:
        print(json.dumps({"trace": path, **trace_summary(path)}))


if __name__ == "__main__":
    main()
