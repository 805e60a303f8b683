"""Data-parallel training and eval over every visible card, checked.

    python -m simplerecon_tpu_torch.scripts.ddp_check [--steps 2] \
        [--out build/ddp_check]

On a machine with N >= 2 cards, with one rank a card over NCCL:
1. the hero model at full width (the hero YAML: bf16, 384x512, 8 views,
   64 planes), global batch 16 split over the N ranks, `--steps`
   training steps through `parallel/train.py::ddp_train_step`
   (`testing.run_ddp_steps`): K1, K2 and the scatter once per rank per
   step, every rank's parameters, buffers and metrics the same bits,
   and the result against the single-process mean of the N shards on
   the first card (`testing.shard_mean_steps`): relative L2 of the
   parameters, of the running statistics and of the losses within
   SHARD_MEAN_TOL; step ms and peak memory per rank;
2. the training CLI with `--num_devices N` (4 steps, a validation of
   one batch at the end): K1, K2 and the scatter once per rank per step
   (and K1 once more on rank 0), a finite loss at every logged step, a
   checkpoint the single-device restore reads;
3. the eval CLI with `--data_parallel_eval` over the N cards against the
   same run on one card, on the 41-frame synthetic scene: K1 once a
   shard, depths within DP_EVAL_L2_TOL (relative L2) and the lowest-cost
   planes the same at DP_EVAL_LOWEST_AGREE of the pixels.
Prints one line per part and a last line `DDP_CHECK {...}` (JSON); any
failed check raises. Run it on a host with four cards.

`main(argv, device="cpu", ranks=N)` runs the same on N gloo ranks on the
CPU, where no kernel launches (at the hero's full size: rehearse it with
smaller options).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import statistics
import time

import torch

from simplerecon_tpu_torch import ops, testing, tracing
from simplerecon_tpu_torch.options import OptionsHandler
from simplerecon_tpu_torch.scripts import test as eval_cli
from simplerecon_tpu_torch.scripts import train as train_cli

BATCH = 16
CLI_STEPS = 4
# rank 0 against the single-process mean of the shards: NCCL sums the
# gradients in its ring's order, so the bits may differ; Adam's first
# updates move a weight by about lr x the sign of its gradient, so a sum
# in another order shows as ~1e-4 and a missing or wrong mean as ~1
SHARD_MEAN_TOL = 1e-3
DP_EVAL_L2_TOL = 1e-2
DP_EVAL_LOWEST_AGREE = 0.99
SWEEP_WRAPPERS = ("fused_sweep", "fused_sweep_bwd", "sweep_scatter")


def check(condition: bool, what) -> None:
    if not condition:
        raise AssertionError(what)


def sweep_launches(counts: dict) -> tuple:
    """(K1, K2, scatter) launches of a rank (all 0 on the CPU, where the
    wrappers run their plain versions); raises if another kernel ran."""
    others = {k: v for k, v in counts.items()
              if k not in SWEEP_WRAPPERS and v}
    check(not others, f"other kernels launched: {others}")
    return tuple(counts[name] for name in SWEEP_WRAPPERS)


def train_steps(world: int, out: str, device_type: str, steps: int,
                first, on_card: int) -> dict:
    opts = testing.hero_options()
    batch = testing.train_batch(opts, BATCH, seed=7)
    t0 = time.perf_counter()
    ranks = testing.run_ddp_steps(world, out, opts, 0, batch,
                                  [None] * steps, device_type=device_type)
    wall = time.perf_counter() - t0
    launches = [sweep_launches(r["launches"]) for r in ranks]
    check(all(n == (steps * on_card,) * 3 for n in launches), launches)
    want, ref = testing.shard_mean_steps(opts, batch, world, steps, first)
    report = testing.compare_ranks(ranks, want, ref)
    check(report["ranks_equal"], report)
    check(max(report["param_rel"], report["stat_rel"], report["loss_rel"])
          <= SHARD_MEAN_TOL, report)
    step_ms = [r["step_ms"] for r in ranks]
    peak = [r["peak_memory_bytes"] / 2 ** 30 for r in ranks]
    print(f"[ddp_check] {world} ranks, hero global b{BATCH} "
          f"{opts.compute_dtype}, {steps} steps: launches (K1, K2, scatter) "
          f"per rank {launches}; losses "
          + ", ".join(f"{m['loss']:.6f}" for m in ranks[0]["metrics"])
          + " (single-process mean "
          + ", ".join(f"{m['loss']:.6f}" for m in want) + f"); {report}; "
          f"step ms per rank {[[round(x, 2) for x in ms] for ms in step_ms]}"
          f"; peak memory per rank {[round(x, 2) for x in peak]} GiB; wall "
          f"{wall:.1f} s", flush=True)
    return dict(launches=launches, report=report, peak_gib=peak,
                step_ms=[statistics.median(ms[1:] or ms) for ms in step_ms])


def train_cli_run(world: int, out: str, device, on_card: int) -> dict:
    shutil.rmtree(out, ignore_errors=True)
    opts = OptionsHandler().parse_and_merge_options(cl_args_list=[
        "--config_file", str(testing.CONFIGS / "hero_model.yaml"),
        "--dataset", "synthetic", "--single_debug_scan_id", "scene",
        "--num_devices", str(world), "--max_steps", str(CLI_STEPS),
        "--log_interval", "1", "--val_interval", str(CLI_STEPS),
        "--val_batches", "1", "--log_dir", out])
    t0 = time.perf_counter()
    state = train_cli.main(opts, device=device)
    seconds = time.perf_counter() - t0
    ranks = state.run_stats["ranks"]
    launches = [sweep_launches(r["launches"]) for r in ranks]
    check(launches == [((CLI_STEPS + (rank == 0)) * on_card,
                        CLI_STEPS * on_card, CLI_STEPS * on_card)
                       for rank in range(world)], launches)
    check(state.step == state.optimizer.count == CLI_STEPS, state.step)
    with open(os.path.join(out, opts.name, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    check(len(losses) == CLI_STEPS and all(map(math.isfinite, losses)),
          rows)
    step_ms = [[t * 1e3 for t in r["step_seconds"]] for r in ranks]
    print(f"[ddp_check] train CLI --num_devices {world}: launches per rank "
          f"{launches}; losses " + ", ".join(f"{x:.4f}" for x in losses)
          + f"; step ms per rank {[[round(x, 1) for x in ms] for ms in step_ms]}"
          f"; total {seconds:.1f} s", flush=True)
    return dict(launches=launches, seconds=seconds,
                step_ms=[statistics.median(ms[1:]) for ms in step_ms])


def eval_run(out: str, devices: list) -> tuple:
    shutil.rmtree(out, ignore_errors=True)
    extra = ["--data_parallel_eval"] if len(devices) > 1 else []
    opts = OptionsHandler().parse_and_merge_options(cl_args_list=[
        "--config_file", str(testing.CONFIGS / "hero_model.yaml"),
        "--dataset", "synthetic", "--single_debug_scan_id", "scene",
        "--split", "test", "--cache_depths", "--output_base_path", out,
        *extra])
    tracing.reset_counters()
    t0 = time.perf_counter()
    frame_avg, _ = eval_cli.main(opts, device=devices[0], devices=devices)
    seconds = time.perf_counter() - t0
    depths = os.path.join(out, opts.name, opts.dataset,
                          opts.frame_tuple_type, "depths", "scene")
    return frame_avg.run_stats, ops.launch_counts(), seconds, depths


def main(argv=None, device=None, ranks=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--out", default="build/ddp_check")
    args = ap.parse_args(argv)
    device_type = torch.device("cuda" if device is None else device).type
    if ranks is None:
        ranks = torch.cuda.device_count() if device_type == "cuda" else 2
    check(ranks >= 2, f"{ranks} device(s): the check needs two or more")
    devices = [torch.device("cpu")] * ranks if device_type == "cpu" else [
        torch.device("cuda", r) for r in range(ranks)]
    first = devices[0]
    on_card = int(device_type == "cuda")
    if on_card:
        from simplerecon_tpu_torch.ops import _build
        _build.build()      # once here, not once a rank

    trained = train_steps(ranks, os.path.join(args.out, "steps"),
                          device_type, args.steps, first, on_card)
    if on_card:
        torch.cuda.empty_cache()
    cli = train_cli_run(ranks, os.path.join(args.out, "train_cli"),
                        device_type, on_card)
    one_stats, one_counts, one_s, one_depths = eval_run(
        os.path.join(args.out, "eval_one"), [first])
    dp_stats, dp_counts, dp_s, dp_depths = eval_run(
        os.path.join(args.out, "eval_dp"), devices)
    check(sweep_launches(dp_counts)
          == (ranks * dp_stats["batches"] * on_card, 0, 0), dp_counts)
    depths = testing.compare_depth_maps(dp_depths, one_depths)
    check(depths["depth_l2"] <= DP_EVAL_L2_TOL
          and depths["lowest_agree"] >= DP_EVAL_LOWEST_AGREE, depths)
    print(f"[ddp_check] eval CLI --data_parallel_eval over {ranks} devices:"
          f" {dp_stats['frames']} frames in {dp_stats['batches']} batches, "
          f"K1 {sweep_launches(dp_counts)[0]} (one device: "
          f"{sweep_launches(one_counts)[0]}); {dp_s:.2f} s (one device "
          f"{one_s:.2f} s); against one device's depths: {depths}",
          flush=True)
    summary = dict(ranks=ranks, device_type=device_type,
                   steps=trained, train_cli=cli,
                   eval=dict(seconds=dp_s, one_device_seconds=one_s,
                             depths=depths))
    print("DDP_CHECK " + json.dumps(summary, default=str), flush=True)
    return summary


if __name__ == "__main__":
    main()
