"""The whole workflow in one command (counterpart of
`simplerecon_tpu/scripts/grand_loop.py`), on the synthetic room with no
external data:

  1. `scripts/train.py::main`: the hero architecture trained from its
     seeded init, with validation and checkpoints;
  2. `scripts/test.py::main`: depth evaluation with those weights (the
     checkpoint directory) and TSDF fusion to a mesh;
  3. the fused mesh scored against the room's exact geometry
     (`utils/mesh_metrics.py::evaluate_mesh`, 5 cm).

Prints one line `GRAND_LOOP_SUMMARY {...}` (the last training loss, the
depth metrics, the mesh metrics, seconds) and writes the same JSON to
`<out>/grand_loop_summary.json`.

    python -m simplerecon_tpu_torch.scripts.grand_loop \
        [--steps 5000] [--out build/grand_loop] [--lr 3e-4] \
        [--matching_norm batch|group] [--mesh_points 100000] \
        [--seed 0] [--precision bf16|32] \
        [--trace_from 3000 [--shadow_fp32]]

`--seed` draws the initial weights and seeds the loader and the flip
coin. From step `--trace_from` every step's loss and gradient norm go to
`<out>/trace.jsonl`, and every `TRACE_EVERY` (50) steps also the largest
batch-norm running variance and |running mean| and the gradient norm of
each top-level module; with `--shadow_fp32`, at those steps, the step's
batch also goes through a bf16 and a float32 copy of the model (train
mode, no flip), and the relative L2 difference of each top-level
module's outputs and gradients between the two is written beside them,
and at each of the first three steps that break (a gradient that is not
finite, or a loss 20 times the median of the last 50), the state before
that step goes through both copies on its batch, every module three
levels deep compared in the order the modules ran.

Runs on the CUDA card; `main(argv, device="cpu")` runs on the CPU.
"""

from __future__ import annotations

import argparse
import copy
import glob
import json
import math
import os
import time

import torch

from simplerecon_tpu_torch.options import Options

# the keys of the summary, in the JAX package's order
DEPTH_KEYS = ("abs_rel", "sq_rel", "rmse", "a25", "a1")


def make_opts(args) -> Options:
    """The loop's model and data: 64x96, 4 views, 32 planes, the
    synthetic scene, batch `args.batch`, `args.lr`, `args.matching_norm`."""
    opts = Options()
    opts.name = "grand_loop"
    opts.dataset = "synthetic"
    opts.dataset_path = ""
    opts.dataset_scan_split_file = ""
    opts.single_debug_scan_id = "scene"
    opts.image_height, opts.image_width = 64, 96
    opts.matching_num_depth_bins = 32
    opts.model_num_views = 4
    opts.num_images_in_tuple = 4
    opts.min_matching_depth = 0.25
    opts.max_matching_depth = 8.0
    opts.batch_size = args.batch
    opts.val_batch_size = args.batch
    opts.lr = args.lr
    opts.matching_norm = args.matching_norm
    opts.random_seed = args.seed
    opts.precision = "16" if args.precision == "bf16" else "32"
    return opts


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=5000)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--out", default="build/grand_loop")
    ap.add_argument("--matching_norm", default="batch",
                    choices=["batch", "group"])
    ap.add_argument("--fusion_resolution", type=float, default=0.04)
    # points sampled from each mesh for the mesh metrics
    ap.add_argument("--mesh_points", type=int, default=100_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--precision", default="bf16", choices=["bf16", "32"])
    ap.add_argument("--trace_from", type=int, default=None)
    ap.add_argument("--shadow_fp32", action="store_true")
    return ap.parse_args(argv)


def _tensors(x) -> list:
    """The tensors in a module's output (a tensor, or lists, tuples and
    dicts of them)."""
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _rel_l2(a: list, b: list) -> float:
    """|a - b| / |b| over lists of tensors of the same shapes."""
    num = sum(float((x - y).double().pow(2).sum()) for x, y in zip(a, b))
    den = sum(float(y.double().pow(2).sum()) for y in b)
    return math.sqrt(num / den) if den > 0 else float("nan")


def probe_step(model, batch, dtype: torch.dtype, state=None,
               depth: int = 1):
    """Forward and backward of a copy of `model` (with `state` loaded when
    given) in train mode on `batch` (no flip) with compute dtype `dtype`:
    the loss, the outputs (float32) of every module `depth` levels deep
    or less, in the order they ran, and each parameter's gradient."""
    from simplerecon_tpu_torch.parallel import train as train_lib
    probe = copy.deepcopy(model).train()
    if state is not None:
        probe.load_state_dict(state)
    for m in probe.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = dtype
    outs = {}

    def keep(name):
        def hook(module, inputs, output):
            outs[name] = [t.detach().float() for t in _tensors(output)]
        return hook

    hooks = [mod.register_forward_hook(keep(name))
             for name, mod in probe.named_modules()
             if name and name.count(".") < depth]
    probe.zero_grad(set_to_none=True)
    loss = float(train_lib.loss_and_backward(probe, batch, False)["loss"])
    for h in hooks:
        h.remove()
    grads = {n: p.grad.detach().float()
             for n, p in probe.named_parameters() if p.grad is not None}
    return loss, outs, grads


def shadow(model, batch, state=None, depth: int = 1) -> dict:
    """`batch` through a bf16 and a float32 copy of `model` (see
    `probe_step`): both losses, the relative L2 difference of each
    module's outputs and of each top-level module's gradients."""
    lb, ob, gb = probe_step(model, batch, torch.bfloat16, state, depth)
    lf, of, gf = probe_step(model, batch, torch.float32, state, depth)
    tops = {n.split(".")[0] for n in gf}
    return {
        "loss_bf16": lb, "loss_fp32": lf,
        "out_rel": {n: _rel_l2(ob[n], of[n]) for n in of if n in ob},
        "grad_rel": {top: _rel_l2([gb[n] for n in names],
                                  [gf[n] for n in names])
                     for top in tops
                     for names in [[n for n in gf if n in gb
                                    and n.split(".")[0] == top]]}}


def module_grad_norms(model) -> dict:
    """The gradient norm of each top-level module's parameters."""
    sums = {}
    for name, p in model.named_parameters():
        if p.grad is not None:
            key = name.split(".")[0]
            sums[key] = sums.get(key, 0.0) + float(
                p.grad.double().pow(2).sum())
    return {k: math.sqrt(v) for k, v in sums.items()}


TRACE_EVERY = 50
# a step "breaks" when its gradient is not finite or its loss exceeds
# this multiple of the median of the last 50 losses
BREAK_FACTOR = 20.0
BREAK_PROBES = 3


def make_tracer(args, path: str):
    """The training loop's `on_step` hook of `--trace_from` (see the
    module docstring); writes JSON lines to `path`."""
    import numpy as np
    from simplerecon_tpu_torch.scripts.sanity_train_synthetic import \
        running_stats_summary
    recent, held = [], {}

    def on_step(state, batch, metrics):
        if state.step < args.trace_from:
            return
        rec = {"step": state.step, "loss": float(metrics["loss"]),
               "grad_norm": float(metrics["grad_norm"])}
        broke = (not math.isfinite(rec["grad_norm"])
                 or len(recent) >= 10
                 and rec["loss"] > BREAK_FACTOR * float(np.median(recent)))
        if args.shadow_fp32 and broke and held.get("probes", 0) < \
                BREAK_PROBES and "state" in held:
            # the state before this step, on this step's batch, every
            # module three levels deep
            held["probes"] = held.get("probes", 0) + 1
            rec["break"] = shadow(state.model, batch, held["state"], 3)
            print("break " + json.dumps(rec), flush=True)
        if state.step % TRACE_EVERY == 0:
            rec["bn_max_abs_mean"], rec["bn_max_var"] = \
                running_stats_summary(state.model)
            rec["module_grad_norm"] = module_grad_norms(state.model)
            if args.shadow_fp32:
                rec["shadow"] = shadow(state.model, batch)
            print("trace " + json.dumps(rec), flush=True)
        if math.isfinite(rec["loss"]) and not broke:
            recent[:] = (recent + [rec["loss"]])[-50:]
        if args.shadow_fp32:
            held["state"] = {k: v.detach().clone()
                             for k, v in state.model.state_dict().items()}
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    return on_step


def main(argv=None, device=None) -> dict:
    """Runs the three stages on `device` (the CUDA card unless another is
    given); returns the summary."""
    from simplerecon_tpu_torch.data.synthetic import make_room_mesh
    from simplerecon_tpu_torch.fusion.mesh import read_ply
    from simplerecon_tpu_torch.scripts import test as test_cli
    from simplerecon_tpu_torch.scripts import train as train_cli
    from simplerecon_tpu_torch.utils.mesh_metrics import evaluate_mesh

    args = parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    summary = {"steps": args.steps, "lr": args.lr,
               "matching_norm": args.matching_norm}
    print(f"grand loop: seed {args.seed}, precision {args.precision}",
          flush=True)

    # 1. train
    opts = make_opts(args)
    opts.log_dir = os.path.join(args.out, "logs")
    opts.max_steps = args.steps
    # the JAX loop's intervals, at most the run's length (a run shorter
    # than 50 steps still logs a loss and writes a checkpoint)
    opts.log_interval = min(max(50, args.steps // 20), args.steps)
    opts.val_interval = min(max(100, args.steps // 10), args.steps)
    opts.val_batches = 2
    t0 = time.perf_counter()
    on_step = (make_tracer(args, os.path.join(args.out, "trace.jsonl"))
               if args.trace_from is not None else None)
    train_cli.main(opts, device=device, on_step=on_step)
    summary["train_seconds"] = round(time.perf_counter() - t0, 1)
    ckpt_dir = os.path.join(opts.log_dir, opts.name, "checkpoints")
    assert os.path.isdir(ckpt_dir), f"no checkpoints at {ckpt_dir}"

    log_path = os.path.join(opts.log_dir, opts.name, "metrics.jsonl")
    with open(log_path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    summary["final_train_loss"] = round(float(losses[-1]), 4)

    # 2. the eval CLI with fusion
    opts = make_opts(args)
    opts.output_base_path = os.path.join(args.out, "eval")
    opts.split = "val"
    opts.load_weights_from_checkpoint = ckpt_dir
    opts.run_fusion = True
    opts.fusion_resolution = args.fusion_resolution
    opts.fusion_max_depth = 8.0
    t0 = time.perf_counter()
    frame_avg, _ = test_cli.main(opts, device=device)
    summary["eval_seconds"] = round(time.perf_counter() - t0, 1)
    for k in DEPTH_KEYS:
        if k in frame_avg.final_metrics:
            summary[f"depth_{k}"] = round(
                float(frame_avg.final_metrics[k]), 4)

    # 3. the mesh against the room's exact geometry
    plys = glob.glob(os.path.join(args.out, "eval", "**", "*.ply"),
                     recursive=True)
    assert plys, "fusion produced no mesh"
    pred_v, pred_f = read_ply(plys[0])
    gt_v, gt_f, _ = make_room_mesh()
    mesh_metrics = evaluate_mesh(pred_v, pred_f, gt_v, gt_f,
                                 num_points=args.mesh_points,
                                 threshold=0.05)
    summary.update({f"mesh_{k}": round(float(v), 4)
                    for k, v in mesh_metrics.items()})

    with open(os.path.join(args.out, "grand_loop_summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print("GRAND_LOOP_SUMMARY " + json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
