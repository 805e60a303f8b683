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
        [--matching_norm batch|group] [--mesh_points 100000]

Runs on the CUDA card; `main(argv, device="cpu")` runs on the CPU.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time

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
    return ap.parse_args(argv)


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
    train_cli.main(opts, device=device)
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
