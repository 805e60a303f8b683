"""Learnability check on the synthetic room (counterpart of
`simplerecon_tpu/scripts/sanity_train_synthetic.py`).

Trains the hero model from its seeded init on the rendered room
(`data/synthetic.py`: consistent RGB, depth, poses and intrinsics) and
reports depth abs_rel on a fixed set of 3 batches before and after. The
data is real multi-view geometry, so the error falls only if the cost
volume and decoder learn to match. Every `--eval_every` steps it prints
the loss, the eval-mode abs_rel, the train-mode abs_rel (batch
statistics, running statistics left alone: a large gap between the two
means stale running statistics, both large a model that has not learned)
and the largest batch-norm running mean and variance; with `--bn_recal N`
also the abs_rel after N train-mode passes that only refresh the running
statistics. `--matching_norm group` puts GroupNorm-8 in the matching
stem.

    python -m simplerecon_tpu_torch.scripts.sanity_train_synthetic \
        [--steps 1200] [--batch 4] [--matching_norm batch|group] \
        [--seed 0] [--precision bf16|32]

`--seed` draws the initial weights and seeds the loader; the flip coin's
generator takes `--seed` + 1.

Runs on the CUDA card; `main(argv, device="cpu")` runs on the CPU.
"""

from __future__ import annotations

import argparse
import copy
import time

import numpy as np
import torch

from simplerecon_tpu_torch.options import Options


def make_opts(args) -> Options:
    opts = Options()
    opts.image_height, opts.image_width = 64, 96
    opts.matching_num_depth_bins = 32
    opts.model_num_views = 4
    opts.num_images_in_tuple = 4
    opts.min_matching_depth = 0.25
    opts.max_matching_depth = 8.0
    opts.batch_size = args.batch
    opts.lr = 3e-4
    opts.matching_norm = args.matching_norm
    opts.precision = "16" if args.precision == "bf16" else "32"
    return opts


def _abs_rel_of(pred_bhw1: torch.Tensor, batch) -> list:
    from simplerecon_tpu_torch.utils.metrics import \
        compute_depth_metrics_batched
    gt = batch["cur"]["depth_bhw"]
    valid = batch["cur"]["mask_b_bhw"] & (gt > 0)
    m = compute_depth_metrics_batched(gt, pred_bhw1[..., 0].float(), valid)
    return [v for v in m["abs_rel"].cpu().numpy() if np.isfinite(v)]


@torch.no_grad()
def eval_abs_rel(model, batches) -> float:
    """Mean abs_rel of the eval-mode forward over `batches`."""
    from simplerecon_tpu_torch.parallel.train import eval_step
    vals = []
    for batch in batches:
        _, outputs = eval_step(model, batch)
        vals.extend(_abs_rel_of(outputs["depth_pred_s0_bhw1"], batch))
    return float(np.mean(vals))


@torch.no_grad()
def train_mode_abs_rel(model, batches) -> float:
    """Mean abs_rel of the train-mode forward (batch statistics), on a
    copy of the model, so the running statistics are left alone."""
    probe = copy.deepcopy(model).train()
    vals = []
    for batch in batches:
        out = probe(batch["cur"], batch["src"], flip=False)
        vals.extend(_abs_rel_of(out["depth_pred_s0_bhw1"], batch))
    return float(np.mean(vals))


def running_stats_summary(model) -> tuple:
    """The largest |running mean| and running variance of the batch
    norms."""
    means = [b.abs().max() for n, b in model.named_buffers()
             if n.endswith("running_mean")]
    variances = [b.max() for n, b in model.named_buffers()
                 if n.endswith("running_var")]
    return (float(max(means, default=torch.zeros(()))),
            float(max(variances, default=torch.zeros(()))))


@torch.no_grad()
def recal_abs_rel(model, batches, passes: int) -> float:
    """abs_rel after `passes` train-mode forwards over `batches` on a copy
    of the model, which only refresh its running statistics."""
    probe = copy.deepcopy(model).train()
    for _ in range(max(1, passes // len(batches))):
        for b in batches:
            probe(b["cur"], b["src"], flip=False)
    return eval_abs_rel(probe, batches)


def main(argv=None, device=None):
    """Returns (abs_rel before, abs_rel after)."""
    from simplerecon_tpu_torch.data.loader import (DataLoader,
                                                   device_prefetch,
                                                   to_train_schema)
    from simplerecon_tpu_torch.data.synthetic import SyntheticDataset
    from simplerecon_tpu_torch.models.depth_model import (build_depth_model,
                                                          resolve_device)
    from simplerecon_tpu_torch.parallel import train as train_lib

    ap = argparse.ArgumentParser()
    # batch-norm running statistics need ~500 steps to settle
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--eval_every", type=int, default=300)
    ap.add_argument("--bn_recal", type=int, default=0)
    ap.add_argument("--matching_norm", default="batch",
                    choices=["batch", "group"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--precision", default="bf16", choices=["bf16", "32"])
    args = ap.parse_args(argv)
    print(f"config: steps={args.steps} batch={args.batch} "
          f"norm={args.matching_norm} bn_recal={args.bn_recal} "
          f"seed={args.seed} precision={args.precision}", flush=True)

    device = resolve_device(device)
    opts = make_opts(args)
    dataset = SyntheticDataset(num_frames=48,
                               image_height=opts.image_height,
                               image_width=opts.image_width,
                               num_images_in_tuple=4)
    loader = DataLoader(dataset, batch_size=opts.batch_size, shuffle=True,
                        num_workers=2, drop_last=True,
                        adapter=to_train_schema, seed=args.seed)

    model = build_depth_model(opts, device=device, seed=args.seed)
    optimizer = train_lib.make_optimizer(opts, model)
    generator = torch.Generator().manual_seed(args.seed + 1)

    batches = []   # a small fixed evaluation set
    for batch in device_prefetch(loader, device):
        batches.append(batch)
        if len(batches) == 3:
            break

    abs_rel_0 = eval_abs_rel(model, batches)
    print(f"step 0: abs_rel={abs_rel_0:.4f}")

    step = 0
    t0 = time.perf_counter()
    while step < args.steps:
        for batch in device_prefetch(loader, device):
            if step >= args.steps:
                break
            metrics = train_lib.train_step(model, optimizer, batch,
                                           generator)
            step += 1
            if step % args.eval_every == 0:
                abs_rel = eval_abs_rel(model, batches)
                abs_rel_tm = train_mode_abs_rel(model, batches)
                mm, mv = running_stats_summary(model)
                recal = (f" abs_rel_bn_recal="
                         f"{recal_abs_rel(model, batches, args.bn_recal):.4f}"
                         if args.bn_recal else "")
                print(f"step {step}: loss={float(metrics['loss']):.4f} "
                      f"abs_rel={abs_rel:.4f} "
                      f"abs_rel_trainmode={abs_rel_tm:.4f}{recal} "
                      f"bn_max|mean|={mm:.1f} bn_max_var={mv:.1f} "
                      f"({step / (time.perf_counter() - t0):.1f} it/s)",
                      flush=True)

    abs_rel_final = eval_abs_rel(model, batches)
    improved = abs_rel_final < 0.6 * abs_rel_0
    print(f"final abs_rel: {abs_rel_0:.4f} -> {abs_rel_final:.4f} "
          f"({'PASS' if improved else 'FAIL: expected >40% improvement'})")
    return abs_rel_0, abs_rel_final


if __name__ == "__main__":
    main()
