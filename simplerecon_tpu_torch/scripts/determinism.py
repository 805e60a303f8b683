"""Finds what makes a training step's numbers differ from run to run on
the card.

    python -m simplerecon_tpu_torch.scripts.determinism [--model dot|hero]
        [--batch 16]

Builds the seeded bf16 model (`testing.dot_options` or `hero_options`,
384x512, 8 views, 64 planes) and a seeded batch, and takes one forward
and backward (no update, no flip) twice from the same state: first as
the port runs, then under `torch.use_deterministic_algorithms(True,
warn_only=True)` (which also makes cuDNN pick deterministic algorithms).
For each it prints the two losses and the parameters whose gradients
differ between the two runs, grouped by module (the first three parts
of their names), with the largest relative difference of each group;
and, in the second, the operations that PyTorch names as having no
deterministic implementation on the card. Needs a CUDA card.
"""

import argparse
import os
import warnings
from collections import defaultdict

import torch

from simplerecon_tpu_torch.models.depth_model import build_depth_model
from simplerecon_tpu_torch.parallel import train
from simplerecon_tpu_torch.testing import (dot_options, hero_options,
                                           train_batch)


def grads_once(model, batch) -> tuple:
    """The loss and every parameter's gradient of one training-mode
    forward and backward without flip."""
    model.zero_grad(set_to_none=True)
    model.train()
    losses, _ = train.forward_and_losses(model, batch, flip=False)
    losses["loss"].backward()
    torch.cuda.synchronize()
    return losses["loss"].item(), {
        name: p.grad.detach().clone() for name, p in model.named_parameters()
        if p.grad is not None}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model", choices=("dot", "hero"), default="dot")
    parser.add_argument("--batch", type=int, default=16)
    opts_in = parser.parse_args()
    # cuBLAS is deterministic only with a fixed workspace
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    device = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0))
    opts = dot_options() if opts_in.model == "dot" else hero_options()
    model = build_depth_model(opts, device=device, seed=0)
    batch = train.batch_to_device(train_batch(opts, opts_in.batch, seed=7),
                                  device)
    compare(model, batch, opts_in, "as the port runs")
    torch.use_deterministic_algorithms(True, warn_only=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        compare(model, batch, opts_in, "deterministic algorithms")
    named = sorted({str(w.message).split("\n")[0] for w in caught
                    if "deterministic" in str(w.message)})
    print(f"[determinism] operations without a deterministic "
          f"implementation: {len(named)}")
    for message in named:
        print(f"[determinism]   {message[:200]}")


def compare(model, batch, opts_in, tag: str):
    """Two forward and backward passes from the same state: their losses
    and the parameters whose gradients differ."""
    loss_a, grads_a = grads_once(model, batch)
    loss_b, grads_b = grads_once(model, batch)
    print(f"[determinism] {opts_in.model} b{opts_in.batch}, {tag}: loss "
          f"{loss_a!r}, {loss_b!r}")
    differ = defaultdict(list)
    for name, a in grads_a.items():
        b = grads_b[name]
        if not torch.equal(a, b):
            rel = ((a - b).norm() / a.norm().clamp(min=1e-30)).item()
            differ[".".join(name.split(".")[:3])].append((rel, name))
    print(f"[determinism] {tag}: parameters whose gradients differ: "
          f"{sum(len(v) for v in differ.values())} of {len(grads_a)}")
    for group, items in sorted(differ.items()):
        rel, name = max(items)
        print(f"[determinism]   {group}: {len(items)} tensors, largest "
              f"L2-rel {rel:.2e} ({name})")


if __name__ == "__main__":
    main()
