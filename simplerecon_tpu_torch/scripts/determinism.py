"""Finds what makes a training step's numbers differ from run to run on
the card.

    python -m simplerecon_tpu_torch.scripts.determinism [--model dot|hero]
        [--batch 16] [--ops]

Builds the seeded bf16 model (`testing.dot_options` or `hero_options`,
384x512, 8 views, 64 planes) and a seeded batch, and takes one forward
and backward (no update, no flip) twice from the same state under each
of three settings: PyTorch's defaults; as the port's training step runs
it (`parallel/train.py::loss_and_backward`: cuDNN's deterministic
convolutions, and the model's own fixed-order backwards of the upsample
and the pads); and under `torch.use_deterministic_algorithms(True,
warn_only=True)`. For each it prints the two losses and the parameters
whose gradients differ between the two runs, grouped by module (the
first three parts of their names) with the largest relative difference
of each group; under the last setting also the operations that PyTorch
names as having no deterministic implementation on the card.

With `--ops` it instead takes single operations' backwards three times
at the b16 step's shapes (the pads, the decoder's upsample, the stem's
pools, the losses' nearest resize) and says whose input gradients
repeat their bits. The script sets no `CUBLAS_WORKSPACE_CONFIG`, as the
port sets none. Needs a CUDA card.
"""

import argparse
import contextlib
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
    forward and backward without flip, as the training step takes them."""
    model.zero_grad(set_to_none=True)
    model.train()
    losses = train.loss_and_backward(model, batch, flip=False)
    torch.cuda.synchronize()
    return losses["loss"].item(), {
        name: p.grad.detach().clone() for name, p in model.named_parameters()
        if p.grad is not None}


@contextlib.contextmanager
def all_deterministic():
    """PyTorch's deterministic algorithms everywhere (a warning for an
    operation that has none)."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


@contextlib.contextmanager
def defaults():
    """PyTorch's default algorithms, also inside the training step."""
    step = train.deterministic_convolutions
    train.deterministic_convolutions = contextlib.nullcontext
    try:
        yield
    finally:
        train.deterministic_convolutions = step


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
            rel = ((a - b).float().norm()
                   / a.float().norm().clamp(min=1e-30)).item()
            differ[".".join(name.split(".")[:3])].append((rel, name))
    print(f"[determinism] {tag}: parameters whose gradients differ: "
          f"{sum(len(v) for v in differ.values())} of {len(grads_a)}")
    for group, items in sorted(differ.items()):
        rel, name = max(items)
        print(f"[determinism]   {group}: {len(items)} tensors, largest "
              f"L2-rel {rel:.2e} ({name})")


def probe_ops(device):
    """Each operation's backward, twice on the same input and cotangent,
    with PyTorch's default algorithms: do the input gradients repeat
    their bits? At the hero b16 training step's shapes, in bf16."""
    import torch.nn.functional as F

    from simplerecon_tpu_torch.ops import pool
    from simplerecon_tpu_torch.ops.image import pad_edges
    from simplerecon_tpu_torch.ops.sampling import resize_nearest, upsample2x
    bf16 = torch.bfloat16
    stem, filt = (128, 64, 191, 255), pool.blur_filter(64, device=device)
    cases = (
        ("F.pad reflect (stem)", stem,
         lambda x: F.pad(x, (1, 2, 1, 2), mode="reflect")),
        ("pad_edges reflect (stem)", stem,
         lambda x: pad_edges(x, (1, 2, 1, 2), "reflect")),
        ("F.pad replicate (net.8)", (128, 128, 96, 128),
         lambda x: F.pad(x, (1, 1, 1, 1), mode="replicate")),
        ("pad_edges replicate (net.8)", (128, 128, 96, 128),
         lambda x: pad_edges(x, (1, 1, 1, 1), "replicate")),
        ("F.interpolate bilinear x2 (decoder)", (16, 64, 96, 128),
         lambda x: F.interpolate(x, scale_factor=2, mode="bilinear",
                                 align_corners=False)),
        ("upsample2x (decoder)", (16, 64, 96, 128), upsample2x),
        ("max_pool2d 2x2/1 (stem)", (128, 64, 192, 256),
         lambda x: F.max_pool2d(x, 2, stride=1)),
        ("depthwise blur conv (stem)", (128, 64, 194, 258),
         lambda x: F.conv2d(x, filt.to(x.dtype), stride=2, groups=64)),
        ("resize_nearest (losses)", (16, 24, 32, 1),
         lambda x: resize_nearest(x, 192, 256)),
    )
    gen = torch.Generator(device=device).manual_seed(0)
    for name, shape, fn in cases:
        x = torch.randn(shape, device=device, generator=gen).to(bf16)
        x.requires_grad_(True)
        out = fn(x)
        g = torch.randn(out.shape, device=device, generator=gen).to(bf16)
        grads = [torch.autograd.grad(fn(x), x, g)[0] for _ in range(3)]
        same = all(torch.equal(grads[0], other) for other in grads[1:])
        print(f"[determinism] op {name}: input gradient "
              + ("repeats its bits" if same else "differs") + " over 3 runs")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model", choices=("dot", "hero"), default="dot")
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--ops", action="store_true",
                        help="probe single operations' backwards instead")
    opts_in = parser.parse_args()
    device = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0), "CUBLAS_WORKSPACE_CONFIG="
          + os.environ.get("CUBLAS_WORKSPACE_CONFIG", "(unset)"))
    if opts_in.ops:
        probe_ops(device)
        return
    opts = dot_options() if opts_in.model == "dot" else hero_options()
    model = build_depth_model(opts, device=device, seed=0)
    batch = train.batch_to_device(train_batch(opts, opts_in.batch, seed=7),
                                  device)
    with defaults():
        compare(model, batch, opts_in, "PyTorch's defaults")
    compare(model, batch, opts_in, "as the port runs")
    with warnings.catch_warnings(record=True) as caught, \
            all_deterministic():
        warnings.simplefilter("always")
        compare(model, batch, opts_in, "deterministic algorithms")
    named = sorted({str(w.message).split("\n")[0] for w in caught
                    if "deterministic" in str(w.message)})
    print(f"[determinism] operations without a deterministic "
          f"implementation: {len(named)}")
    for message in named:
        print(f"[determinism]   {message[:200]}")


if __name__ == "__main__":
    main()
