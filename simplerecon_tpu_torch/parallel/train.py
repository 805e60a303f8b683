"""The training step (counterpart of `simplerecon_tpu/parallel/train.py`):
AdamW with the reference's stepped learning rate, optional global-norm
clipping, and a skipped update on a non-finite gradient; the
horizontal-flip coin; losses from the predicted depth and normals.

`train_step` runs on one device. `ddp_train_step` is the JAX package's
shard_map step (`_make_shardmap_train_step`) over a process group: each
rank runs forward and backward on its rows of the global batch (so the
sweep's kernels run once a rank), DistributedDataParallel averages the
gradients during the backward, every rank applies the same update, and
the step then averages the batch norms' running statistics and the
logged losses over the ranks, as the JAX step's `pmean`s do. The loss is
the mean of the ranks' masked means, as there.

Parameters and optimizer state are float32; with a bf16 model the
convolutions run under autocast and the sweep in bf16, while pose math
and the losses stay float32.

The step's forward and backward run cuDNN's deterministic convolution
algorithms (`deterministic_convolutions`); the model's other operations
whose backward the card would sum with atomics (the decoder's upsample,
the reflect and replicate pads) are written to sum in a fixed order. So
two steps from one state give the same bits on the card, as the JAX
package's do; inference keeps cuDNN's default choice.

Batch schema (`make_example_batch`): {"cur": ..., "src": ...} dicts of
tensors with the reference's key names; GT depth is at s0 resolution
(half the input image).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from simplerecon_tpu_torch import losses as loss_lib
from simplerecon_tpu_torch import tracing
from simplerecon_tpu_torch.ops import geometry as geo

# optax.apply_if_finite(..., max_consecutive_errors=1000), as the JAX
# package's make_optimizer sets it
MAX_CONSECUTIVE_ERRORS = 1000

def make_lr_schedule(opts):
    """Stepped learning rate: `opts.lr`, times 0.1 at each of
    `opts.lr_steps`. `schedule(count)` is the rate of the update made
    after `count` applied updates (the first update has count 0), as
    optax's piecewise-constant schedule counts."""
    boundaries = sorted(int(s) for s in opts.lr_steps)

    def schedule(count: int) -> float:
        return opts.lr * 0.1 ** sum(count >= bd for bd in boundaries)

    return schedule


class Optimizer:
    """AdamW with the stepped learning rate, an optional global-norm clip,
    and optax's `apply_if_finite`: an update whose gradients are not all
    finite (their global norm is not) is skipped, leaving parameters,
    moments and the update count unchanged, until
    MAX_CONSECUTIVE_ERRORS skips in a row, after which updates are
    applied whatever they hold.

    Use: `loss.backward()`, then `grad_norm = optimizer.step()`.
    """

    def __init__(self, params, lr_schedule, weight_decay: float,
                 grad_clip: float = 0.0):
        self.params = [p for p in params if p.requires_grad]
        self.lr_schedule = lr_schedule
        self.grad_clip = grad_clip
        self.inner = torch.optim.AdamW(self.params, lr=lr_schedule(0),
                                       betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=weight_decay)
        self.count = 0                  # applied updates
        self.consecutive_errors = 0
        self.total_errors = 0

    def zero_grad(self):
        self.inner.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        """Applies one update from the parameters' `.grad` (a missing one
        counts as zero). Returns the global gradient norm, before the
        clip."""
        with tracing.span("sr.optimizer"):
            return self._step()

    def _step(self) -> torch.Tensor:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        norm = torch.nn.utils.get_total_norm(grads)
        with tracing.sync("grad_finite", norm.device):
            finite = bool(torch.isfinite(norm))
        if not finite:
            self.consecutive_errors += 1
            self.total_errors += 1
            if self.consecutive_errors <= MAX_CONSECUTIVE_ERRORS:
                return norm
        else:
            self.consecutive_errors = 0
        for p, grad in zip(self.params, grads):
            p.grad = grad
        if self.grad_clip > 0:
            with tracing.sync("grad_clip", norm.device):
                clip = bool(norm >= self.grad_clip)
            if clip:
                scale = self.grad_clip / norm
                for grad in grads:
                    grad.mul_(scale)
        for group in self.inner.param_groups:
            group["lr"] = self.lr_schedule(self.count)
        self.inner.step()
        self.count += 1
        return norm


def make_optimizer(opts, model: nn.Module) -> Optimizer:
    """AdamW (`opts.lr`, `opts.wd`) over the model's parameters, with the
    stepped rate, the clip of `opts.grad_clip` (off at 0) and the skip of
    non-finite updates."""
    return Optimizer(model.parameters(), make_lr_schedule(opts),
                     weight_decay=opts.wd,
                     grad_clip=float(getattr(opts, "grad_clip", 0.0) or 0.0))


@dataclasses.dataclass
class TrainState:
    """What a training run carries from step to step, and what a full
    checkpoint holds (`utils/checkpoint.py`): the model (parameters and
    batch-norm statistics), the optimizer (AdamW moments, update count,
    skip counters), the flip coin's generator, and `step`, the steps
    taken (a skipped update counts)."""
    model: nn.Module
    optimizer: Optimizer
    generator: torch.Generator
    step: int = 0


def make_example_batch(opts, batch_size: int, dtype=np.float32
                       ) -> Dict[str, Dict[str, np.ndarray]]:
    """A numpy batch with the canonical schema and shapes: zero images,
    unit depth, identity poses, intrinsics at s0 and at the matching
    scale."""
    b = batch_size
    k = opts.model_num_views - 1
    h, w = opts.image_height, opts.image_width
    dh, dw = h // 2, w // 2
    eye = np.broadcast_to(np.eye(4, dtype=dtype), (b, 4, 4)).copy()
    eye_k = np.broadcast_to(np.eye(4, dtype=dtype), (b, k, 4, 4)).copy()

    def K_at(scale_h, scale_w, shape):
        K = np.eye(4, dtype=dtype)
        K[0, 0] = K[0, 2] = scale_w / 2.0
        K[1, 1] = K[1, 2] = scale_h / 2.0
        return np.broadcast_to(K, shape + (4, 4)).copy()

    m = opts.matching_scale
    mh, mw = h // (2 ** (m + 1)), w // (2 ** (m + 1))
    invK_s0 = np.broadcast_to(np.linalg.inv(K_at(dh, dw, ())),
                              (b, 4, 4)).astype(dtype).copy()
    invK_m = np.broadcast_to(np.linalg.inv(K_at(mh, mw, ())),
                             (b, 4, 4)).astype(dtype).copy()
    cur = {
        "image_b3hw": np.zeros((b, 3, h, w), dtype),
        "depth_bhw": np.ones((b, dh, dw), dtype),
        "mask_b_bhw": np.ones((b, dh, dw), bool),
        "invK_s0_b44": invK_s0,
        f"invK_s{m}_b44": invK_m,
        "world_T_cam_b44": eye.copy(),
        "cam_T_world_b44": eye.copy(),
    }
    src = {
        "image_b3hw": np.zeros((b, k, 3, h, w), dtype),
        "depth_bkhw": np.ones((b, k, dh, dw), dtype),
        "K_s0_bk44": K_at(dh, dw, (b, k)),
        f"K_s{m}_b44": K_at(mh, mw, (b, k)),
        "world_T_cam_b44": eye_k.copy(),
        "cam_T_world_b44": eye_k.copy(),
    }
    return {"cur": cur, "src": src}


def batch_to_device(batch: Dict, device
                    ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The numpy batch as tensors on `device`."""
    return {part: {key: torch.as_tensor(np.asarray(v)).to(device)
                   for key, v in data.items()}
            for part, data in batch.items()}


def forward_and_losses(model: nn.Module, batch: Dict, flip: bool
                       ) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """Model forward (in the model's current train/eval mode) and the loss
    dictionary, with normals from the GT depth (NaN where the mask is off,
    which the normals loss masks) and from the predicted depth."""
    cur, src = batch["cur"], batch["src"]
    outputs = model(cur, src, flip=flip)
    with tracing.span("sr.losses"):
        f32 = torch.float32
        depth_pred_s0 = outputs["depth_pred_s0_bhw1"][..., 0].to(f32)
        invK_s0 = cur["invK_s0_b44"].to(f32)
        outputs["normals_pred_bhw3"] = geo.normals_from_depth(depth_pred_s0,
                                                              invK_s0)
        nan = torch.full((), float("nan"), dtype=f32, device=invK_s0.device)
        gt_normals = geo.normals_from_depth(
            torch.where(cur["mask_b_bhw"], cur["depth_bhw"].to(f32), nan),
            invK_s0)
        loss_cur = dict(cur)
        loss_cur["normals_bhw3"] = gt_normals
        loss_src = {
            "depth_bkhw": src["depth_bkhw"],
            "K_s0_bk44": src.get("K_s0_bk44", src.get("K_s0_b44")),
            "cam_T_world_bk44": src["cam_T_world_b44"],
        }
        loss_dict = loss_lib.compute_losses(loss_cur, loss_src, outputs)
        loss_dict["loss"], = tracing.mark("losses", [loss_dict["loss"]])
    return loss_dict, outputs


@contextlib.contextmanager
def deterministic_convolutions():
    """cuDNN's deterministic algorithms while the context is open (its
    default backward algorithms sum in an order that changes from run to
    run); the earlier setting after."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def loss_and_backward(model: nn.Module, batch: Dict, flip: bool) -> Dict:
    """Forward in the model's current mode, losses and backward, with
    deterministic convolutions: the loss dictionary, with each
    parameter's gradient added to its `.grad`."""
    with deterministic_convolutions():
        loss_dict, _ = forward_and_losses(model, batch, flip)
        with tracing.span("sr.backward"):
            loss_dict["loss"].backward()
    return loss_dict


def flip_coin(generator: torch.Generator) -> bool:
    """The step's horizontal-flip coin, heads with probability 1/2."""
    return bool(torch.rand((), generator=generator) < 0.5)


def train_step(model: nn.Module, optimizer: Optimizer, batch: Dict,
               generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """One training step: a flip coin drawn from `generator`, forward in
    train mode, losses, backward, one optimizer update (skipped when a
    gradient is not finite). Returns the detached loss dictionary and
    `grad_norm`."""
    with tracing.span("sr.train_step"):
        tracing.count("train_steps")
        flip = flip_coin(generator)
        model.train()
        optimizer.zero_grad()
        loss_dict = loss_and_backward(model, batch, flip)
        grad_norm = optimizer.step()
    metrics = {key: value.detach() for key, value in loss_dict.items()}
    metrics["grad_norm"] = grad_norm
    return metrics


def wrap_ddp(model: nn.Module) -> nn.Module:
    """`model` (on this rank's device) as DistributedDataParallel, which
    averages the gradients over the ranks during the backward. Buffers
    are not broadcast from rank 0 at each forward: the step averages the
    running statistics itself."""
    from torch.nn.parallel import DistributedDataParallel
    device = next(model.parameters()).device
    return DistributedDataParallel(
        model, device_ids=[device] if device.type == "cuda" else None,
        broadcast_buffers=False)


def running_statistics(model: nn.Module) -> list:
    """The batch norms' running means and variances."""
    return [buf for name, buf in model.named_buffers()
            if name.endswith(("running_mean", "running_var"))]


def mean_over_ranks_(tensors: list) -> None:
    """Replaces each tensor by its mean over the ranks, in one
    all-reduce; every rank gets the same bits."""
    if not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def parity_metrics(model: nn.Module, batch: Dict) -> Dict[str, torch.Tensor]:
    """The JAX step's eval-mode self-check: the loss without flip, at the
    current weights and running statistics, as the mean over the first
    two ranks of their own rows' losses (`parity_loss_sharded`) and on
    those two ranks' rows gathered into one batch
    (`parity_loss_global`). A missing collective or a wrong mean shows as
    a gap between the two."""
    world = dist.get_world_size()
    pair = min(2, world)
    tensors = [(part, key) for part, data in batch.items()
               for key, value in data.items()
               if isinstance(value, torch.Tensor)]
    gathered = {part: {} for part in batch}
    for part, key in tensors:
        value = batch[part][key].contiguous()
        parts = [torch.empty_like(value) for _ in range(world)]
        dist.all_gather(parts, value)
        gathered[part][key] = torch.cat(parts[:pair])
    local, _ = eval_step(model, batch)
    joint, _ = eval_step(model, gathered)
    selected = local["loss"].detach().float() * float(dist.get_rank() < pair)
    dist.all_reduce(selected)
    return {"parity_loss_sharded": selected / pair,
            "parity_loss_global": joint["loss"].detach().float()}


def ddp_train_step(ddp_model: nn.Module, optimizer: Optimizer, batch: Dict,
                   generator: torch.Generator, flip: Optional[bool] = None,
                   parity: bool = False) -> Dict[str, torch.Tensor]:
    """One data-parallel training step on this rank's rows `batch`:
    `ddp_model` is `wrap_ddp`'s wrapper. The flip coin comes from
    `generator`, seeded alike on every rank, unless `flip` is given;
    forward and losses in train mode, backward (DistributedDataParallel
    averages the gradients), one optimizer update from the averaged
    gradients (so every rank takes or skips it alike), then the batch
    norms' running statistics and the losses averaged over the ranks.
    Parameters stay the same bits on every rank. With `parity`, the
    metrics carry `parity_metrics` of the weights before the update.
    Returns the averaged loss dictionary and `grad_norm`."""
    with tracing.span("sr.train_step"):
        tracing.count("train_steps")
        model = ddp_model.module
        metrics = parity_metrics(model, batch) if parity else {}
        coin = flip_coin(generator)
        flip = coin if flip is None else flip
        model.train()
        optimizer.zero_grad()
        loss_dict = loss_and_backward(ddp_model, batch, flip)
        grad_norm = optimizer.step()
        with torch.no_grad(), tracing.span("sr.ranks_mean"):
            mean_over_ranks_(running_statistics(model))
            losses = {key: value.detach().float().clone()
                      for key, value in loss_dict.items()}
            mean_over_ranks_(list(losses.values()))
    metrics.update(losses)
    metrics["grad_norm"] = grad_norm
    return metrics


@torch.no_grad()
def eval_step(model: nn.Module, batch: Dict,
              ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Validation: eval-mode forward without flip; returns (loss
    dictionary, outputs)."""
    model.eval()
    return forward_and_losses(model, batch, flip=False)

