"""What the loops under `benchmark/loops/` share: the `Run` each returns
(the end-to-end values, the counts, the numbers the comparison gives,
and what the traced window and the metric readers need), set-up from the
seed, the traced window, and the program's and the reference's readings
that the comparison takes.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from benchmark import check, generator, program, reference, trace
from benchmark.reference import losses as ref_losses


@dataclass
class Run:
    """`variant` names the metrics that read this run (`<family>.<variant>`,
    "train" or "eval")."""
    variant: str = ""
    values: Dict[str, float] = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    numbers: Dict[str, float] = field(default_factory=dict)
    samples_per_s: Optional[float] = None
    peak_bytes: int = 0
    trace: Optional[trace.Trace] = None
    flops: Dict[bool, float] = field(default_factory=dict)


def note(what: str) -> None:
    """A line on standard error: `what` and the seconds since the
    process started."""
    from benchmark.harness import process_seconds
    print(f"benchmark: {what} at {process_seconds():.2f} s", file=sys.stderr,
          flush=True)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device: torch.device) -> int:
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0


def traced_window(device, units: int, body: Callable[[int], None]):
    """`body(i)` for i < units inside the profiler's window: the Trace."""
    if device.type != "cuda":
        return None
    prof = trace.profiler()
    with prof:
        with trace.window():
            for i in range(units):
                body(i)
    return trace.reduce(prof, units)


def seeded_state(config, seed, device):
    shapes, norms, fixed = reference.layout(config, device)
    return generator.make_weights(shapes, seed, device, fixed, norms)


def count_flops(config, batch, device, backward: bool) -> float:
    """The plain reference's operations a sample (forward, and backward
    when `backward`), counted at batch 1 with `FlopCounterMode`."""
    from torch.utils.flop_counter import FlopCounterMode
    state = seeded_state(config, 0, device)
    model = reference.load(config, state, device).set_checkpoint_sweep(False)
    one = {part: {k: v[:1] for k, v in data.items()}
           for part, data in batch.items()}
    counter = FlopCounterMode(display=False)
    with counter:
        if backward:
            model.train()
            outputs = model(one["cur"], one["src"])
            ref_losses.compute_losses(one["cur"], one["src"], outputs
                                      )["loss"].backward()
        else:
            model.eval()
            with torch.no_grad():
                model(one["cur"], one["src"], return_mask=True)
    return float(counter.get_total_flops())


def set_up(config: Dict, mix: Dict, seed: int, device) -> tuple:
    """The seeded weights, the program's model holding them, and the
    mix's pool of batches, on `device`."""
    note("start")
    torch.zeros(1, device=device)
    sync(device)
    note("device ready")
    state = seeded_state(config, seed, device)
    model = program.build_model(config, state, device)
    sync(device)
    note("weights and model made")
    pool = generator.make_pool(config, mix, seed, device)
    sync(device)
    note("batches made")
    return state, model, pool


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def norms(tensors: Dict[str, torch.Tensor], scale: float = 1.0):
    return {n: (t.detach().float().norm() * scale).item()
            for n, t in tensors.items()}


def host_copies(tensors: Dict[str, torch.Tensor], scale: float = 1.0):
    return {n: (t.detach().float() * scale).cpu()
            for n, t in tensors.items()}


def first_half(tensors: Dict) -> Dict:
    """Each batch tensor of `tensors` cut to the first half of its rows."""
    return {k: v[:v.shape[0] // 2] if torch.is_tensor(v) and v.dim() else v
            for k, v in tensors.items()}


def _first_half_gradient(model, params: Dict, batch: Dict, flip: bool):
    """Host copies of the gradient of the loss over the first half of
    `batch`'s rows, the forward over all of them as in training; the
    model's buffers and gradients are left as they were."""
    buffers = {n: b.clone() for n, b in model.named_buffers()}
    full = {n: p.grad for n, p in params.items()}
    for p in params.values():
        p.grad = None
    outputs = model(batch["cur"], batch["src"], flip=flip)
    ref_losses.compute_losses(first_half(batch["cur"]),
                              first_half(batch["src"]),
                              first_half(outputs))["loss"].backward()
    half = host_copies({n: p.grad if p.grad is not None
                        else torch.zeros_like(p) for n, p in params.items()})
    with torch.no_grad():
        for n, b in model.named_buffers():
            b.copy_(buffers[n])
    for n, p in params.items():
        p.grad = full[n]
    return half


def program_training(trainer: program.Trainer, pool: List[Dict],
                     state: Dict[str, torch.Tensor]) -> Dict:
    """The first `check.STEPS` steps of `trainer` on distinct batches of
    `pool`, with the readings the comparison takes: the first step's s0
    depth is taken from the model's output as the step runs."""
    losses, grad, seen = [], {}, []
    hook = trainer.model.register_forward_hook(
        lambda module, args, out: seen.append(
            out["depth_pred_s0_bhw1"].detach().float().clone()))
    for s in range(check.STEPS):
        metrics = trainer.step(pool[s % len(pool)])
        losses.append({t: metrics[t].item() for t in check.TERMS})
        if s == 0:
            hook.remove()
            scale = 1.0 / (1.0 - trainer.beta1())
            grad = norms(trainer.first_moments(), scale)
            grad_vec = host_copies(trainer.first_moments(), scale)
    change = {n: (p.detach() - state[n]).norm().item()
              for n, p in trainer.model.named_parameters()}
    return {"losses": losses, "grad": grad, "grad_vec": grad_vec,
            "change": change, "depth": seen[0]}


def reference_training(config: Dict, state: Dict[str, torch.Tensor],
                       pool: List[Dict], coins: List[bool], device,
                       precision: str = "float32") -> Dict:
    """The reference's first `check.STEPS` steps from `state`, with the
    same batches and flips, in `precision`; at the first step also the
    gradient of the loss over the first half of the batch's rows
    (`grad_half`), which `check.half_batch_share` measures against."""
    restore = reference.float32_exactly()
    try:
        model = reference.load(config, state, device, precision).train()
        params = dict(model.named_parameters())
        opt = ref_losses.AdamW(params.values(), lr=config["lr"],
                               wd=config["wd"])
        losses, grad = [], {}
        for s in range(check.STEPS):
            for p in params.values():
                p.grad = None
            batch = pool[s % len(pool)]
            outputs = model(batch["cur"], batch["src"], flip=coins[s])
            terms = ref_losses.compute_losses(batch["cur"], batch["src"],
                                              outputs)
            terms["loss"].backward()
            losses.append({t: terms[t].item() for t in check.TERMS})
            if s == 0:
                grads = {n: p.grad if p.grad is not None
                         else torch.zeros_like(p) for n, p in params.items()}
                grad, grad_vec = norms(grads), host_copies(grads)
                depth = outputs["depth_pred_s0_bhw1"].detach().clone()
                del grads, outputs, terms
                grad_half = _first_half_gradient(model, params, batch,
                                                 coins[s])
            else:
                del outputs, terms
            opt.step()
        change = {n: (p.detach() - state[n]).norm().item()
                  for n, p in params.items()}
        return {"losses": losses, "grad": grad, "grad_vec": grad_vec,
                "grad_half": grad_half, "change": change, "depth": depth}
    finally:
        restore()


# --------------------------------------------------------------------------
# inference
# --------------------------------------------------------------------------

def reference_answers(config: Dict, state, batch, device,
                      precision: str = "float32") -> Dict[str, torch.Tensor]:
    """The reference's s0 depth, lowest-cost depth and mask of `batch`,
    on the host."""
    restore = reference.float32_exactly()
    try:
        model = reference.load(config, state, device, precision).eval()
        with torch.no_grad():
            out = model(batch["cur"], batch["src"], return_mask=True)
        return {k: out[k].cpu() for k in ("depth_pred_s0_bhw1",
                                          "lowest_cost_bhw",
                                          "overall_mask_bhw")}
    finally:
        restore()
