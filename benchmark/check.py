"""What decides `correct`: the program's outputs against the plain
reference's, each number held to its limit from `limits/<cell>.json`.

Training (the first `STEPS` steps of the object the window then drives):
  depth_gap   the relative L2 gap of the first step's s0 depth (every
              row of the batch: a step that leaves rows out reads inf);
  loss_gap    the largest relative gap of the step's total loss, steps 1-3;
  term_gap    the largest relative gap of the nine loss terms of step 1;
  grad_median_gap    the median over leaves of |norm(program's first
                     gradient) - norm(reference's)| over the larger of
                     the reference leaf's norm and the median leaf's; the
                     program's gradient is read from AdamW's first moment
                     after one step (m = (1 - b1) g);
  half_batch_share   the median over leaves of how far the program's first
                     gradient lies from the reference's along the move
                     that the reference's makes when its loss leaves the
                     second half of the batch out, as a share of that
                     move: near 0 for a step that takes every row, near 1
                     for one whose loss leaves either half out, though
                     its norms and shapes read as sound;
  stats_gap   (ranks) the relative L2 gap of rank 0's batch-norm running
              statistics after the three steps;
  ranks_differ (ranks) how many ranks hold other parameter or buffer
              bits than rank 0 after the window.
The worst leaf's gaps (`grad_gap`, `update_gap`) are kept for the record:
in bf16 a few batch-norm and squeeze-excite leaves of the image prior
read 0.1-0.2 on every seed, where the median leaf reads ~0.01.
Inference (answers of the window, sampled from the seed):
  depth_gap        the largest relative L2 gap of the s0 depth;
  lowest_cost_off  the largest share of pixels whose lowest-cost plane
                   differs;
  mask_off         the largest share of pixels whose mask differs (for
                   the record: float32 geometry on both sides).
"""

from __future__ import annotations

import math
from statistics import median
from typing import Dict, List

import torch

STEPS = 3
TERMS = ("loss", "si_loss", "grad_loss", "abs_loss", "normals_loss",
         "ms_loss", "inv_abs_loss", "log_l1_loss", "mv_loss")
QUIET_GRADIENT = 1e-3


def _leaf_gap(got: Dict[str, float], want: Dict[str, float],
              names: List[str]) -> tuple:
    """(worst gap, its leaf) of per-leaf norms, each over the larger of
    the reference leaf's norm and the median reference leaf's."""
    mid = median(want[n] for n in want)
    worst, leaf = 0.0, None
    for n in names:
        gap = abs(got.get(n, 0.0) - want[n]) / max(want[n], mid, 1e-30)
        if not math.isfinite(gap):
            return math.inf, n
        if gap > worst:
            worst, leaf = gap, n
    return worst, leaf


def _median_gap(got: Dict[str, float], want: Dict[str, float],
                names: List[str]) -> float:
    mid = median(want[n] for n in want)
    gaps = [abs(got.get(n, 0.0) - want[n]) / max(want[n], mid, 1e-30)
            for n in names]
    gap = median(gaps)
    return gap if math.isfinite(gap) else math.inf


def half_batch_share(got: Dict[str, torch.Tensor],
                     full: Dict[str, torch.Tensor],
                     half: Dict[str, torch.Tensor]) -> float:
    """The median over leaves of |<got - full, full - half>| /
    |full - half|^2: `got` the program's first gradient, `full` the
    reference's, `half` the reference's with its loss over the first half
    of the rows (a leaf missing from `got` counts as 0)."""
    shares = []
    for n, f in full.items():
        f = f.double()
        move = f - half[n].double()
        g = got.get(n)
        off = (g.double() if g is not None else torch.zeros_like(f)) - f
        share = abs((off * move).sum().item()) / max(
            (move * move).sum().item(), 1e-300)
        shares.append(share if math.isfinite(share) else math.inf)
    return median(shares)


def compare_training(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The training numbers of `program` against `reference` readings
    (each {"losses": [{term: value}] * STEPS, "grad": {leaf: norm},
    "grad_vec": {leaf: first gradient}, "change": {leaf: norm}}; the
    reference's with "grad_half", its first gradient over half the rows)."""
    def rel(a, b):
        gap = abs(a - b) / max(abs(b), 1e-30)
        return gap if math.isfinite(gap) else math.inf

    loss_gap = max(rel(p["loss"], r["loss"])
                   for p, r in zip(prog["losses"], ref["losses"]))
    term_gap = max(rel(prog["losses"][0][t], ref["losses"][0][t])
                   for t in TERMS)
    grad_gap, _ = _leaf_gap(prog["grad"], ref["grad"], list(ref["grad"]))
    mid = median(ref["grad"].values())
    moving = [n for n, g in ref["grad"].items() if g >= QUIET_GRADIENT * mid]
    update_gap, _ = _leaf_gap(prog["change"], ref["change"], moving)
    extra = ({"stats_gap": _relative_l2(prog["stats"], ref["stats"])}
             if "stats" in prog and "stats" in ref else {})
    if "grad_vec" in prog and "grad_half" in ref:
        extra["half_batch_share"] = half_batch_share(
            prog["grad_vec"], ref["grad_vec"], ref["grad_half"])
    return {**extra, "depth_gap": _relative_l2(prog["depth"], ref["depth"]),
            "loss_gap": loss_gap, "term_gap": term_gap,
            "grad_median_gap": _median_gap(prog["grad"], ref["grad"],
                                           list(ref["grad"])),
            "update_median_gap": _median_gap(prog["change"], ref["change"],
                                             moving),
            "grad_gap": grad_gap, "update_gap": update_gap}


def leaf_look(prog: Dict, ref: Dict, key: str, top: int = 6) -> Dict:
    """For the record: each leaf's gap in `key` ("grad" or "change"),
    their median and quartiles, and the `top` worst leaves with the
    reference leaf's norm over the median leaf's."""
    mid = median(ref[key].values())
    names = list(ref[key])
    if key == "change":
        gmid = median(ref["grad"].values())
        names = [n for n in names if ref["grad"][n] >= QUIET_GRADIENT * gmid]
    gaps = sorted(((abs(prog[key].get(n, 0.0) - ref[key][n])
                    / max(ref[key][n], mid, 1e-30), n) for n in names),
                  reverse=True)
    values = sorted(g for g, _ in gaps)
    q = lambda f: values[int(f * (len(values) - 1))]  # noqa: E731
    return {"median": q(0.5), "q75": q(0.75), "q90": q(0.9),
            "worst": [[n, g, ref[key][n] / max(mid, 1e-30)]
                      for g, n in gaps[:top]]}


def _relative_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    if got.shape != want.shape:
        return math.inf
    got, want = got.double(), want.double()
    gap = ((got - want).norm() / want.norm()).item()
    return gap if math.isfinite(gap) else math.inf


def compare_answers(got: Dict[str, torch.Tensor],
                    want: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The three inference numbers of one answer (host tensors of the s0
    depth, the lowest-cost depth and the mask) against the reference's."""
    depth_gap = _relative_l2(got["depth_pred_s0_bhw1"],
                             want["depth_pred_s0_bhw1"])
    lc_got = got["lowest_cost_bhw"].double()
    lc_want = want["lowest_cost_bhw"].double()
    off = (lc_got - lc_want).abs() > 1e-4 * lc_want.abs()
    mask_off = (got["overall_mask_bhw"].bool()
                != want["overall_mask_bhw"].bool()).double().mean().item()
    return {"depth_gap": depth_gap,
            "lowest_cost_off": off.double().mean().item(),
            "mask_off": mask_off}


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """Each number's largest value over `readings`."""
    return {k: max(r[k] for r in readings) for k in readings[0]}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number at or under
    its limit; a number missing or not finite fails."""
    table, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, math.inf)
        good = math.isfinite(value) and value <= limit
        ok = ok and good
        table[name] = {"value": value if math.isfinite(value) else None,
                       "limit": limit}
    return ok, table
