"""Depth-eval metrics and results averaging (counterpart of
`simplerecon_tpu/utils/metrics.py`).

  * `compute_depth_metrics_batched`: per-frame abs_diff, abs_rel, sq_rel,
    rmse, rmse_log and the inlier ratios delta < 1.05/1.10/1.25/1.25^2/
    1.25^3/1.25^4, over the masked pixels of tensors on any device.
    Invalid pixels are excluded with an explicit mask; a frame with no
    valid pixel gives NaN, which `ResultsAverager` skips.
  * `ResultsAverager`: running and exact final averages of metric dicts,
    with the JAX package's JSON and print formats.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

METRIC_NAMES = ("abs_diff", "abs_rel", "sq_rel", "rmse", "rmse_log",
                "a5", "a10", "a25", "a0", "a1", "a2", "a3")


def compute_depth_metrics_batched(depth_gt_bhw: torch.Tensor,
                                  depth_pred_bhw: torch.Tensor,
                                  valid_mask_bhw: torch.Tensor,
                                  mult_a: bool = False
                                  ) -> Dict[str, torch.Tensor]:
    """Per-frame depth metrics over masked pixels; (b,) float32 tensors.

    `mult_a=True` gives the inlier ratios in percent. A frame whose mask is
    empty gives NaN. The per-frame sums are taken in float64.
    """
    gt = depth_gt_bhw.float()
    pred = depth_pred_bhw.float()
    mask = valid_mask_bhw.bool() & torch.isfinite(gt) & (gt > 0)
    one = torch.ones((), dtype=torch.float32, device=gt.device)
    gt_safe = torch.where(mask, gt, one)
    pred_safe = torch.where(mask, torch.clamp(pred, min=1e-6), one)

    count = mask.sum(dim=(1, 2)).float()
    empty = count == 0
    denom = torch.clamp(count, min=1.0)

    def fmean(x_bhw):
        s = torch.where(mask, x_bhw, 0.0).sum(dim=(1, 2),
                                              dtype=torch.float64)
        s = s.float() / denom
        return torch.where(empty, torch.nan, s)

    thresh = torch.maximum(gt_safe / pred_safe, pred_safe / gt_safe)
    diff = pred_safe - gt_safe
    log_diff = torch.log(pred_safe) - torch.log(gt_safe)

    scale = 100.0 if mult_a else 1.0

    def ratio(limit):
        return fmean((thresh < limit).float()) * scale

    return {
        "abs_diff": fmean(diff.abs()),
        "abs_rel": fmean(diff.abs() / gt_safe),
        "sq_rel": fmean(diff ** 2 / gt_safe),
        "rmse": torch.sqrt(fmean(diff ** 2)),
        "rmse_log": torch.sqrt(fmean(log_diff ** 2)),
        "a5": ratio(1.05),
        "a10": ratio(1.10),
        "a25": ratio(1.25),
        "a0": ratio(1.25),
        "a1": ratio(1.25 ** 2),
        "a2": ratio(1.25 ** 3),
        "a3": ratio(1.25 ** 4),
    }


def compute_depth_metrics(depth_gt_hw, depth_pred_hw, valid_mask_hw,
                          mult_a: bool = True) -> Dict[str, float]:
    """Single-frame wrapper: one frame's metrics as Python floats."""
    out = compute_depth_metrics_batched(
        torch.as_tensor(depth_gt_hw)[None], torch.as_tensor(depth_pred_hw)[None],
        torch.as_tensor(valid_mask_hw)[None], mult_a=mult_a)
    return {k: float(v[0]) for k, v in out.items()}


class ResultsAverager:
    """Running and exact averaging of metric dicts."""

    def __init__(self, exp_name: str = "", metrics_name: str = ""):
        self.exp_name = exp_name
        self.metrics_name = metrics_name
        self.elem_metrics: List[Dict[str, float]] = []
        self.running_metrics: Optional[Dict[str, float]] = None
        self.running_count = 0
        self.final_metrics: Optional[Dict[str, float]] = None

    def update_results(self, elem_metrics: Dict[str, float]):
        elem = {k: float(v) for k, v in elem_metrics.items()}
        if any(np.isnan(v) for v in elem.values()):
            return  # a frame with no valid pixels
        self.elem_metrics.append(dict(elem))
        if self.running_metrics is None:
            self.running_metrics = dict(elem)
        else:
            for k, v in elem.items():
                self.running_metrics[k] = (
                    self.running_metrics[k] * self.running_count + v
                ) / (self.running_count + 1)
        self.running_count += 1

    def compute_final_average(self, ignore_nans: bool = False
                              ) -> Dict[str, float]:
        self.final_metrics = {}
        if not self.elem_metrics:
            return self.final_metrics
        keys = self.elem_metrics[0].keys()
        for k in keys:
            vals = np.array([e[k] for e in self.elem_metrics], np.float64)
            self.final_metrics[k] = float(
                np.nanmean(vals) if ignore_nans else np.mean(vals))
        return self.final_metrics

    def print_sheets_friendly(self, include_metrics_names: bool = True,
                              print_running_metrics: bool = True):
        metrics = (self.running_metrics if print_running_metrics
                   else self.final_metrics) or {}
        print(f"Results: {self.exp_name}, {self.metrics_name}")
        if include_metrics_names:
            print(",".join(metrics.keys()))
        print(",".join(f"{v:.4f}" for v in metrics.values()))

    def pretty_print_results(self, print_running_metrics: bool = True):
        metrics = (self.running_metrics if print_running_metrics
                   else self.final_metrics) or {}
        print(f"Results: {self.exp_name}, {self.metrics_name}")
        for k, v in metrics.items():
            print(f"{k}: {v:.4f}")

    def output_json(self, filepath: str, print_running_metrics: bool = False):
        metrics = (self.running_metrics if print_running_metrics
                   else self.final_metrics) or {}
        payload = {
            "exp_name": self.exp_name,
            "metrics_type": self.metrics_name,
            "scores": metrics,
        }
        os.makedirs(os.path.dirname(filepath) or ".", exist_ok=True)
        with open(filepath, "w") as f:
            json.dump(payload, f, indent=2)
