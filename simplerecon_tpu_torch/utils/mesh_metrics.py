"""Mesh reconstruction metrics, TransformerFusion's protocol (counterpart
of `simplerecon_tpu/utils/mesh_metrics.py`): sample N points uniformly by
surface area from each mesh (fixed seed), then

  accuracy  = mean distance pred-sample -> nearest GT sample
  completn. = mean distance GT-sample  -> nearest pred sample
  chamfer   = 0.5 * (accuracy + completeness)
  precision = fraction of pred samples within tau of GT
  recall    = fraction of GT samples within tau of pred
  f1        = 2 * P * R / (P + R)

Distances in meters; tau 5 cm by default. Host work, on scipy's cKDTree.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
from scipy.spatial import cKDTree


def sample_mesh_points(vertices: np.ndarray, faces: np.ndarray,
                       num_points: int = 200_000,
                       seed: int = 0) -> np.ndarray:
    """Area-weighted uniform surface sampling (fixed seed)."""
    rng = np.random.RandomState(seed)
    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64)
    if len(f) == 0:
        return v[rng.randint(0, max(len(v), 1), size=num_points)] \
            if len(v) else np.zeros((0, 3))
    a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    total = areas.sum()
    if total <= 0:
        return v[rng.randint(0, len(v), size=num_points)]
    probs = areas / total
    tri = rng.choice(len(f), size=num_points, p=probs)
    # uniform barycentric sampling
    r1 = np.sqrt(rng.rand(num_points))
    r2 = rng.rand(num_points)
    return ((1 - r1)[:, None] * a[tri] + (r1 * (1 - r2))[:, None] * b[tri]
            + (r1 * r2)[:, None] * c[tri])


def compute_mesh_metrics(pred_points: np.ndarray, gt_points: np.ndarray,
                         threshold: float = 0.05) -> Dict[str, float]:
    """Metrics between two sampled point sets."""
    if len(pred_points) == 0 or len(gt_points) == 0:
        return {k: float("nan") for k in
                ("acc", "comp", "chamfer", "precision", "recall", "f1")}
    gt_tree = cKDTree(gt_points)
    pred_tree = cKDTree(pred_points)
    d_pred_to_gt, _ = gt_tree.query(pred_points, k=1)
    d_gt_to_pred, _ = pred_tree.query(gt_points, k=1)
    acc = float(d_pred_to_gt.mean())
    comp = float(d_gt_to_pred.mean())
    precision = float((d_pred_to_gt < threshold).mean())
    recall = float((d_gt_to_pred < threshold).mean())
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall > 0 else 0.0)
    return {"acc": acc, "comp": comp, "chamfer": 0.5 * (acc + comp),
            "precision": precision, "recall": recall, "f1": f1}


def evaluate_mesh(pred_vertices, pred_faces, gt_vertices, gt_faces,
                  num_points: int = 200_000, threshold: float = 0.05,
                  seed: int = 0,
                  max_dist: Optional[float] = None) -> Dict[str, float]:
    """Full pipeline: sample both meshes, compute metrics."""
    pred_pts = sample_mesh_points(pred_vertices, pred_faces, num_points,
                                  seed)
    gt_pts = sample_mesh_points(gt_vertices, gt_faces, num_points,
                                seed + 1)
    metrics = compute_mesh_metrics(pred_pts, gt_pts, threshold)
    if max_dist is not None:
        metrics = {k: min(v, max_dist) if k in ("acc", "comp", "chamfer")
                   else v for k, v in metrics.items()}
    return metrics
