"""Camera geometry (counterpart of `simplerecon_tpu/ops/geometry.py`).

Same numerics and layouts as the JAX functions: point sets are
(..., N, 3), 4x4 matrices act on column vectors, pixel centres carry the
+0.5 offset, and the homogeneous divide is the eps-safe one. Callers keep
these in float32.
"""

from __future__ import annotations

import torch


def pixel_grid(height: int, width: int, device=None) -> torch.Tensor:
    """(h*w, 3) float32 homogeneous pixel centres (x+0.5, y+0.5, 1),
    row-major over (y, x)."""
    ys, xs = torch.meshgrid(
        torch.arange(height, device=device, dtype=torch.float32) + 0.5,
        torch.arange(width, device=device, dtype=torch.float32) + 0.5,
        indexing="ij")
    grid = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)
    return grid.reshape(height * width, 3)


def project_points(points_bN3: torch.Tensor, K_b44: torch.Tensor,
                   cam_T_world_b44: torch.Tensor, eps: float = 1e-8
                   ) -> torch.Tensor:
    """Projects (..., N, 3) points with P = K @ cam_T_world.

    Pixels are divided by z' = z + eps only where |z| > eps; the returned
    depth channel is z + eps. Returns (..., N, 3) = (u, v, z + eps) in
    pixel units.
    """
    P = torch.matmul(K_b44, cam_T_world_b44)
    cam = (torch.matmul(points_bN3, P[..., :3, :3].transpose(-1, -2))
           + P[..., None, :3, 3])
    z = cam[..., 2:3]
    z_eps = z + eps
    scale = torch.where(z.abs() > eps, 1.0 / z_eps, torch.ones_like(z_eps))
    return torch.cat([cam[..., :2] * scale, z_eps], dim=-1)


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-12
              ) -> torch.Tensor:
    """v / max(||v||, eps), with the JAX version's 1e-30 inside the sqrt."""
    n = torch.sqrt(torch.sum(v * v, dim=dim, keepdim=True) + 1e-30)
    return v / torch.clamp(n, min=eps)


def pose_distance(pose_b44: torch.Tensor):
    """DVMVS pose distance. Returns (combined, R_measure, t_measure).

    The bracket under the R sqrt is clamped at 0: for identity rotations
    it can round to -eps.
    """
    trace = pose_b44[..., 0, 0] + pose_b44[..., 1, 1] + pose_b44[..., 2, 2]
    r_measure = torch.sqrt(torch.clamp(
        2.0 * (1.0 - torch.clamp(trace, max=3.0) / 3.0), min=0.0))
    t_measure = torch.linalg.vector_norm(pose_b44[..., :3, 3], dim=-1)
    combined = torch.sqrt(t_measure ** 2 + r_measure ** 2)
    return combined, r_measure, t_measure


def cosine_similarity(a: torch.Tensor, b: torch.Tensor, dim: int = -1,
                      eps: float = 1e-5) -> torch.Tensor:
    """Dot product over `dim` divided by the product of the two norms,
    each clamped below at eps."""
    dot = torch.sum(a * b, dim=dim)
    na = torch.clamp(torch.linalg.vector_norm(a, dim=dim), min=eps)
    nb = torch.clamp(torch.linalg.vector_norm(b, dim=dim), min=eps)
    return dot / (na * nb)
