"""Camera geometry (counterpart of `simplerecon_tpu/ops/geometry.py`).

Same numerics and layouts as the JAX functions: point sets are
(..., N, 3), 4x4 matrices act on column vectors, pixel centres carry the
+0.5 offset, and the homogeneous divide is the eps-safe one. Callers keep
these in float32.
"""

from __future__ import annotations

import numpy as np
import torch

from simplerecon_tpu_torch.ops import image as image_ops


def pixel_grid(height: int, width: int, device=None) -> torch.Tensor:
    """(h*w, 3) float32 homogeneous pixel centres (x+0.5, y+0.5, 1),
    row-major over (y, x)."""
    ys, xs = torch.meshgrid(
        torch.arange(height, device=device, dtype=torch.float32) + 0.5,
        torch.arange(width, device=device, dtype=torch.float32) + 0.5,
        indexing="ij")
    grid = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)
    return grid.reshape(height * width, 3)


def backproject_depth(depth_bhw: torch.Tensor, invK_b44: torch.Tensor
                      ) -> torch.Tensor:
    """Camera-frame points of a depth map: (b, h*w, 3), row-major over
    (y, x); NaN depths give NaN points."""
    b, h, w = depth_bhw.shape
    grid_N3 = pixel_grid(h, w, device=depth_bhw.device).to(depth_bhw.dtype)
    rays_bN3 = grid_N3 @ invK_b44[:, :3, :3].transpose(1, 2)
    return rays_bN3 * depth_bhw.reshape(b, h * w, 1)


def transform_points(M_b44: torch.Tensor, points_bN3: torch.Tensor
                     ) -> torch.Tensor:
    """Applies a 4x4 transform to (..., N, 3) points."""
    return (torch.matmul(points_bN3, M_b44[..., :3, :3].transpose(-1, -2))
            + M_b44[..., None, :3, 3])


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


def normals_from_depth(depth_bhw: torch.Tensor, invK_b44: torch.Tensor,
                       smoothing_kernel_size: int = 5,
                       smoothing_kernel_std: float = 2.0) -> torch.Tensor:
    """Unit normals (b, h, w, 3) of a depth map: gaussian blur,
    backproject, Sobel gradients of the point map, cross product,
    normalise. NaN depths spread NaN through the blur and the gradients."""
    b, h, w = depth_bhw.shape
    depth_smooth = image_ops.gaussian_blur(
        depth_bhw[..., None], kernel_size=smoothing_kernel_size,
        sigma=smoothing_kernel_std)[..., 0]
    points_bhw3 = backproject_depth(depth_smooth, invK_b44).reshape(b, h, w, 3)
    grads = image_ops.spatial_gradient(points_bhw3)     # (b, h, w, 3, 2)
    normals = torch.linalg.cross(grads[..., 0], grads[..., 1], dim=-1)
    return normalize(normals, dim=-1)


def qvec2rotmat(qvec) -> np.ndarray:
    """Quaternion (w, x, y, z) to a 3x3 rotation matrix (numpy, for host
    pose wrangling)."""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y ** 2 - 2 * z ** 2, 2 * x * y - 2 * w * z, 2 * z * x + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x ** 2 - 2 * z ** 2, 2 * y * z - 2 * w * x],
        [2 * z * x - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x ** 2 - 2 * y ** 2],
    ])


def rotx(t: float) -> np.ndarray:
    """Rotation by t about x (numpy)."""
    c, s = np.cos(t), np.sin(t)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
