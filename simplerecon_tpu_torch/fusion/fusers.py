"""Fuser façade (counterpart of `simplerecon_tpu/fusion/fusers.py`):
`get_fuser(opts, ...)` returns a `DepthFuser` with the common
`fuse_frames(depths, K, cam_T_world, color)` / `export_mesh(path)` /
`get_mesh()` API over the TSDF of `fusion/tsdf.py`, on a device. The
"ours" and "open3d" fuser names both map onto that TSDF, with colour.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from simplerecon_tpu_torch.fusion.tsdf import TSDF, TSDFFuser
from simplerecon_tpu_torch.ops.image import reverse_imagenet_normalize


def bounds_from_trajectory(world_T_cam_n44,
                           max_fusion_depth: float,
                           invK_44: Optional[np.ndarray] = None,
                           image_hw: Optional[Tuple[int, int]] = None,
                           pad: float = 0.5) -> np.ndarray:
    """Scene bounds (3, 2) from the camera trajectory.

    Everything a fuser can integrate lies inside some camera's frustum
    truncated at `max_fusion_depth`, so the union of those frustums (plus
    `pad` meters) bounds the scene. With intrinsics the frustum is exact:
    the four image-corner rays at the truncation depth and the camera
    centre. Without, a box of half-width 2 * max_fusion_depth around each
    camera.
    """
    poses = np.asarray(world_T_cam_n44, np.float64).reshape(-1, 4, 4)
    centers = poses[:, :3, 3]                               # (n, 3)
    if invK_44 is not None and image_hw is not None:
        h, w = image_hw
        corners = np.array([[0.0, 0.0, 1.0], [w, 0.0, 1.0],
                            [0.0, h, 1.0], [w, h, 1.0]]).T  # (3, 4)
        rays = np.asarray(invK_44, np.float64)[:3, :3] @ corners
        far = np.einsum("nij,jc->nci", poses[:, :3, :3],
                        rays * max_fusion_depth) + centers[:, None]
        pts = np.concatenate([centers, far.reshape(-1, 3)], axis=0)
        lo, hi = pts.min(0), pts.max(0)
    else:
        r = 2.0 * max_fusion_depth
        lo, hi = centers.min(0) - r, centers.max(0) + r
    return np.stack([lo - pad, hi + pad], axis=1).astype(np.float32)


def _linear_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    """(in_size, out_size) weights of a linear resize along one axis, as
    `jax.image.resize(..., "bilinear")` (antialiased) builds them: a
    triangle kernel, widened by in/out when shrinking, normalised over the
    inputs, zero where the sample lies outside the input."""
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    f32 = torch.float32
    sample = ((torch.arange(out_size, dtype=f32, device=device) + 0.5)
              * inv_scale - 0.5)
    x = (sample[None, :] - torch.arange(in_size, dtype=f32, device=device
                                        )[:, None]).abs() / kernel_scale
    weights = torch.clamp(1.0 - x.abs(), min=0.0)
    total = weights.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    weights = torch.where(total.abs() > eps,
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def resize_bilinear(image_bchw: torch.Tensor, h: int, w: int
                    ) -> torch.Tensor:
    """Bilinear resize of the last two axes to (h, w), antialiased when
    shrinking, as `jax.image.resize(..., method="bilinear")`."""
    out = image_bchw.float()
    if out.shape[-2] != h:
        out = torch.einsum("...yx,yY->...Yx", out,
                           _linear_weights(out.shape[-2], h, out.device))
    if out.shape[-1] != w:
        out = torch.einsum("...yx,xX->...yX", out,
                           _linear_weights(out.shape[-1], w, out.device))
    return out


class DepthFuser:
    """Common fuser API."""

    def __init__(self, gt_path: str = "", fusion_resolution: float = 0.04,
                 max_fusion_depth: float = 3.0, fuse_color: bool = False):
        self.gt_path = gt_path
        self.fusion_resolution = fusion_resolution
        self.max_fusion_depth = max_fusion_depth
        self.fuse_color = fuse_color

    def fuse_frames(self, depths_b1hw, K_b44, cam_T_world_b44, color_b3hw):
        raise NotImplementedError

    def export_mesh(self, path: str):
        raise NotImplementedError

    def get_mesh(self):
        raise NotImplementedError


class OurFuser(DepthFuser):
    """The paper's TSDF fuser: a dense bf16 grid on `device` (the card
    unless the caller asks for the CPU), bounded by the GT mesh when there
    is one, else by the given bounds, else by the trajectory, else by a
    +-10 m box."""

    def __init__(self, gt_path: str = "",
                 fusion_resolution: float = 0.04,
                 max_fusion_depth: float = 3.0,
                 fuse_color: bool = False,
                 bounds_3x2: Optional[np.ndarray] = None,
                 trajectory_world_T_cam: Optional[np.ndarray] = None,
                 device=None):
        super().__init__(gt_path, fusion_resolution, max_fusion_depth,
                         fuse_color)
        kw = dict(with_color=fuse_color, device=device)
        if bounds_3x2 is None and gt_path:
            from simplerecon_tpu_torch.fusion.mesh import read_ply
            verts, _ = read_ply(gt_path)
            tsdf = TSDF.from_mesh(verts, fusion_resolution, **kw)
        elif bounds_3x2 is not None:
            tsdf = TSDF.from_bounds(bounds_3x2, fusion_resolution, **kw)
        elif trajectory_world_T_cam is not None:
            tsdf = TSDF.from_bounds(
                bounds_from_trajectory(trajectory_world_T_cam,
                                       max_fusion_depth),
                fusion_resolution, **kw)
        else:
            tsdf = TSDF.from_bounds(np.array([[-10.0, 10.0]] * 3),
                                    fusion_resolution, **kw)
        self.fuser = TSDFFuser(tsdf, max_depth=max_fusion_depth)

    def fuse_frames(self, depths_b1hw, K_b44, cam_T_world_b44,
                    color_b3hw=None):
        """Integrates depth (and RGB when colour fusion is on). The colour
        arrives imagenet-normalised at any resolution; it is resized to
        the depth's and un-normalised to [0, 1] here."""
        device = self.fuser.tsdf.values.device
        depth = torch.as_tensor(depths_b1hw, device=device).float()
        if not self.fuse_color:
            color_b3hw = None
        elif color_b3hw is not None:
            color = torch.as_tensor(color_b3hw, device=device).float()
            h, w = depth.shape[-2:]
            if tuple(color.shape[-2:]) != (h, w):
                color = resize_bilinear(color, h, w)
            color_b3hw = torch.clamp(
                reverse_imagenet_normalize(color.permute(0, 2, 3, 1)
                                           ).permute(0, 3, 1, 2), 0.0, 1.0)
        self.fuser.integrate_depth(depth, cam_T_world_b44, K_b44,
                                   color_b3hw=color_b3hw)

    def get_mesh(self, include_colors: bool = False):
        """(verts, faces) or, with `include_colors`, (verts, faces,
        colors-or-None)."""
        if include_colors:
            return self.fuser.tsdf.to_mesh(return_colors=True)
        return self.fuser.tsdf.to_mesh()

    def export_mesh(self, path: str):
        from simplerecon_tpu_torch.fusion.mesh import write_ply
        if self.fuse_color:
            verts, faces, colors = self.get_mesh(include_colors=True)
            write_ply(path, verts, faces, colors=colors)
        else:
            verts, faces = self.get_mesh()
            write_ply(path, verts, faces)
        return path


def get_fuser(opts, scan_gt_path: str = "",
              bounds_3x2: Optional[np.ndarray] = None,
              trajectory_world_T_cam: Optional[np.ndarray] = None,
              device=None) -> DepthFuser:
    """The fuser that `opts.depth_fuser` names, on `device` (the card
    unless the caller asks for the CPU)."""
    if opts.depth_fuser in ("ours", "open3d"):
        return OurFuser(
            gt_path=scan_gt_path,
            fusion_resolution=opts.fusion_resolution,
            max_fusion_depth=opts.fusion_max_depth,
            fuse_color=opts.fuse_color,
            bounds_3x2=bounds_3x2,
            trajectory_world_T_cam=trajectory_world_T_cam,
            device=device)
    raise ValueError(f"unknown depth fuser {opts.depth_fuser!r}")
