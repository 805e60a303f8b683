"""TSDF volume and depth integration on the device (counterpart of
`simplerecon_tpu/fusion/tsdf.py`): a dense voxel grid of tensors; each
depth map projects every voxel into the camera at once, takes the
nearest depth sample and applies the InfiniTAM-style weighted update, as
a few elementwise PyTorch operations.

As in the JAX package:
  * dims rounded up to multiples of 8 (`VOX_MOD`);
  * bounds from GT mesh extents + 3 voxels, or given;
  * truncation 3 voxels; confidence `(1 - (d - dmin)/(dmax - dmin))^2`,
    update rate 2 or 5, maximum weight 100;
  * values, weights (and colours) stored in bf16, each update computed
    in float32 and rounded to bf16;
  * the nearest pixel is `round(u - 0.5)` with round-half-to-even, and a
    voxel at z == 0 divides by 1e-8;
  * a batch is integrated frame by frame, in order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from simplerecon_tpu_torch.models.depth_model import resolve_device

VOX_MOD = 8
# voxels per colour update: its float32 (N, 3) temporaries, a few at a
# time, stay under a GiB
COLOR_CHUNK_VOXELS = 16 * 1024 * 1024


def _round_up(x: int, mod: int = VOX_MOD) -> int:
    return int(-(-x // mod) * mod)


@dataclass
class TSDF:
    """A dense TSDF voxel grid on a device.

    `values` in [-1, 1] (truncated, normalised SDF), `weights` >= 0.
    `origin` is the world-space coordinate of voxel (0, 0, 0).
    """
    values: torch.Tensor           # (X, Y, Z)
    weights: torch.Tensor          # (X, Y, Z)
    origin: np.ndarray             # (3,)
    voxel_size: float
    colors: Optional[torch.Tensor] = None  # (X, Y, Z, 3)

    @classmethod
    def from_bounds(cls, bounds_3x2, voxel_size: float,
                    store_dtype=torch.bfloat16, with_color: bool = False,
                    device=None) -> "TSDF":
        """`bounds_3x2[i] = (min_i, max_i)` in meters; on `device`, the
        card unless the caller asks for the CPU (`resolve_device`)."""
        device = resolve_device(device)
        bounds = np.asarray(bounds_3x2, np.float64)
        extents = bounds[:, 1] - bounds[:, 0]
        dims = [_round_up(int(np.ceil(e / voxel_size))) for e in extents]
        values = torch.ones(dims, dtype=store_dtype, device=device)
        weights = torch.zeros(dims, dtype=store_dtype, device=device)
        colors = (torch.zeros(dims + [3], dtype=store_dtype, device=device)
                  if with_color else None)
        return cls(values=values, weights=weights,
                   origin=bounds[:, 0].astype(np.float32),
                   voxel_size=float(voxel_size), colors=colors)

    @classmethod
    def from_mesh(cls, vertices_n3, voxel_size: float, **kw) -> "TSDF":
        """Bounds from mesh extents padded by 3 voxels."""
        v = np.asarray(vertices_n3, np.float64)
        pad = 3 * voxel_size
        bounds = np.stack([v.min(0) - pad, v.max(0) + pad], axis=1)
        return cls.from_bounds(bounds, voxel_size, **kw)

    @property
    def dims(self) -> Tuple[int, int, int]:
        return tuple(self.values.shape)

    def voxel_coords_world(self) -> torch.Tensor:
        """(N, 3) float32 world-space voxel centres, N = X*Y*Z."""
        device = self.values.device
        axes = [torch.arange(n, device=device) for n in self.dims]
        grid = torch.stack(torch.meshgrid(*axes, indexing="ij"),
                           dim=-1).reshape(-1, 3)
        origin = torch.from_numpy(self.origin).to(device)
        return grid.float() * self.voxel_size + origin

    def to_numpy(self) -> Tuple[np.ndarray, np.ndarray]:
        return (self.values.float().cpu().numpy(),
                self.weights.float().cpu().numpy())

    def to_mesh(self, scale_to_world: bool = True,
                return_colors: bool = False):
        """The zero isosurface by the native marching cubes: (vertices
        (V,3) float32, faces (F,3) int32) and, with `return_colors`, the
        vertices' colours (V,3) in [0,1] sampled trilinearly from the
        colour grid (None if the volume has none)."""
        from simplerecon_tpu_torch.fusion import mesh as mesh_lib
        values, weights = self.to_numpy()
        # unobserved voxels make no geometry
        masked = np.where(weights > 0, values, np.nan)
        verts, faces = mesh_lib.marching_cubes(masked, level=0.0)
        vert_colors = None
        if return_colors and self.colors is not None:
            grid = self.colors.float().cpu().numpy()   # (X, Y, Z, 3)
            vert_colors = _trilinear_sample(grid, verts)
        if scale_to_world:
            verts = verts * self.voxel_size + self.origin[None]
        verts = verts.astype(np.float32)
        if return_colors:
            return verts, faces, vert_colors
        return verts, faces


def _trilinear_sample(grid_xyz3: np.ndarray, pts_v3: np.ndarray
                      ) -> np.ndarray:
    """Trilinear interpolation of a (X, Y, Z, C) grid at (V, 3) points in
    voxel coordinates (host-side, for mesh vertex colours)."""
    dims = np.asarray(grid_xyz3.shape[:3])
    p = np.clip(pts_v3, 0.0, (dims - 1).astype(np.float64) - 1e-6)
    p0 = np.floor(p).astype(np.int64)
    f = (p - p0).astype(np.float32)
    out = np.zeros((len(pts_v3), grid_xyz3.shape[-1]), np.float32)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                wx = f[:, 0] if dx else 1.0 - f[:, 0]
                wy = f[:, 1] if dy else 1.0 - f[:, 1]
                wz = f[:, 2] if dz else 1.0 - f[:, 2]
                ix = np.minimum(p0[:, 0] + dx, dims[0] - 1)
                iy = np.minimum(p0[:, 1] + dy, dims[1] - 1)
                iz = np.minimum(p0[:, 2] + dz, dims[2] - 1)
                out += (wx * wy * wz)[:, None] * grid_xyz3[ix, iy, iz]
    return out


def _projective_update(values, weights, world_coords_N3, depth_hw,
                       cam_T_world_44, K_44, truncation: float,
                       min_depth: float, max_depth: float,
                       max_weight: float):
    """The projective TSDF update of the flat voxels `values`, `weights`
    (N,): returns the fused values and weights (float32), and the sample
    indices, new-sample weights, old weights and their sums that the
    colour update reuses."""
    h, w = depth_hw.shape
    # project voxel centres into the camera
    cam = (cam_T_world_44[:3, :3] @ world_coords_N3.T
           + cam_T_world_44[:3, 3:4])                    # (3, N)
    pix = K_44[:3, :3] @ cam
    z = pix[2]
    z_safe = torch.where(z == 0, 1e-8, z)
    u = pix[0] / z_safe
    v = pix[1] / z_safe

    # nearest-neighbour depth lookup; torch.round rounds half to even
    ui = torch.round(u - 0.5).to(torch.int32)
    vi = torch.round(v - 0.5).to(torch.int32)
    inside = (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h) & (z > 0)
    ui_c = ui.clamp(0, w - 1).long()
    vi_c = vi.clamp(0, h - 1).long()
    sampled = depth_hw[vi_c, ui_c]

    valid_depth = ((sampled > min_depth) & (sampled < max_depth)
                   & torch.isfinite(sampled))
    sdf = sampled - z                                     # meters
    valid = inside & valid_depth & (sdf > -truncation)

    tsdf_new = torch.clamp(sdf / truncation, -1.0, 1.0)

    # InfiniTAM-style confidence and adaptive update rate
    conf = (1.0 - torch.clamp((sampled - min_depth) / (max_depth - min_depth),
                              0.0, 1.0)) ** 2
    update_rate = torch.where(conf < 0.5, 2.0, 5.0)
    w_new = torch.where(valid, update_rate * conf, 0.0)

    old_v = values.float()
    old_w = weights.float()
    denom = old_w + w_new
    positive = denom > 0
    fused = torch.where(
        positive,
        (old_v * old_w + tsdf_new * w_new) / torch.where(positive, denom, 1.0),
        old_v)
    new_w = torch.clamp(denom, max=max_weight)
    return fused, new_w, ui_c, vi_c, w_new, old_w, denom


class TSDFFuser:
    """Depth-map fuser over a `TSDF`."""

    def __init__(self, tsdf: TSDF, min_depth: float = 0.5,
                 max_depth: float = 3.0, use_gt_depth: bool = False):
        self.tsdf = tsdf
        self.min_depth = float(min_depth)
        self.max_depth = float(max_depth)
        self.use_gt_depth = use_gt_depth
        self.truncation = 3.0 * tsdf.voxel_size
        # voxel centres, computed once, on the volume's device
        self._coords = self.tsdf.voxel_coords_world()

    @torch.no_grad()
    def integrate_depth(self, depth_b1hw, cam_T_world_b44, K_b44,
                        color_b3hw=None):
        """Integrates a batch of depth maps in order (the update depends on
        the order). When the volume has a colour grid and `color_b3hw`
        ([0,1] RGB) is given, colours are fused with the same weights."""
        device = self.tsdf.values.device
        depth = torch.as_tensor(depth_b1hw, device=device).float()
        if depth.ndim == 4:
            depth = depth[:, 0]
        cam_T_world_b44 = torch.as_tensor(cam_T_world_b44, device=device
                                          ).float()
        K_b44 = torch.as_tensor(K_b44, device=device).float()
        with_color = color_b3hw is not None and self.tsdf.colors is not None
        if with_color:
            color_b3hw = torch.as_tensor(color_b3hw, device=device).float()
        values = self.tsdf.values.reshape(-1)
        weights = self.tsdf.weights.reshape(-1)
        colors = (self.tsdf.colors.reshape(-1, 3) if with_color else None)
        n = values.numel()
        chunk = COLOR_CHUNK_VOXELS if with_color else n
        for i in range(depth.shape[0]):
            for start in range(0, n, chunk):
                part = slice(start, start + chunk)
                fused, new_w, ui_c, vi_c, w_new, old_w, denom = \
                    _projective_update(
                        values[part], weights[part], self._coords[part],
                        depth[i], cam_T_world_b44[i], K_b44[i],
                        self.truncation, self.min_depth, self.max_depth,
                        100.0)
                if with_color:
                    c_new = color_b3hw[i][:, vi_c, ui_c].T      # (N, 3)
                    old_c = colors[part].float()
                    positive = (denom > 0)[:, None]
                    fused_c = torch.where(
                        positive,
                        (old_c * old_w[:, None] + c_new * w_new[:, None])
                        / torch.where(positive, denom[:, None], 1.0),
                        old_c)
                    colors[part] = fused_c.to(colors.dtype)
                values[part] = fused.to(values.dtype)
                weights[part] = new_w.to(weights.dtype)
        return self.tsdf
