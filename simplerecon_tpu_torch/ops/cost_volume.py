"""Plane-sweep primitives (counterpart of
`simplerecon_tpu/ops/cost_volume.py`).

Only the gather form of the warp is ported: the JAX package's matmul
warp, its fused scan and their hand-written VJP are TPU formulations of
the same math. Shapes: b batch, k source views, d depth planes (or a
chunk of them), N = h*w reference pixels, c feature channels.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from simplerecon_tpu_torch.ops import geometry as geo
from simplerecon_tpu_torch.ops.sampling import grid_sample


def generate_depth_planes(batch_size: int, num_depth_bins: int,
                          min_depth: float, max_depth: float,
                          device=None) -> torch.Tensor:
    """(b, d) log-spaced float32 plane depths, the same for every pixel."""
    ramp = torch.linspace(0.0, 1.0, num_depth_bins, dtype=torch.float32,
                          device=device)
    min_d = torch.tensor(min_depth, dtype=torch.float32, device=device)
    max_d = torch.tensor(max_depth, dtype=torch.float32, device=device)
    planes = torch.exp(torch.log(min_d) + torch.log(max_d / min_d) * ramp)
    return planes[None].expand(batch_size, num_depth_bins)


class SweepWarp(NamedTuple):
    """Per-plane warp products for one chunk of depth planes."""
    world_points_bdN3: torch.Tensor   # reference-camera-frame points, fp32
    sampled_bkdNc: torch.Tensor       # warped source features
    depths_bkdN: torch.Tensor         # projected depth in each source view
    mask_bkdN: torch.Tensor           # z > 0, in the feature dtype
    pix_bkdN2: torch.Tensor           # raw pixel coords in each source view


def sweep_warp(src_feats_bkhwc: torch.Tensor,
               src_extrinsics_bk44: torch.Tensor,
               src_Ks_bk44: torch.Tensor,
               cur_invK_b44: torch.Tensor,
               depth_planes_bd: torch.Tensor) -> SweepWarp:
    """Warps every source view to the reference view at each plane
    (the JAX `sweep_warp(..., backend="gather")`).

    src_extrinsics are src_cam_T_cur_cam; geometry runs in float32 and
    sampling in the feature dtype.
    """
    b, k, h, w, c = src_feats_bkhwc.shape
    d = depth_planes_bd.shape[1]
    n = h * w
    f32 = torch.float32

    grid_N3 = geo.pixel_grid(h, w, device=src_feats_bkhwc.device)
    rays_bN3 = grid_N3 @ cur_invK_b44[:, :3, :3].to(f32).transpose(1, 2)
    world_bdN3 = rays_bN3[:, None] * depth_planes_bd[..., None, None]

    uvz_bkdN3 = geo.project_points(
        world_bdN3[:, None],
        src_Ks_bk44[:, :, None].to(f32),
        src_extrinsics_bk44[:, :, None].to(f32))
    pix_bkdN2 = uvz_bkdN3[..., :2]
    depths_bkdN = uvz_bkdN3[..., 2]

    scale = torch.tensor([2.0 / w, 2.0 / h], dtype=f32,
                         device=pix_bkdN2.device)
    grid_bkdN2 = pix_bkdN2 * scale - 1.0
    sampled = grid_sample(
        src_feats_bkhwc.reshape(b * k, h, w, c),
        grid_bkdN2.reshape(b * k, d * n, 2)).reshape(b, k, d, n, c)

    mask_bkdN = (depths_bkdN > 0).to(src_feats_bkhwc.dtype)
    return SweepWarp(world_bdN3, sampled, depths_bkdN, mask_bkdN, pix_bkdN2)


def border_validity_mask(pix_bkN2: torch.Tensor, height: int, width: int
                         ) -> torch.Tensor:
    """True strictly inside a 2-pixel border. Returns bool (b, k, N)."""
    x, y = pix_bkN2[..., 0], pix_bkN2[..., 1]
    return (x > 2) & (x < width - 2) & (y > 2) & (y < height - 2)


def overall_source_mask(warp_last_plane: SweepWarp, height: int, width: int
                        ) -> torch.Tensor:
    """True where any source view sees the farthest plane in front of it
    and any view lands inside the border. Returns bool (b, N)."""
    depth_mask = torch.any(warp_last_plane.mask_bkdN[:, :, -1] > 0, dim=1)
    bounds = torch.any(border_validity_mask(
        warp_last_plane.pix_bkdN2[:, :, -1], height, width), dim=1)
    return depth_mask & bounds


def lowest_cost_depth(cost_volume_bhwd: torch.Tensor,
                      depth_planes_bd: torch.Tensor) -> torch.Tensor:
    """Plane depth of the highest score at each pixel. Returns (b, h, w)."""
    idx = torch.argmax(cost_volume_bhwd, dim=-1)
    b = idx.shape[0]
    return torch.gather(depth_planes_bd, 1,
                        idx.reshape(b, -1)).reshape(idx.shape)
