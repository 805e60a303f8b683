"""Multi-view-consistency point-cloud fusion (counterpart of
`simplerecon_tpu/fusion/point_cloud.py`).

For each reference frame: backproject its depth map to world points,
reproject them into every other frame, and keep the points whose
reprojected depth agrees with the depth sampled there (|z - sampled| <
`z_thresh`) in at least `n_consistent` other frames. A kept point is the
mean of itself and the world points of its consistent samples. The cloud
of all frames is then averaged per voxel.

The consistency test of one reference frame against all frames runs on
the device as a few elementwise launches (the JAX package `vmap`s it
over the frames). Its 4x4 products are written out as float32 sums, so
that no TF32 matmul moves the |z - sampled| test near its edge. The
voxel mean stays on the host in numpy, as in the JAX package, and gives
its bits for the same points.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def _matmul44(a_f44: torch.Tensor, b_f44: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) @ (..., 4, 4) as float32 sums over k in order."""
    out = a_f44[..., :, 0:1] * b_f44[..., 0:1, :]
    for k in range(1, 4):
        out = out + a_f44[..., :, k:k + 1] * b_f44[..., k:k + 1, :]
    return out


def _apply(m_f44: torch.Tensor, x_fN: list, rows: int) -> list:
    """The first `rows` rows of M @ x for column vectors x given as a
    list of (f, N) components (3 or 4 of them), as sums in order;
    M is (f, 4, 4)."""
    out = []
    for i in range(rows):
        acc = m_f44[:, i, 0:1] * x_fN[0]
        for j in range(1, len(x_fN)):
            acc = acc + m_f44[:, i, j:j + 1] * x_fN[j]
        out.append(acc)
    return out


def consistency_pass(depths_fhw: torch.Tensor, world_T_cam_f44: torch.Tensor,
                     cam_T_world_f44: torch.Tensor, K_f44: torch.Tensor,
                     invK_f44: torch.Tensor, ref_index: int,
                     z_thresh: float = 0.04, n_consistent: int = 3
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The consistency test of frame `ref_index` against all frames, on
    the tensors' device, in float32.

    Returns (points (N, 3): each reference pixel's world point averaged
    with its consistent samples, keep (N,) bool, count (N,) int32: the
    other frames that agree).
    """
    f, h, w = depths_fhw.shape
    device = depths_fhw.device
    ref_depth = depths_fhw[ref_index].reshape(1, -1)                # (1, N)
    ys, xs = torch.meshgrid(
        torch.arange(h, device=device, dtype=torch.float32) + 0.5,
        torch.arange(w, device=device, dtype=torch.float32) + 0.5,
        indexing="ij")
    pix = [xs.reshape(1, -1), ys.reshape(1, -1)]
    rays = [(invK_f44[ref_index:ref_index + 1, i, 0:1] * pix[0]
             + invK_f44[ref_index:ref_index + 1, i, 1:2] * pix[1])
            + invK_f44[ref_index:ref_index + 1, i, 2:3]
            for i in range(3)]
    pts_cam = [r * ref_depth for r in rays]
    c2w_ref = world_T_cam_f44[ref_index:ref_index + 1]
    pts_world = [p + c2w_ref[:, i, 3:4] for i, p in
                 enumerate(_apply(c2w_ref, pts_cam, 3))]            # (1, N)

    # project into every frame: P = K @ cam_T_world, (u, v, z + eps)
    P = _matmul44(K_f44, cam_T_world_f44)
    cam = [c + P[:, i, 3:4] for i, c in
           enumerate(_apply(P, pts_world, 3))]                      # (f, N)
    eps = 1e-8
    z = cam[2] + eps
    scale = torch.where(cam[2].abs() > eps, 1.0 / z, torch.ones_like(z))
    u, v = cam[0] * scale, cam[1] * scale
    # round half to even, as jnp.round
    ui = torch.nan_to_num(torch.round(u - 0.5), nan=0.0).clamp(0, w - 1)
    vi = torch.nan_to_num(torch.round(v - 0.5), nan=0.0).clamp(0, h - 1)
    inside = (u >= 0) & (u < w) & (v >= 0) & (v < h) & (z > 0)
    frames = torch.arange(f, device=device)[:, None]
    sampled = depths_fhw[frames, vi.long(), ui.long()]
    ok = (inside & torch.isfinite(sampled) & (sampled > 0)
          & ((z - sampled).abs() < z_thresh))

    # the world point of the sampled depth at the reprojected pixel
    z_s = torch.where(ok, sampled, torch.zeros_like(sampled))
    pix_h = [u * z_s, v * z_s, z_s, torch.ones_like(z_s)]
    cam_pt = _apply(invK_f44, pix_h, 3) + [torch.ones_like(z_s)]
    world_pt = _apply(world_T_cam_f44, cam_pt, 3)
    world_pt = torch.stack(world_pt, dim=-1)                        # (f,N,3)
    ok = ok & torch.isfinite(world_pt).all(dim=-1)
    world_pt = torch.where(ok[..., None], world_pt,
                           torch.zeros_like(world_pt))

    # the reference frame's own match is not counted
    ok = ok & (frames != ref_index)
    count = ok.to(torch.int32).sum(dim=0)
    ref_depth = ref_depth[0]
    keep = (count >= n_consistent) & torch.isfinite(ref_depth) \
        & (ref_depth > 0)
    sums = (world_pt * ok[..., None]).sum(dim=0)
    pts = torch.stack([p[0] for p in pts_world], dim=-1)
    pts_avg = (pts + sums) / (count[:, None].to(torch.float32) + 1.0)
    return pts_avg, keep, count


def voxel_downsample(points_N3: np.ndarray, voxel: float,
                     colors_N3: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Mean position (and colour) per occupied voxel, on the host."""
    if len(points_N3) == 0:
        return points_N3, colors_N3
    keys = np.floor(points_N3 / voxel).astype(np.int64)
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True,
                               return_counts=True)
    sums = np.zeros((counts.shape[0], 3), np.float64)
    np.add.at(sums, inv, points_N3)
    out = (sums / counts[:, None]).astype(np.float32)
    out_colors = None
    if colors_N3 is not None:
        csums = np.zeros((counts.shape[0], 3), np.float64)
        np.add.at(csums, inv, colors_N3)
        out_colors = (csums / counts[:, None]).astype(np.float32)
    return out, out_colors


def fuse_points(depths_fhw: np.ndarray, world_T_cam_f44: np.ndarray,
                K_f44: np.ndarray, invK_f44: np.ndarray,
                z_thresh: float = 0.04, n_consistent: int = 3,
                device=None, timings: Optional[list] = None):
    """Every frame's consistency pass on `device`: a list of (points,
    keep) numpy pairs, one a reference frame, before the voxel mean.
    With `timings` (a list) and a CUDA device, each pass's CUDA-event ms
    is appended to it."""
    from simplerecon_tpu_torch.models.depth_model import resolve_device
    device = resolve_device(device)
    f32 = torch.float32
    depths = torch.as_tensor(np.nan_to_num(depths_fhw, nan=0.0),
                             dtype=f32).to(device)
    w2c = np.stack([np.linalg.inv(p) for p in world_T_cam_f44])
    c2w, w2c, K, invK = (torch.as_tensor(np.asarray(a), dtype=f32).to(device)
                         for a in (world_T_cam_f44, w2c, K_f44, invK_f44))
    timed = timings is not None and device.type == "cuda"
    out = []
    for ref in range(depths.shape[0]):
        if timed:
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            events[0].record()
        pts, keep, _ = consistency_pass(depths, c2w, w2c, K, invK, ref,
                                        z_thresh=z_thresh,
                                        n_consistent=n_consistent)
        if timed:
            events[1].record()
        out.append((pts.cpu().numpy(), keep.cpu().numpy()))
        if timed:
            timings.append(events[0].elapsed_time(events[1]))
    return out


def process_scene(depths_fhw: np.ndarray, world_T_cam_f44: np.ndarray,
                  K_f44: np.ndarray, invK_f44: np.ndarray,
                  colors_f3hw: Optional[np.ndarray] = None,
                  z_thresh: float = 0.04, n_consistent: int = 3,
                  voxel_downsample_size: float = 0.02, device=None,
                  timings: Optional[list] = None
                  ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Whole-scene fusion: the consistency pass of every frame on
    `device` (the CUDA card unless another is given), then the voxel mean
    on the host. Depths <= 0 or NaN are dropped. `timings`: see
    `fuse_points`.

    Returns (points (M, 3) float32, colours (M, 3) float32 or None).
    """
    passes = fuse_points(depths_fhw, world_T_cam_f44, K_f44, invK_f44,
                         z_thresh=z_thresh, n_consistent=n_consistent,
                         device=device, timings=timings)
    points = [pts[keep] for pts, keep in passes]
    points = (np.concatenate(points, 0) if points
              else np.zeros((0, 3), np.float32))
    colors = None
    if colors_f3hw is not None and passes:
        colors = np.concatenate(
            [colors_f3hw[ref].reshape(3, -1).T[keep]
             for ref, (_, keep) in enumerate(passes)], 0)
    return voxel_downsample(points, voxel_downsample_size, colors)
