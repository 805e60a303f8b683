"""Cost and feature volumes (counterpart of
`simplerecon_tpu/models/cost_volume.py`).

`MLPFeatureVolume` (the hero model) comes, with its default backend
"fused_sweep", from the differentiable fused sweep
(`ops/cuda_cv.py::FusedSweep`: the CUDA kernels K1 forward and K2
backward on the card, their plain versions on the CPU). The float32 MLP
weights go in as they are and are cast to the compute dtype inside, so
their gradients come back in float32. Pose metadata and the
farthest-plane source mask are plain PyTorch in float32 and get no
gradient. Two inference-only backends follow the JAX package's earlier
kernels (`ops/early_sweeps.py`): "pallas_v1" warps with the plain gather
warp in chunks of planes (the JAX 1 GiB rule) and runs K5 on each chunk's
stack; "pallas_full" runs K4 on the c-major source maps. A backward
through either raises.

`DotProductCostVolume` (the dot-product model) comes from
`ops/cuda_cv.py::DotSweep`: the CUDA kernel K1-dot forward on the card
and a plain PyTorch backward.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from simplerecon_tpu_torch.models.layers import MLP
from simplerecon_tpu_torch.ops import cost_volume as cv_ops
from simplerecon_tpu_torch.ops import early_sweeps
from simplerecon_tpu_torch.ops import geometry as geo
from simplerecon_tpu_torch.ops.cuda_cv import (HIDDEN, DotSweep, FusedSweep,
                                               mlp_in_channels)


def source_mask(src_feats_bkhwc, extr_bk44, Ks_bk44, invK_b44, planes_bd,
                h: int, w: int) -> torch.Tensor:
    """The source-visibility mask (b, h, w) bool: only the farthest plane
    matters, so it is a one-channel warp of that plane."""
    warp_last = cv_ops.sweep_warp(src_feats_bkhwc[..., :1], extr_bk44,
                                  Ks_bk44, invK_b44, planes_bd[:, -1:])
    return cv_ops.overall_source_mask(warp_last, h, w).reshape(-1, h, w)


class DotProductCostVolume(nn.Module):
    """Per (pixel, plane), the masked dot products of the warped source
    features with the reference features, summed over source views. No
    parameters.

    Takes and returns what `MLPFeatureVolume` does (`src_poses_bk44` is
    not read): volume (b, h, w, d) float32, lowest-cost depth (b, h, w),
    planes (b, d), overall mask (b, h, w) bool or None.
    """

    def __init__(self, num_depth_bins: int = 64, min_depth: float = 0.25,
                 max_depth: float = 5.0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_depth_bins = num_depth_bins
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.compute_dtype = compute_dtype

    def forward(self, cur_feats_bhwc, src_feats_bkhwc, src_extrinsics_bk44,
                src_poses_bk44, src_Ks_bk44, cur_invK_b44,
                return_mask: bool = False):
        b, h, w, c = cur_feats_bhwc.shape
        d = self.num_depth_bins
        cdt = self.compute_dtype
        f32 = torch.float32
        planes_bd = cv_ops.generate_depth_planes(
            b, d, self.min_depth, self.max_depth,
            device=cur_feats_bhwc.device).contiguous()
        extr = src_extrinsics_bk44.to(f32).contiguous()
        Ks = src_Ks_bk44.to(f32).contiguous()
        invK = cur_invK_b44.to(f32).contiguous()
        volume_bdN = DotSweep.apply(
            src_feats_bkhwc.to(cdt).contiguous(),
            cur_feats_bhwc.reshape(b, h * w, c).to(cdt).contiguous(),
            extr, Ks, invK, planes_bd)
        volume_bhwd = volume_bdN.transpose(1, 2).reshape(b, h, w, d)
        lowest = cv_ops.lowest_cost_depth(volume_bhwd.detach(), planes_bd)
        overall = (source_mask(src_feats_bkhwc, extr, Ks, invK, planes_bd,
                               h, w) if return_mask else None)
        return volume_bhwd, lowest, planes_bd, overall


class MLPFeatureVolume(nn.Module):
    """Per (pixel, plane), an MLP reduces the warped source features,
    the reference features and geometric metadata to a matching score.

    Takes the JAX layout: reference features (b, h, w, c), source
    features (b, k, h, w, c), src_cam_T_cur_cam extrinsics and
    cur_cam_T_src_cam poses (b, k, 4, 4), source intrinsics (b, k, 4, 4)
    and reference inverse intrinsics (b, 4, 4). Returns (volume (b, h, w,
    d) float32, lowest-cost depth (b, h, w), planes (b, d), overall mask
    (b, h, w) bool or None). `backend` is "fused_sweep" (K1, K2),
    "pallas_v1" (warp, then K5) or "pallas_full" (K4).
    """

    BACKENDS = ("fused_sweep", "pallas_v1", "pallas_full")

    def __init__(self, num_depth_bins: int = 64, min_depth: float = 0.25,
                 max_depth: float = 5.0, matching_dim_size: int = 16,
                 num_source_views: int = 7,
                 compute_dtype: torch.dtype = torch.float32,
                 backend: str = "fused_sweep"):
        super().__init__()
        if backend not in self.BACKENDS:
            raise ValueError(f"unknown MLPFeatureVolume backend {backend!r}")
        self.num_depth_bins = num_depth_bins
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.compute_dtype = compute_dtype
        self.backend = backend
        in_ch = mlp_in_channels(num_source_views, matching_dim_size)
        self.mlp = MLP([in_ch, HIDDEN, HIDDEN, 1])

    def forward(self, cur_feats_bhwc, src_feats_bkhwc, src_extrinsics_bk44,
                src_poses_bk44, src_Ks_bk44, cur_invK_b44,
                return_mask: bool = False):
        b, h, w, c = cur_feats_bhwc.shape
        d = self.num_depth_bins
        cdt = self.compute_dtype
        f32 = torch.float32
        device = cur_feats_bhwc.device

        planes_bd = cv_ops.generate_depth_planes(
            b, d, self.min_depth, self.max_depth, device=device).contiguous()
        # DVMVS distance of each source pose to the reference, float32
        poses = src_poses_bk44.to(f32)
        penalty, r_meas, t_meas = geo.pose_distance(poses)
        pose_meta_bk3 = torch.stack([penalty, r_meas, t_meas], dim=-1)
        src_loc_bk3 = poses[..., :3, 3].contiguous()
        extr = src_extrinsics_bk44.to(f32).contiguous()
        Ks = src_Ks_bk44.to(f32).contiguous()
        invK = cur_invK_b44.to(f32).contiguous()

        (w0, b0), (w1, b1), (w2, b2) = self.mlp.dense_params()
        src = src_feats_bkhwc.to(cdt).contiguous()
        cur = cur_feats_bhwc.reshape(b, h * w, c).to(cdt).contiguous()
        if self.backend == "fused_sweep":
            volume_bdN = FusedSweep.apply(
                src, cur, extr, Ks, invK, planes_bd, pose_meta_bk3,
                src_loc_bk3, w0.t().contiguous(), b0.to(f32),
                w1.t().contiguous(), b1.to(f32), w2.t().contiguous(),
                b2.to(f32))
        else:
            mlp = (w0.t().to(cdt).contiguous(), b0.to(f32),
                   w1.t().to(cdt).contiguous(), b1.to(f32),
                   w2.t().to(cdt).contiguous(), b2.to(f32))
            volume_bdN = self._early_sweep(src, cur, extr, Ks, invK,
                                           planes_bd, pose_meta_bk3,
                                           src_loc_bk3, mlp)
        volume_bhwd = volume_bdN.transpose(1, 2).reshape(b, h, w, d)
        lowest = cv_ops.lowest_cost_depth(volume_bhwd.detach(), planes_bd)

        overall = (source_mask(src_feats_bkhwc, extr, Ks, invK, planes_bd,
                               h, w) if return_mask else None)
        return volume_bhwd, lowest, planes_bd, overall

    def _early_sweep(self, src, cur, extr, Ks, invK, planes_bd,
                     pose_meta_bk3, src_loc_bk3, mlp) -> torch.Tensor:
        """The (b, d, N) volume through K5 ("pallas_v1": one launch per
        chunk of planes) or K4 ("pallas_full"), as the JAX package's
        `MLPFeatureVolume._pallas_volume` runs them."""
        b, k, h, w, c = src.shape
        n, d = h * w, planes_bd.shape[1]
        cdt = self.compute_dtype
        rays = cv_ops.pixel_rays(invK, h, w).contiguous()
        meta = (pose_meta_bk3, src_loc_bk3)
        if self.backend == "pallas_full":
            img, proj = early_sweeps.warp_inputs(src, extr, Ks, cdt)
            return early_sweeps.InferenceOnly.apply(
                self.backend, early_sweeps.fused_warp_feature_volume, img,
                cur, rays, planes_bd, proj, *meta, *mlp)
        dc = early_sweeps.stack_plane_chunk(b, k, n, c, d)
        chunks = []
        for s in range(0, d, dc):
            planes = planes_bd[:, s:s + dc].contiguous()
            stack = early_sweeps.stack_inputs(src, extr, Ks, invK, planes,
                                              cdt)
            chunks.append(early_sweeps.InferenceOnly.apply(
                self.backend, early_sweeps.fused_feature_volume, *stack,
                cur, rays, planes, *meta, *mlp))
        return torch.cat(chunks, dim=1)
