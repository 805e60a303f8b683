"""Metadata-MLP feature volume (counterpart of
`simplerecon_tpu/models/cost_volume.py::MLPFeatureVolume`).

The volume comes from the fused sweep (`ops/cuda_cv.py::fused_sweep`:
the CUDA kernel on the card, its plain version on the CPU), with the MLP
weights cast to the compute dtype. Pose metadata and the farthest-plane
source mask are plain PyTorch in float32.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from simplerecon_tpu_torch.models.layers import MLP
from simplerecon_tpu_torch.ops import cost_volume as cv_ops
from simplerecon_tpu_torch.ops import geometry as geo
from simplerecon_tpu_torch.ops.cuda_cv import (HIDDEN, fused_sweep,
                                               mlp_in_channels)


class MLPFeatureVolume(nn.Module):
    """Per (pixel, plane), an MLP reduces the warped source features,
    the reference features and geometric metadata to a matching score.

    Takes the JAX layout: reference features (b, h, w, c), source
    features (b, k, h, w, c), src_cam_T_cur_cam extrinsics and
    cur_cam_T_src_cam poses (b, k, 4, 4), source intrinsics (b, k, 4, 4)
    and reference inverse intrinsics (b, 4, 4). Returns (volume (b, h, w,
    d) float32, lowest-cost depth (b, h, w), planes (b, d), overall mask
    (b, h, w) bool or None).
    """

    def __init__(self, num_depth_bins: int = 64, min_depth: float = 0.25,
                 max_depth: float = 5.0, matching_dim_size: int = 16,
                 num_source_views: int = 7,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_depth_bins = num_depth_bins
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.compute_dtype = compute_dtype
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
        volume_bdN = fused_sweep(
            src_feats_bkhwc.to(cdt).contiguous(),
            cur_feats_bhwc.reshape(b, h * w, c).to(cdt).contiguous(),
            extr, Ks, invK, planes_bd, pose_meta_bk3, src_loc_bk3,
            w0.t().to(cdt).contiguous(), b0.to(f32),
            w1.t().to(cdt).contiguous(), b1.to(f32),
            w2.t().to(cdt).contiguous(), b2.to(f32))
        volume_bhwd = volume_bdN.transpose(1, 2).reshape(b, h, w, d)
        lowest = cv_ops.lowest_cost_depth(volume_bhwd, planes_bd)

        overall = None
        if return_mask:
            # only the farthest plane matters for the source-visibility mask
            warp_last = cv_ops.sweep_warp(src_feats_bkhwc[..., :1], extr, Ks,
                                          invK, planes_bd[:, -1:])
            overall = cv_ops.overall_source_mask(warp_last, h, w
                                                 ).reshape(b, h, w)
        return volume_bhwd, lowest, planes_bd, overall
