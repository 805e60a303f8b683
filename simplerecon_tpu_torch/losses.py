"""Training losses (counterpart of `simplerecon_tpu/losses.py`).

    loss = ms_loss + 1.0 * grad_loss + 1.0 * normals_loss + 0.2 * mv_loss

plus terms that are reported and not trained on: scale-invariant, abs
L1, inverse-depth L1 and log L1. Masked means are sums over the mask
divided by its count, as in the JAX package. Depth maps are (b, h, w),
normals (b, h, w, 3); everything runs in float32.
"""

from __future__ import annotations

from typing import Dict

import torch

from simplerecon_tpu_torch import tracing
from simplerecon_tpu_torch.ops import geometry as geo
from simplerecon_tpu_torch.ops import image as image_ops
from simplerecon_tpu_torch.ops.sampling import resize_nearest, sample_nearest


def masked_mean(values: torch.Tensor, mask: torch.Tensor,
                eps: float = 1e-10) -> torch.Tensor:
    """Mean of `values` where `mask`, safe when the mask is empty."""
    mask = mask.to(values.dtype)
    return torch.sum(values * mask) / torch.clamp(torch.sum(mask), min=eps)


def scale_invariant_loss(log_depth_gt, log_depth_pred, mask,
                         si_lambda: float = 0.85) -> torch.Tensor:
    """Eigen scale-invariant loss over masked pixels; the bracket under
    the sqrt is clamped at 0, where rounding can take it to -eps."""
    diff = torch.where(mask, log_depth_gt - log_depth_pred,
                       torch.zeros_like(log_depth_pred))
    count = torch.clamp(torch.sum(mask.to(diff.dtype)), min=1e-10)
    mean_sq = torch.sum(diff ** 2) / count
    mean = torch.sum(diff) / count
    return torch.sqrt(torch.clamp(mean_sq - si_lambda * mean ** 2, min=0.0))


def ms_gradient_loss(depth_gt_bhw, depth_pred_bhw,
                     num_scales: int = 4) -> torch.Tensor:
    """L1 between Sobel gradients over a blur-pool pyramid, where the GT
    gradient is finite: NaN GT spreads through the pyramid and masks
    every pixel whose gradient touched it."""
    gt_pyr = image_ops.pyrdown(depth_gt_bhw[..., None], num_scales)
    pred_pyr = image_ops.pyrdown(depth_pred_bhw[..., None], num_scales)
    loss = 0.0
    for gt, pred in zip(gt_pyr, pred_pyr):
        gt_grad = image_ops.spatial_gradient(gt)       # (b, h, w, 1, 2)
        pred_grad = image_ops.spatial_gradient(pred)
        finite = torch.all(torch.isfinite(gt_grad), dim=-1, keepdim=True)
        gt_grad = torch.where(finite, gt_grad, torch.zeros_like(gt_grad))
        err = torch.abs(pred_grad - gt_grad)
        loss = loss + masked_mean(err, finite.expand(err.shape))
    return loss


def normals_loss(normals_gt_bhw3, normals_pred_bhw3) -> torch.Tensor:
    """0.5 * (1 - n_gt . n_pred) over pixels where both are finite; the
    dot runs in float32."""
    finite = (torch.all(torch.isfinite(normals_gt_bhw3), dim=-1)
              & torch.all(torch.isfinite(normals_pred_bhw3), dim=-1))
    one = torch.ones((), dtype=torch.float32, device=finite.device)
    gt = torch.where(finite[..., None], normals_gt_bhw3.float(), one)
    pred = torch.where(finite[..., None], normals_pred_bhw3.float(), one)
    dots = 0.5 * (1.0 - torch.sum(gt * pred, dim=-1))
    return masked_mean(dots, finite)


def mv_depth_loss(depth_pred_bhw, cur_depth_bhw, src_depth_bkhw,
                  cur_invK_b44, src_K_bk44, cur_world_T_cam_b44,
                  src_cam_T_world_bk44) -> torch.Tensor:
    """Multi-view depth loss: project the predicted depth into each
    source view and compare, in log space, with the source GT depth at
    the nearest pixel, where the GT geometry passes the occlusion test
    proj < 1.05 * sampled."""
    b, h, w = depth_pred_bhw.shape
    k = src_depth_bkhw.shape[1]
    f32 = torch.float32
    with tracing.sync("loss_scale", depth_pred_bhw.device):
        scale = torch.tensor([2.0 / w, 2.0 / h], dtype=f32,
                             device=depth_pred_bhw.device)

    def project_depths(depth_bhw, src_K_b44, src_cam_T_world_b44):
        pts = geo.backproject_depth(depth_bhw.to(f32), cur_invK_b44.to(f32))
        world = geo.transform_points(cur_world_T_cam_b44.to(f32), pts)
        uvz = geo.project_points(world, src_K_b44.to(f32),
                                 src_cam_T_world_b44.to(f32))
        return uvz[..., :2], uvz[..., 2]

    total = 0.0
    for i in range(k):
        src_K = src_K_bk44[:, i]
        src_E = src_cam_T_world_bk44[:, i]
        uv_gt, proj_gt = project_depths(cur_depth_bhw, src_K, src_E)
        sampled = sample_nearest(src_depth_bkhw[:, i][..., None],
                                 uv_gt * scale - 1.0)[..., 0]
        valid = (proj_gt < 1.05 * sampled) & (proj_gt > 0) & (sampled > 0)

        _, proj_pred = project_depths(depth_pred_bhw, src_K, src_E)
        # clamp before the logs: masked-out lanes must stay finite, or
        # their NaNs reach the backward through torch.where
        diff = torch.abs(torch.log(torch.clamp(sampled, min=1e-6))
                         - torch.log(torch.clamp(proj_pred, min=1e-6)))
        ok = valid & torch.isfinite(diff)
        total = total + masked_mean(
            torch.where(ok, diff, torch.zeros_like(diff)), ok)
    return total / k


def compute_losses(cur_data: Dict[str, torch.Tensor],
                   src_data: Dict[str, torch.Tensor],
                   outputs: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """The loss dictionary, with the JAX package's 9 keys.

    Expects in `cur_data`: depth_bhw, mask_b_bhw (bool), normals_bhw3,
    invK_s0_b44, world_T_cam_b44; in `src_data`: depth_bkhw, K_s0_bk44,
    cam_T_world_bk44; in `outputs`: depth_pred_s{i}_bhw1, its log, and
    normals_pred_bhw3.
    """
    f32 = torch.float32
    depth_gt = cur_data["depth_bhw"].to(f32)
    mask_b = cur_data["mask_b_bhw"]
    depth_pred = outputs["depth_pred_s0_bhw1"][..., 0].to(f32)
    log_depth_pred = outputs["log_depth_pred_s0_bhw1"][..., 0].to(f32)
    log_depth_gt = torch.log(depth_gt)
    zero = torch.zeros((), dtype=f32, device=depth_gt.device)
    nan = torch.full((), float("nan"), dtype=f32, device=depth_gt.device)
    safe_log_gt = torch.where(mask_b, log_depth_gt, zero)

    h, w = depth_gt.shape[-2:]
    ms_loss = 0.0
    for i in range(4):
        key = f"log_depth_pred_s{i}_bhw1"
        if key not in outputs:
            continue
        pred_i = resize_nearest(outputs[key].to(f32), h, w)[..., 0]
        ms_loss = ms_loss + masked_mean(
            torch.abs(torch.where(mask_b, log_depth_gt - pred_i, zero)),
            mask_b) / (2 ** i)

    # the gradient loss sees NaN outside the valid mask (see
    # ms_gradient_loss); the projections of mv_loss need finite values
    grad_loss = ms_gradient_loss(torch.where(mask_b, depth_gt, nan),
                                 depth_pred)
    depth_gt_clean = torch.where(mask_b, depth_gt, zero)
    abs_loss = masked_mean(
        torch.abs(torch.where(mask_b, depth_gt - depth_pred, zero)), mask_b)
    si_loss = scale_invariant_loss(safe_log_gt, log_depth_pred, mask_b)

    mask_b_limit = mask_b & (depth_pred > 0.1)
    inv_abs = torch.where(
        mask_b_limit,
        1.0 / torch.where(mask_b, depth_gt, torch.ones_like(depth_gt))
        - 1.0 / torch.clamp(depth_pred, min=1e-6), zero)
    inv_abs_loss = masked_mean(torch.abs(inv_abs), mask_b_limit)
    log_l1_loss = masked_mean(
        torch.abs(torch.where(mask_b, log_depth_gt - log_depth_pred, zero)),
        mask_b)

    nrm_loss = normals_loss(cur_data["normals_bhw3"],
                            outputs["normals_pred_bhw3"])

    mv_loss = mv_depth_loss(
        depth_pred_bhw=depth_pred,
        cur_depth_bhw=depth_gt_clean,
        src_depth_bkhw=torch.nan_to_num(src_data["depth_bkhw"].to(f32),
                                        nan=0.0),
        cur_invK_b44=cur_data["invK_s0_b44"],
        src_K_bk44=src_data["K_s0_bk44"],
        cur_world_T_cam_b44=cur_data["world_T_cam_b44"],
        src_cam_T_world_bk44=src_data["cam_T_world_bk44"])

    loss = ms_loss + 1.0 * grad_loss + 1.0 * nrm_loss + 0.2 * mv_loss
    return {
        "loss": loss,
        "si_loss": si_loss,
        "grad_loss": grad_loss,
        "abs_loss": abs_loss,
        "normals_loss": nrm_loss,
        "ms_loss": ms_loss,
        "inv_abs_loss": inv_abs_loss,
        "log_l1_loss": log_l1_loss,
        "mv_loss": mv_loss,
    }
