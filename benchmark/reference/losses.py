"""The reference's training losses and its AdamW step, plain float32:

    loss = ms_loss + grad_loss + normals_loss + 0.2 * mv_loss

with the reported terms si, abs, inverse-depth and log L1. Masked means
are sums over the mask over its count. AdamW: betas (0.9, 0.999), eps
1e-8, decoupled weight decay, the update skipped when the gradients'
global norm is not finite.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from benchmark.reference import ops


def masked_mean(values, mask, eps: float = 1e-10):
    mask = mask.to(values.dtype)
    return torch.sum(values * mask) / torch.clamp(torch.sum(mask), min=eps)


def ms_gradient_loss(depth_gt_bhw, depth_pred_bhw, num_scales: int = 4):
    loss = 0.0
    for gt, pred in zip(ops.pyrdown(depth_gt_bhw[..., None], num_scales),
                        ops.pyrdown(depth_pred_bhw[..., None], num_scales)):
        gt_grad = ops.spatial_gradient(gt)
        pred_grad = ops.spatial_gradient(pred)
        finite = torch.all(torch.isfinite(gt_grad), -1, keepdim=True)
        gt_grad = torch.where(finite, gt_grad, torch.zeros_like(gt_grad))
        err = torch.abs(pred_grad - gt_grad)
        loss = loss + masked_mean(err, finite.expand(err.shape))
    return loss


def normals_loss(gt_bhw3, pred_bhw3):
    finite = (torch.all(torch.isfinite(gt_bhw3), -1)
              & torch.all(torch.isfinite(pred_bhw3), -1))
    one = torch.ones((), device=finite.device)
    gt = torch.where(finite[..., None], gt_bhw3, one)
    pred = torch.where(finite[..., None], pred_bhw3, one)
    return masked_mean(0.5 * (1.0 - torch.sum(gt * pred, -1)), finite)


def mv_depth_loss(depth_pred, cur_depth, src_depth_bkhw, cur_invK, src_K_bk44,
                  cur_world_T_cam, src_cam_T_world_bk44):
    b, h, w = depth_pred.shape
    k = src_depth_bkhw.shape[1]
    scale = torch.tensor([2.0 / w, 2.0 / h], device=depth_pred.device)

    def project(depth, K, E):
        world = ops.transform_points(cur_world_T_cam,
                                     ops.backproject_depth(depth, cur_invK))
        uvz = ops.project_points(world, K, E)
        return uvz[..., :2], uvz[..., 2]

    total = 0.0
    for i in range(k):
        K, E = src_K_bk44[:, i], src_cam_T_world_bk44[:, i]
        uv_gt, proj_gt = project(cur_depth, K, E)
        sampled = ops.sample_nearest(src_depth_bkhw[:, i][..., None],
                                     uv_gt * scale - 1.0)[..., 0]
        valid = (proj_gt < 1.05 * sampled) & (proj_gt > 0) & (sampled > 0)
        _, proj_pred = project(depth_pred, K, E)
        diff = torch.abs(torch.log(torch.clamp(sampled, min=1e-6))
                         - torch.log(torch.clamp(proj_pred, min=1e-6)))
        ok = valid & torch.isfinite(diff)
        total = total + masked_mean(torch.where(ok, diff,
                                                torch.zeros_like(diff)), ok)
    return total / k


def compute_losses(cur: Dict, src: Dict, outputs: Dict) -> Dict:
    """The nine loss terms of a forward's `outputs` against the batch."""
    depth_gt, mask = cur["depth_bhw"], cur["mask_b_bhw"]
    depth_pred = outputs["depth_pred_s0_bhw1"][..., 0]
    log_pred = outputs["log_depth_pred_s0_bhw1"][..., 0]
    log_gt = torch.log(depth_gt)
    zero = torch.zeros((), device=depth_gt.device)
    nan = torch.full((), float("nan"), device=depth_gt.device)
    invK = cur["invK_s0_b44"]
    h, w = depth_gt.shape[-2:]
    ms_loss = 0.0
    for i in range(4):
        pred_i = ops.resize_nearest(outputs[f"log_depth_pred_s{i}_bhw1"], h,
                                    w)[..., 0]
        ms_loss = ms_loss + masked_mean(torch.abs(torch.where(
            mask, log_gt - pred_i, zero)), mask) / (2 ** i)
    grad_loss = ms_gradient_loss(torch.where(mask, depth_gt, nan), depth_pred)
    abs_loss = masked_mean(torch.abs(torch.where(mask, depth_gt - depth_pred,
                                                 zero)), mask)
    diff = torch.where(mask, torch.where(mask, log_gt, zero) - log_pred, zero)
    count = torch.clamp(torch.sum(mask.float()), min=1e-10)
    mean_sq, mean = torch.sum(diff ** 2) / count, torch.sum(diff) / count
    si_loss = torch.sqrt(torch.clamp(mean_sq - 0.85 * mean ** 2, min=0.0))
    limit = mask & (depth_pred > 0.1)
    inv = torch.where(limit, 1.0 / torch.where(mask, depth_gt,
                                              torch.ones_like(depth_gt))
                      - 1.0 / torch.clamp(depth_pred, min=1e-6), zero)
    inv_abs_loss = masked_mean(torch.abs(inv), limit)
    log_l1_loss = masked_mean(torch.abs(torch.where(mask, log_gt - log_pred,
                                                    zero)), mask)
    gt_normals = ops.normals_from_depth(torch.where(mask, depth_gt, nan), invK)
    pred_normals = ops.normals_from_depth(depth_pred, invK)
    nrm_loss = normals_loss(gt_normals, pred_normals)
    mv_loss = mv_depth_loss(
        depth_pred, torch.where(mask, depth_gt, zero),
        torch.nan_to_num(src["depth_bkhw"], nan=0.0), invK, src["K_s0_bk44"],
        cur["world_T_cam_b44"], src["cam_T_world_b44"])
    loss = ms_loss + grad_loss + nrm_loss + 0.2 * mv_loss
    return {"loss": loss, "si_loss": si_loss, "grad_loss": grad_loss,
            "abs_loss": abs_loss, "normals_loss": nrm_loss,
            "ms_loss": ms_loss, "inv_abs_loss": inv_abs_loss,
            "log_l1_loss": log_l1_loss, "mv_loss": mv_loss}


class AdamW:
    """torch's AdamW equations, float32, over `params`, with the update
    skipped when the global gradient norm is not finite."""

    def __init__(self, params: List[torch.Tensor], lr: float, wd: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.wd, self.betas, self.eps = lr, wd, betas, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads]))
        if not bool(torch.isfinite(norm)):
            return norm
        self.count += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            p.mul_(1 - self.lr * self.wd)
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v.sqrt() / c2 ** 0.5).add_(self.eps)
            p.addcdiv_(m, denom, value=-self.lr / c1)
        return norm
