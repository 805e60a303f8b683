"""The SimpleRecon depth model (counterpart of
`simplerecon_tpu/models/depth_model.py`): EfficientNetV2-S image prior,
ResNet matching encoder, metadata-MLP feature volume, CV encoder and
UNet++ decoder in one inference forward.

Parameters stay float32. With `compute_dtype=torch.bfloat16` the
convolution stacks run under autocast and the feature volume in bf16,
while relative poses and all projection geometry stay float32 and the
instance norms run in float32.

Flip follows the JAX package: images are flipped before the encoders,
matching features are flipped back before the cost volume, the volume is
flipped to line up with the flipped image-prior features, and the depth
maps are flipped back.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch
import torch.nn as nn

from simplerecon_tpu_torch.models.cost_volume import MLPFeatureVolume
from simplerecon_tpu_torch.models.decoders import CVEncoder, DepthDecoderPP
from simplerecon_tpu_torch.models.efficientnet import EfficientNetV2Features
from simplerecon_tpu_torch.models.matching_encoder import \
    ResnetMatchingEncoder

# cost_volume_backend values of the JAX package that all select the port's
# one sweep path (the fused sweep kernel), and those that wait for a kernel
SWEEP_BACKENDS = ("pallas", "pallas_interpret", "xla", "xla_fused")
UNPORTED_BACKENDS = {
    "pallas_full": "K4 (ROADMAP Queue 2, item 6)",
    "pallas_full_interpret": "K4 (ROADMAP Queue 2, item 6)",
    "pallas_v1": "K5 (ROADMAP Queue 2, item 5)",
    "pallas_v1_interpret": "K5 (ROADMAP Queue 2, item 5)",
}


class DepthModel(nn.Module):
    """SimpleRecon hero depth network (inference)."""

    def __init__(self, matching_scale: int = 1,
                 matching_num_depth_bins: int = 64,
                 min_matching_depth: float = 0.25,
                 max_matching_depth: float = 5.0,
                 matching_feature_dims: int = 16,
                 matching_norm: str = "batch",
                 matching_pool_impl: str = "reference",
                 model_num_views: int = 8,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if matching_scale != 1:
            raise NotImplementedError("only matching_scale=1 is ported")
        self.matching_scale = matching_scale
        self.compute_dtype = compute_dtype
        self.encoder = EfficientNetV2Features()
        self.matching_model = ResnetMatchingEncoder(
            num_ch_out=matching_feature_dims, norm=matching_norm,
            pool_impl=matching_pool_impl)
        self.cost_volume = MLPFeatureVolume(
            num_depth_bins=matching_num_depth_bins,
            min_depth=min_matching_depth, max_depth=max_matching_depth,
            matching_dim_size=matching_feature_dims,
            num_source_views=model_num_views - 1,
            compute_dtype=compute_dtype)
        enc_ch = self.encoder.num_ch_enc
        m = matching_scale
        self.cost_volume_net = CVEncoder(
            num_ch_cv=matching_num_depth_bins, num_ch_enc=enc_ch[m:])
        self.depth_decoder = DepthDecoderPP(
            num_ch_enc=list(enc_ch[:m]) + list(CVEncoder.num_ch_outs))

    def _autocast(self, device: torch.device):
        if self.compute_dtype == torch.float32:
            return contextlib.nullcontext()
        return torch.autocast(device.type, dtype=self.compute_dtype)

    def forward(self, cur_data: Dict[str, torch.Tensor],
                src_data: Dict[str, torch.Tensor], flip: bool = False,
                return_mask: bool = False) -> Dict[str, torch.Tensor]:
        """Forward pass, in eval mode.

        cur_data: `image_b3hw` (b, 3, h, w), `invK_s1_b44`,
        `cam_T_world_b44`, `world_T_cam_b44`. src_data: `image_b3hw`
        (b, k, 3, h, w), `K_s1_b44`, `cam_T_world_b44`, `world_T_cam_b44`
        (b, k, 4, 4). Returns `log_depth_pred_s{i}_bhw1` and
        `depth_pred_s{i}_bhw1` for i in 0..3 (s0 is half the input
        resolution), `lowest_cost_bhw` and `overall_mask_bhw` (None unless
        return_mask).
        """
        m = self.matching_scale
        cdt = self.compute_dtype
        f32 = torch.float32
        cur_image = cur_data["image_b3hw"].to(cdt)
        src_image = src_data["image_b3hw"].to(cdt)
        device = cur_image.device
        b, k = src_image.shape[:2]
        h, w = cur_image.shape[-2:]

        # relative transforms in float32
        src_cam_T_world = src_data["cam_T_world_b44"].to(f32)
        src_world_T_cam = src_data["world_T_cam_b44"].to(f32)
        cur_cam_T_world = cur_data["cam_T_world_b44"].to(f32)
        cur_world_T_cam = cur_data["world_T_cam_b44"].to(f32)
        src_cam_T_cur_cam = src_cam_T_world @ cur_world_T_cam[:, None]
        cur_cam_T_src_cam = cur_cam_T_world[:, None] @ src_world_T_cam

        if flip:
            cur_image = torch.flip(cur_image, dims=(-1,))
            src_image = torch.flip(src_image, dims=(-1,))

        all_images = torch.cat([cur_image[:, None], src_image], dim=1)
        with self._autocast(device):
            cur_feats = self.encoder(cur_image)
            matching = self.matching_model(
                all_images.reshape(b * (k + 1), 3, h, w))
        mc, mh, mw = matching.shape[1:]
        # (b, k+1, h, w, c), flipped back for geometrically correct MVS
        matching = matching.to(cdt).reshape(b, k + 1, mc, mh, mw
                                            ).permute(0, 1, 3, 4, 2)
        if flip:
            matching = torch.flip(matching, dims=(3,))

        volume_bhwd, lowest_cost, _, overall_mask = self.cost_volume(
            matching[:, 0], matching[:, 1:],
            src_extrinsics_bk44=src_cam_T_cur_cam,
            src_poses_bk44=cur_cam_T_src_cam,
            src_Ks_bk44=src_data[f"K_s{m}_b44"].to(f32),
            cur_invK_b44=cur_data[f"invK_s{m}_b44"].to(f32),
            return_mask=return_mask)

        # re-align the volume with the (possibly flipped) image features
        volume = volume_bhwd.permute(0, 3, 1, 2).to(cdt)
        if flip:
            volume = torch.flip(volume, dims=(-1,))

        with self._autocast(device):
            cv_feats = self.cost_volume_net(volume, cur_feats[m:])
            depth_outputs = self.depth_decoder(list(cur_feats[:m]) + cv_feats)

        outputs = {}
        for key, log_depth_b1hw in depth_outputs.items():
            log_depth = log_depth_b1hw.to(f32).permute(0, 2, 3, 1)
            if flip:
                log_depth = torch.flip(log_depth, dims=(2,))
            bhw1_key = key.replace("_b1hw", "_bhw1")
            outputs[bhw1_key] = log_depth
            # clamp before exp: [-8, 8] never binds for real depths
            outputs[bhw1_key.replace("log_", "")] = torch.exp(
                torch.clamp(log_depth, -8.0, 8.0))
        if flip:
            lowest_cost = torch.flip(lowest_cost, dims=(2,))
        outputs["lowest_cost_bhw"] = lowest_cost
        outputs["overall_mask_bhw"] = overall_mask
        return outputs


def _compute_dtype(opts) -> torch.dtype:
    name = getattr(opts, "compute_dtype", None)
    if name is None:
        name = ("bfloat16" if str(getattr(opts, "precision", "16"))
                in ("16", "bf16") else "float32")
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def build_depth_model(opts, device=None, seed: int = 0) -> DepthModel:
    """Builds an eval-mode DepthModel from any object carrying `Options`'
    attribute names, with weights drawn from a `torch.Generator` seeded
    with `seed`, on `device`.

    The JAX package's sweep backends `pallas`, `pallas_interpret`, `xla`
    and `xla_fused`, with or without `fast_cost_volume`, all select the
    port's one path, the fused sweep kernel. `pallas_full` and
    `pallas_v1` raise until their kernels are ported, as does the
    dot-product model.
    """
    from simplerecon_tpu_torch.utils.weights import init_random_

    if opts.feature_volume_type != "mlp_feature_volume":
        raise NotImplementedError(
            f"feature_volume_type={opts.feature_volume_type!r} is not "
            "ported; the dot-product model waits for K1's dot mode "
            "(ROADMAP Queue 1, item 11)")
    if opts.matching_encoder_type != "resnet":
        raise NotImplementedError(
            f"matching_encoder_type={opts.matching_encoder_type!r} is not "
            "ported (ROADMAP Queue 1, item 12)")
    backend = getattr(opts, "cost_volume_backend", "xla_fused")
    if backend in UNPORTED_BACKENDS:
        raise NotImplementedError(
            f"cost_volume_backend={backend!r} is kernel "
            f"{UNPORTED_BACKENDS[backend]}, not ported yet")
    if backend not in SWEEP_BACKENDS:
        raise ValueError(f"unknown cost_volume_backend {backend!r}")
    model = DepthModel(
        matching_scale=opts.matching_scale,
        matching_num_depth_bins=opts.matching_num_depth_bins,
        min_matching_depth=opts.min_matching_depth,
        max_matching_depth=opts.max_matching_depth,
        matching_feature_dims=opts.matching_feature_dims,
        matching_norm=getattr(opts, "matching_norm", "batch"),
        matching_pool_impl=getattr(opts, "matching_pool_impl", "reference"),
        model_num_views=opts.model_num_views,
        compute_dtype=_compute_dtype(opts))
    init_random_(model, torch.Generator().manual_seed(seed))
    return model.to(device or "cpu").eval()
