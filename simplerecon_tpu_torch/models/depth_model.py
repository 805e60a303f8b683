"""The SimpleRecon depth model (counterpart of
`simplerecon_tpu/models/depth_model.py`): EfficientNetV2-S image prior,
ResNet matching encoder (or, with `matching_encoder_type="unet_encoder"`,
the mnasnet + FPN one), a metadata-MLP feature volume (the hero model)
or a dot-product cost volume (the dot-product model), CV encoder and
UNet++ decoder. The forward serves inference (`model.eval()`, usually
under `torch.no_grad()`) and training (`model.train()`: batch norms use
batch statistics and update their running ones; gradients reach every
parameter through the sweep's backward).

Parameters stay float32. With `compute_dtype=torch.bfloat16` the
convolution stacks run under autocast and the feature volume in bf16,
while relative poses and all projection geometry stay float32 and the
instance norms run in float32.

On a CUDA device the convolution stacks' weights and activations are
laid out channels_last (`ops/layout.py`), which cuDNN's tensor-core
convolutions take without a transpose: the model lays out its 4-D
weights so whenever it is built on, or moved to, a device, and lays out
the images so as they enter. The depthwise convolutions and the stem
pool K3 run on NCHW maps between two copies (`layout.on_nchw`). Logical
shapes, the outputs' layouts and the math are the same on every device.

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

from simplerecon_tpu_torch import tracing
from simplerecon_tpu_torch.models.cost_volume import (DotProductCostVolume,
                                                      MLPFeatureVolume)
from simplerecon_tpu_torch.models.decoders import CVEncoder, DepthDecoderPP
from simplerecon_tpu_torch.models.efficientnet import EfficientNetV2Features
from simplerecon_tpu_torch.models.matching_encoder import (
    ResnetMatchingEncoder, UNetMatchingEncoder)
from simplerecon_tpu_torch.ops import layout

# cost_volume_backend values of the JAX package and the hero model's sweep
# each selects in the port: the fused sweep kernel K1 (with K2 as its
# backward) for the JAX package's "pallas" and XLA backends, the plain warp
# and K5 for "pallas_v1", K4 for "pallas_full" (both inference-only). The
# dot-product model runs K1-dot for every one of them.
HERO_SWEEPS = {
    "pallas": "fused_sweep", "pallas_interpret": "fused_sweep",
    "xla": "fused_sweep", "xla_fused": "fused_sweep",
    "pallas_v1": "pallas_v1", "pallas_v1_interpret": "pallas_v1",
    "pallas_full": "pallas_full", "pallas_full_interpret": "pallas_full",
}


def resolve_device(device=None) -> torch.device:
    """`device`, or the CUDA card when none is given. Raises when the card
    is asked for and there is none: nothing falls back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return device


FEATURE_VOLUME_TYPES = ("mlp_feature_volume", "simple_cost_volume")
MATCHING_ENCODER_TYPES = ("resnet", "unet_encoder")


class DepthModel(nn.Module):
    """SimpleRecon depth network: the hero model
    (`feature_volume_type="mlp_feature_volume"`, its feature volume's
    backend `hero_sweep`) or the dot-product model
    ("simple_cost_volume"), with the matching encoder
    `matching_encoder_type` ("resnet" or "unet_encoder"; the UNet
    encoder ignores `matching_norm` and `matching_pool_impl`, as the JAX
    package's does)."""

    def __init__(self, matching_scale: int = 1,
                 matching_num_depth_bins: int = 64,
                 min_matching_depth: float = 0.25,
                 max_matching_depth: float = 5.0,
                 matching_feature_dims: int = 16,
                 matching_norm: str = "batch",
                 matching_pool_impl: str = "reference",
                 model_num_views: int = 8,
                 feature_volume_type: str = "mlp_feature_volume",
                 compute_dtype: torch.dtype = torch.float32,
                 hero_sweep: str = "fused_sweep",
                 matching_encoder_type: str = "resnet"):
        super().__init__()
        if feature_volume_type not in FEATURE_VOLUME_TYPES:
            raise ValueError(
                f"unknown feature_volume_type {feature_volume_type!r}")
        if matching_encoder_type not in MATCHING_ENCODER_TYPES:
            raise ValueError(
                f"unknown matching_encoder_type {matching_encoder_type!r}")
        if matching_scale != 1:
            raise NotImplementedError("only matching_scale=1 is ported")
        self.matching_scale = matching_scale
        self.compute_dtype = compute_dtype
        self.encoder = EfficientNetV2Features()
        if matching_encoder_type == "unet_encoder":
            self.matching_model = UNetMatchingEncoder(
                num_ch_out=matching_feature_dims)
        else:
            self.matching_model = ResnetMatchingEncoder(
                num_ch_out=matching_feature_dims, norm=matching_norm,
                pool_impl=matching_pool_impl)
        if feature_volume_type == "simple_cost_volume":
            self.cost_volume = DotProductCostVolume(
                num_depth_bins=matching_num_depth_bins,
                min_depth=min_matching_depth, max_depth=max_matching_depth,
                compute_dtype=compute_dtype)
        else:
            self.cost_volume = MLPFeatureVolume(
                num_depth_bins=matching_num_depth_bins,
                min_depth=min_matching_depth, max_depth=max_matching_depth,
                matching_dim_size=matching_feature_dims,
                num_source_views=model_num_views - 1,
                compute_dtype=compute_dtype, backend=hero_sweep)
        enc_ch = self.encoder.num_ch_enc
        m = matching_scale
        self.cost_volume_net = CVEncoder(
            num_ch_cv=matching_num_depth_bins, num_ch_enc=enc_ch[m:])
        self.depth_decoder = DepthDecoderPP(
            num_ch_enc=list(enc_ch[:m]) + list(CVEncoder.num_ch_outs))
        self._follow_device()

    def _follow_device(self) -> None:
        """Lays out the 4-D weights in the layout of the device they are
        on (`layout.conv_format`)."""
        device = next(self.parameters()).device
        layout.use_format_(self, layout.conv_format(device))

    def _apply(self, fn, recurse=True):
        # every move (`to`, `cuda`, `cpu`, a cast) ends in the layout of
        # the device it lands on
        super()._apply(fn, recurse)
        self._follow_device()
        return self

    @property
    def memory_format(self) -> torch.memory_format:
        """The layout the convolution stacks run in: their weights'."""
        return layout.format_of(self.encoder.conv_stem.weight)

    def _autocast(self, device: torch.device):
        if self.compute_dtype == torch.float32:
            return contextlib.nullcontext()
        return torch.autocast(device.type, dtype=self.compute_dtype)

    def forward(self, cur_data: Dict[str, torch.Tensor],
                src_data: Dict[str, torch.Tensor], flip: bool = False,
                return_mask: bool = False) -> Dict[str, torch.Tensor]:
        """Forward pass; `flip` is a Python bool (the train-time horizontal
        flip).

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
        fmt = self.memory_format
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

        with tracing.span("sr.prior"), self._autocast(device):
            cur_feats = tracing.mark("prior", self.encoder(
                cur_image.contiguous(memory_format=fmt)))
        with tracing.span("sr.matching"):
            all_images = torch.cat([cur_image[:, None], src_image], dim=1)
            with self._autocast(device):
                matching = self.matching_model(
                    all_images.reshape(b * (k + 1), 3, h, w).contiguous(
                        memory_format=fmt))
            mc, mh, mw = matching.shape[1:]
            # (b, k+1, h, w, c), flipped back for geometrically correct MVS;
            # a view of channels_last features
            matching = matching.to(cdt).reshape(b, k + 1, mc, mh, mw
                                                ).permute(0, 1, 3, 4, 2)
            if flip:
                matching = torch.flip(matching, dims=(3,))
            matching, = tracing.mark("matching", [matching])

        with tracing.span("sr.cost_volume"):
            volume_bhwd, lowest_cost, _, overall_mask = self.cost_volume(
                matching[:, 0], matching[:, 1:],
                src_extrinsics_bk44=src_cam_T_cur_cam,
                src_poses_bk44=cur_cam_T_src_cam,
                src_Ks_bk44=src_data[f"K_s{m}_b44"].to(f32),
                cur_invK_b44=cur_data[f"invK_s{m}_b44"].to(f32),
                return_mask=return_mask)
            volume_bhwd, = tracing.mark("cost_volume", [volume_bhwd])

        with tracing.span("sr.cv_encoder"):
            # re-align the volume with the (possibly flipped) image
            # features; its cast to the compute dtype lays it out too
            volume = layout.relayout(volume_bhwd.permute(0, 3, 1, 2), fmt,
                                     cdt)
            if flip:
                volume = torch.flip(volume, dims=(-1,))
            with self._autocast(device):
                cv_feats = tracing.mark(
                    "cv_encoder", self.cost_volume_net(volume, cur_feats[m:]))

        with tracing.span("sr.decoder"):
            with self._autocast(device):
                depth_outputs = self.depth_decoder(list(cur_feats[:m])
                                                   + cv_feats)
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
            outputs = dict(zip(outputs, tracing.mark("decoder",
                                                     outputs.values())))
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
    with `seed`, on `device`: the CUDA card unless another device is
    given (raises when there is no card).

    `cost_volume_backend` picks the hero model's sweep (`HERO_SWEEPS`),
    with or without `fast_cost_volume`: `pallas`, `pallas_interpret`,
    `xla` and `xla_fused` the fused sweep kernel K1, `pallas_v1` and
    `pallas_full` (and their `_interpret` forms) the inference-only K5
    and K4. The dot-product model runs K1-dot for each of them.
    """
    from simplerecon_tpu_torch.utils.weights import init_random_

    backend = getattr(opts, "cost_volume_backend", "xla_fused")
    if backend not in HERO_SWEEPS:
        raise ValueError(f"unknown cost_volume_backend {backend!r}")
    device = resolve_device(device)
    model = DepthModel(
        matching_scale=opts.matching_scale,
        matching_num_depth_bins=opts.matching_num_depth_bins,
        min_matching_depth=opts.min_matching_depth,
        max_matching_depth=opts.max_matching_depth,
        matching_feature_dims=opts.matching_feature_dims,
        matching_norm=getattr(opts, "matching_norm", "batch"),
        matching_pool_impl=getattr(opts, "matching_pool_impl", "reference"),
        model_num_views=opts.model_num_views,
        feature_volume_type=opts.feature_volume_type,
        compute_dtype=_compute_dtype(opts), hero_sweep=HERO_SWEEPS[backend],
        matching_encoder_type=opts.matching_encoder_type)
    init_random_(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
