"""Matching encoders (counterparts of
`simplerecon_tpu/models/matching_encoder.py`): the ResNet encoder
(`ResnetMatchingEncoder`, the default) and the mnasnet + FPN encoder
(`UNetMatchingEncoder`, `matching_encoder_type="unet_encoder"`).

`ResnetMatchingEncoder`:

    net.0 7x7/2 conv -> net.1 norm (eps 1e-5) -> ReLU ->
    net.3 max-pool 2x2/1 + BlurPool(4-tap, reflect pad (1,2,1,2), stride 2),
          or the fused kernel pair K3 with pool_impl="pallas"
    -> net.4 layer1 (two torchvision BasicBlocks) ->
    net.5 1x1 conv(128) -> InstanceNorm -> LeakyReLU(0.2) ->
    net.8 3x3 conv(16, replicate pad) -> InstanceNorm

NCHW in, 16-channel features at 1/4 resolution out. The instance norms
run in float32. The stem's norms (net.1 and the blocks' bn1, bn2) are
batch norms that update their running statistics by flax's rule in train
mode (`layers.BatchNorm2d`), or with `norm="group"` GroupNorm-8 in
float32 (`layers.GroupNorm32`), the same in train and eval. Module
indices are the reference state_dict's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from simplerecon_tpu_torch.models.layers import (BatchNorm2d,
                                                DepthwiseConv2d, GroupNorm32,
                                                InstanceNorm32)
from simplerecon_tpu_torch.ops import layout, pool
from simplerecon_tpu_torch.ops.image import pad_edges


class BlurPool(nn.Module):
    """antialiased_cnns.BlurPool(filt_size=4, stride=2): reflect pad
    (1, 2, 1, 2), then the depthwise [1,3,3,1] x [1,3,3,1] / 64 filter,
    kept as the reference state_dict's buffer `filt`."""

    def __init__(self, channels: int):
        super().__init__()
        self.register_buffer("filt", pool.blur_filter(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return pool.blur_pool_reference(x, self.filt)


class ReplicatePadConv2d(nn.Conv2d):
    """`nn.Conv2d(..., padding_mode="replicate")` whose pad is
    `ops/image.py::pad_edges`: F.pad's forward, and a backward that sums
    in a fixed order."""

    def _conv_forward(self, x, weight, bias):
        ph, pw = self.padding
        x = pad_edges(x, (pw, pw, ph, ph), "replicate")
        return F.conv2d(x, weight, bias, self.stride, 0, self.dilation,
                        self.groups)


class StemPool(nn.Sequential):
    """net.3: max-pool 2x2/1 (net.3.0), then BlurPool (net.3.1, whose
    buffer `filt` the reference state_dict holds as
    `matching_model.net.3.1.filt`). Both pool forms keep that layout, so
    a checkpoint loads into either. `impl="pallas"` runs the pair as one
    fused kernel pair (`ops/pool.py::MaxBlurPool`, K3), with the fixed
    filter, on NCHW maps (`layout.on_nchw`); "reference" and "fused" run
    the two modules in the map's layout."""

    def __init__(self, channels: int, impl: str):
        super().__init__(nn.MaxPool2d(kernel_size=2, stride=1),
                         BlurPool(channels))
        self.impl = impl

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.impl == "pallas":
            return layout.on_nchw(pool.MaxBlurPool.apply, x)
        return super().forward(x)


def make_norm(norm: str, channels: int) -> nn.Module:
    """The stem's norm: "batch" (`BatchNorm2d`, running statistics) or
    "group" (`GroupNorm32`, GroupNorm-8)."""
    if norm == "batch":
        return BatchNorm2d(channels, eps=1e-5)
    if norm == "group":
        return GroupNorm32(channels)
    raise ValueError(f"unknown matching_norm {norm!r}")


class ResNetBasicBlock(nn.Module):
    """torchvision BasicBlock: bias-free convs, norm, ReLU."""

    def __init__(self, planes: int = 64, norm: str = "batch"):
        super().__init__()
        self.conv1 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn1 = make_norm(norm, planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = make_norm(norm, planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + x)


class ResnetMatchingEncoder(nn.Module):
    """ResNet-18-stem matching encoder -> `num_ch_out` features at 1/4
    resolution.

    `pool_impl` "reference" and "fused" are the same math and run the same
    chain here; "pallas" runs the fused max-blur-pool kernels K3 (forward
    and backward) on the card, their plain versions on the CPU. `norm`
    is "batch" or "group" (`make_norm`).
    """

    def __init__(self, num_ch_out: int = 16, norm: str = "batch",
                 pool_impl: str = "reference"):
        super().__init__()
        if pool_impl not in ("reference", "fused", "pallas"):
            raise ValueError(f"unknown matching_pool_impl {pool_impl!r}")
        self.net = nn.Sequential(
            nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False),      # 0
            make_norm(norm, 64),                                       # 1
            nn.ReLU(inplace=True),                                     # 2
            StemPool(64, pool_impl),                                   # 3
            nn.Sequential(ResNetBasicBlock(64, norm),
                          ResNetBasicBlock(64, norm)),                 # 4
            nn.Conv2d(64, 128, 1),                                     # 5
            InstanceNorm32(),                                          # 6
            nn.LeakyReLU(0.2, inplace=True),                           # 7
            ReplicatePadConv2d(128, num_ch_out, 3, padding=1,
                               padding_mode="replicate"),              # 8
            InstanceNorm32(),                                          # 9
        )

    def forward(self, image_b3hw: torch.Tensor) -> torch.Tensor:
        return self.net(image_b3hw)


class MnasDsConv(nn.Module):
    """timm's DepthwiseSeparableConv (mnasnet `blocks.0.0`): depthwise
    3x3/1 -> BN -> ReLU -> pointwise 1x1 -> BN, no skip."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv_dw = DepthwiseConv2d(cin, 3, padding=1)
        self.bn1 = BatchNorm2d(cin, eps=1e-5)
        self.conv_pw = nn.Conv2d(cin, cout, 1, bias=False)
        self.bn2 = BatchNorm2d(cout, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn2(self.conv_pw(F.relu(self.bn1(self.conv_dw(x)))))


class MnasIR(nn.Module):
    """timm's InvertedResidual as mnasnet_100 uses it: pointwise expand
    -> BN -> ReLU -> depthwise kxk/stride -> BN -> ReLU -> pointwise
    linear -> BN, plus the input when the stride is 1 and the channels
    match."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int,
                 exp_ratio: int):
        super().__init__()
        mid = cin * exp_ratio
        self.skip = stride == 1 and cin == cout
        self.conv_pw = nn.Conv2d(cin, mid, 1, bias=False)
        self.bn1 = BatchNorm2d(mid, eps=1e-5)
        self.conv_dw = DepthwiseConv2d(mid, kernel, stride=stride,
                                       padding=kernel // 2)
        self.bn2 = BatchNorm2d(mid, eps=1e-5)
        self.conv_pwl = nn.Conv2d(mid, cout, 1, bias=False)
        self.bn3 = BatchNorm2d(cout, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv_pw(x)))
        h = F.relu(self.bn2(self.conv_dw(h)))
        h = self.bn3(self.conv_pwl(h))
        return h + x if self.skip else h


# mnasnet_b1 (timm `_gen_mnasnet_b1`): each stage's (repeats, kernel,
# stride, expansion, out channels); stage 0 is the depthwise-separable
# block
MNASNET_B1_STAGES = (
    (3, 3, 2, 3, 24),    # blocks.1 -> feat_1 (stride 4)
    (3, 5, 2, 3, 40),    # blocks.2 -> feat_2 (stride 8)
    (3, 5, 2, 6, 80),    # blocks.3
    (2, 3, 1, 6, 96),    # blocks.4 -> feat_3 (stride 16)
    (4, 5, 2, 6, 192),   # blocks.5
    (1, 3, 1, 6, 320),   # blocks.6 -> feat_4 (stride 32)
)
# the stages whose outputs are timm's feature levels 1-4
FEATURE_STAGES = (1, 2, 4, 6)


class MnasNet(nn.Module):
    """mnasnet_100's features: `conv_stem`, `bn1`, `blocks.{s}.{b}`
    (timm's state-dict names). Returns the levels at strides 2-32
    (16, 24, 40, 96, 320 channels)."""

    def __init__(self):
        super().__init__()
        self.conv_stem = nn.Conv2d(3, 32, 3, stride=2, padding=1,
                                   bias=False)
        self.bn1 = BatchNorm2d(32, eps=1e-5)
        stages = [nn.Sequential(MnasDsConv(32, 16))]
        cin = 16
        for repeats, k, stride, exp, cout in MNASNET_B1_STAGES:
            blocks = []
            for b in range(repeats):
                blocks.append(MnasIR(cin, cout, k, stride if b == 0 else 1,
                                     exp))
                cin = cout
            stages.append(nn.Sequential(*blocks))
        self.blocks = nn.Sequential(*stages)

    def forward(self, x: torch.Tensor) -> list:
        x = self.blocks[0](F.relu(self.bn1(self.conv_stem(x))))
        feats = [x]
        for s in range(1, len(self.blocks)):
            x = self.blocks[s](x)
            if s in FEATURE_STAGES:
                feats.append(x)
        return feats


def upsample_nearest_to(x: torch.Tensor, size) -> torch.Tensor:
    """`x` (b, c, h, w) resized to `size` by nearest neighbour as
    `jax.image.resize(..., "nearest")` picks: source index floor((i +
    0.5) * in / out), in float32 as XLA evaluates it, the factor folded
    to in * (1 / out) (neither torch's "nearest" nor its "nearest-exact"
    picks these pixels at every size). An exact 2x is a 2x2 pixel
    repeat, whose backward is a fixed-order sum; other sizes gather.
    The result keeps x's layout: both run on x's (b, h, w, c) view when
    x is channels_last."""
    b, c, h, w = x.shape
    cl = layout.format_of(x) == torch.channels_last
    y = x.permute(0, 2, 3, 1) if cl else x      # dense in memory order
    hd, wd = (1, 2) if cl else (2, 3)
    if tuple(size) == (2 * h, 2 * w):
        shape = list(y.shape)
        shape[hd], shape[wd] = 2 * h, 2 * w
        y = y.unsqueeze(wd + 1).unsqueeze(hd + 1)
        y = y.expand(*y.shape[:hd + 1], 2, y.shape[hd + 2], 2,
                     *y.shape[wd + 3:]).reshape(shape)
    else:
        for dim, (m, n) in ((hd, (h, size[0])), (wd, (w, size[1]))):
            if m != n:
                f32 = np.float32
                factor = f32(m) * (f32(1) / f32(n))
                src = np.floor((np.arange(n, dtype=f32) + f32(0.5)) * factor)
                y = y.index_select(dim, torch.as_tensor(
                    src.astype(np.int64), device=x.device))
    return y.permute(0, 3, 1, 2) if cl else y


class FPNTopDown(nn.Module):
    """The top-down path of torchvision 0.11's
    `FeaturePyramidNetwork(in_channels_list=[16, 24, 40, 96, 320],
    out_channels)` to the stride-4 level: the lateral 1x1 convs
    `inner_blocks.{1..4}` and the 3x3 output conv `layer_blocks.1`. The
    reference's other levels (`inner_blocks.0`, `layer_blocks.{0,2,3,4}`)
    feed outputs that the model never reads: a state dict's entries for
    them are dropped on load."""

    UNUSED = ("inner_blocks.0.", "layer_blocks.0.", "layer_blocks.2.",
              "layer_blocks.3.", "layer_blocks.4.")

    def __init__(self, in_channels=(16, 24, 40, 96, 320),
                 out_channels: int = 32):
        super().__init__()
        self.inner_blocks = nn.ModuleDict(
            {str(i): nn.Conv2d(in_channels[i], out_channels, 1)
             for i in (1, 2, 3, 4)})
        self.layer_blocks = nn.ModuleDict(
            {"1": nn.Conv2d(out_channels, out_channels, 3, padding=1)})
        self.register_load_state_dict_pre_hook(self._drop_unused)

    def _drop_unused(self, module, state_dict, prefix, *args):
        for key in [k for k in state_dict if k.startswith(prefix)
                    and k[len(prefix):].startswith(self.UNUSED)]:
            del state_dict[key]

    def forward(self, feats: list) -> torch.Tensor:
        last = self.inner_blocks["4"](feats[4])
        for idx in (3, 2, 1):
            lateral = self.inner_blocks[str(idx)](feats[idx])
            last = lateral + upsample_nearest_to(last, lateral.shape[-2:])
        return self.layer_blocks["1"](last)


class UNetMatchingEncoder(nn.Module):
    """mnasnet_100 + FPN matching encoder (the reference's
    `modules/networks.py:207-228`) -> `num_ch_out` features at 1/4
    resolution: `encoder` (mnasnet), `decoder` (the FPN's top-down path,
    32 channels), `outconv` (LeakyReLU(0.2), 1x1 conv, InstanceNorm in
    float32), named as the reference state dict."""

    def __init__(self, num_ch_out: int = 16, fpn_channels: int = 32):
        super().__init__()
        self.encoder = MnasNet()
        self.decoder = FPNTopDown(out_channels=fpn_channels)
        self.outconv = nn.Sequential(
            nn.LeakyReLU(0.2),
            nn.Conv2d(fpn_channels, num_ch_out, 1),
            InstanceNorm32())

    def forward(self, image_b3hw: torch.Tensor) -> torch.Tensor:
        return self.outconv(self.decoder(self.encoder(image_b3hw)))
