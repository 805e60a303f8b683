"""ResNet matching encoder (counterpart of
`simplerecon_tpu/models/matching_encoder.py::ResnetMatchingEncoder`).

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

import torch
import torch.nn as nn
import torch.nn.functional as F

from simplerecon_tpu_torch.models.layers import (BatchNorm2d, GroupNorm32,
                                                InstanceNorm32)
from simplerecon_tpu_torch.ops import pool
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
    filter; "reference" and "fused" run the two modules."""

    def __init__(self, channels: int, impl: str):
        super().__init__(nn.MaxPool2d(kernel_size=2, stride=1),
                         BlurPool(channels))
        self.impl = impl

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.impl == "pallas":
            return pool.MaxBlurPool.apply(x)
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
