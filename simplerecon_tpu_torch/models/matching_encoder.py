"""ResNet matching encoder (counterpart of
`simplerecon_tpu/models/matching_encoder.py::ResnetMatchingEncoder`).

    net.0 7x7/2 conv -> net.1 BN(eps 1e-5) -> ReLU ->
    net.3 max-pool 2x2/1 + BlurPool(4-tap, reflect pad (1,2,1,2), stride 2)
    -> net.4 layer1 (two torchvision BasicBlocks) ->
    net.5 1x1 conv(128) -> InstanceNorm -> LeakyReLU(0.2) ->
    net.8 3x3 conv(16, replicate pad) -> InstanceNorm

NCHW in, 16-channel features at 1/4 resolution out. The instance norms
run in float32. Module indices are the reference state_dict's.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from simplerecon_tpu_torch.models.layers import InstanceNorm32


class BlurPool(nn.Module):
    """antialiased_cnns.BlurPool(filt_size=4, stride=2): reflect pad
    (1, 2, 1, 2), then the depthwise [1,3,3,1] x [1,3,3,1] / 64 filter."""

    def __init__(self, channels: int):
        super().__init__()
        a = torch.tensor([1.0, 3.0, 3.0, 1.0])
        filt = a[:, None] * a[None, :]
        self.register_buffer(
            "filt", (filt / filt.sum())[None, None].repeat(channels, 1, 1, 1))
        self.channels = channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(x, (1, 2, 1, 2), mode="reflect")
        return F.conv2d(x, self.filt.to(x.dtype), stride=2,
                        groups=self.channels)


class ResNetBasicBlock(nn.Module):
    """torchvision BasicBlock: bias-free convs, BN, ReLU."""

    def __init__(self, planes: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + x)


class ResnetMatchingEncoder(nn.Module):
    """ResNet-18-stem matching encoder -> `num_ch_out` features at 1/4
    resolution.

    `pool_impl` "reference" and "fused" are the same math and run the same
    chain here. "pallas" is the fused max-blur-pool kernel K3, which is not
    ported yet, and raises. Only `norm="batch"` is ported.
    """

    def __init__(self, num_ch_out: int = 16, norm: str = "batch",
                 pool_impl: str = "reference"):
        super().__init__()
        if norm != "batch":
            raise NotImplementedError(
                f"matching_norm={norm!r} is not ported; only 'batch' is")
        if pool_impl == "pallas":
            raise NotImplementedError(
                "matching_pool_impl='pallas' is the fused max-blur-pool "
                "kernel K3, not ported yet (ROADMAP Queue 2, item 4)")
        if pool_impl not in ("reference", "fused"):
            raise ValueError(f"unknown matching_pool_impl {pool_impl!r}")
        self.net = nn.Sequential(
            nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False),      # 0
            nn.BatchNorm2d(64, eps=1e-5),                              # 1
            nn.ReLU(inplace=True),                                     # 2
            nn.Sequential(nn.MaxPool2d(kernel_size=2, stride=1),
                          BlurPool(64)),                               # 3
            nn.Sequential(ResNetBasicBlock(64), ResNetBasicBlock(64)),  # 4
            nn.Conv2d(64, 128, 1),                                     # 5
            InstanceNorm32(),                                          # 6
            nn.LeakyReLU(0.2, inplace=True),                           # 7
            nn.Conv2d(128, num_ch_out, 3, padding=1,
                      padding_mode="replicate"),                       # 8
            InstanceNorm32(),                                          # 9
        )

    def forward(self, image_b3hw: torch.Tensor) -> torch.Tensor:
        return self.net(image_b3hw)
