"""Building-block layers (counterpart of `simplerecon_tpu/models/layers.py`).

NCHW modules named as in the reference PyTorch state_dict, so weights
bridged from the JAX package and published checkpoints load unchanged.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


def conv3x3(cin: int, cout: int, stride: int = 1, bias: bool = False
            ) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride, padding=1, bias=bias)


def conv1x1(cin: int, cout: int, stride: int = 1, bias: bool = False
            ) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 1, stride, bias=bias)


class InstanceNorm32(nn.Module):
    """InstanceNorm2d(affine=False) computed in float32 and cast back to
    the input dtype: the JAX package's fp32 instance-norm island."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=(2, 3), keepdim=True)
        var = xf.var(dim=(2, 3), keepdim=True, unbiased=False)
        return ((xf - mean) * torch.rsqrt(var + self.eps)).to(x.dtype)


class BasicBlock(nn.Module):
    """ResNet basic block with Identity norm (conv bias on) and
    LeakyReLU(0.2). The shortcut is a 1x1 conv when only the channels
    change and a 3x3 conv at stride 2."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = conv3x3(cin, cout, stride, bias=True)
        self.conv2 = conv3x3(cout, cout, 1, bias=True)
        self.downsample = None
        if cin != cout or stride != 1:
            conv = (conv1x1(cin, cout, bias=True) if stride == 1
                    else conv3x3(cin, cout, stride, bias=True))
            self.downsample = nn.Sequential(conv, nn.Identity())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.leaky_relu(self.conv1(x), 0.2)
        out = self.conv2(out)
        identity = x if self.downsample is None else self.downsample(x)
        return F.leaky_relu(out + identity, 0.2)


class DoubleBasicBlock(nn.Sequential):
    """Two chained BasicBlocks."""

    def __init__(self, cin: int, cout: int):
        super().__init__(BasicBlock(cin, cout), BasicBlock(cout, cout))


class MLP(nn.Module):
    """Linear stack with LeakyReLU(0.01) between layers; the last layer
    is linear."""

    def __init__(self, channel_list: Sequence[int]):
        super().__init__()
        layers = []
        for i in range(len(channel_list) - 1):
            layers.append(nn.Linear(channel_list[i], channel_list[i + 1]))
            layers.append(nn.LeakyReLU(0.01))
        self.net = nn.Sequential(*layers[:-1])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)

    def dense_params(self):
        """[(weight (out, in), bias), ...] of the Linear layers."""
        return [(m.weight, m.bias) for m in self.net
                if isinstance(m, nn.Linear)]
