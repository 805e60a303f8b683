"""Building-block layers (counterpart of `simplerecon_tpu/models/layers.py`).

NCHW modules named as in the reference PyTorch state_dict, so weights
bridged from the JAX package and published checkpoints load unchanged.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from simplerecon_tpu_torch.ops import layout


def conv3x3(cin: int, cout: int, stride: int = 1, bias: bool = False
            ) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride, padding=1, bias=bias)


def conv1x1(cin: int, cout: int, stride: int = 1, bias: bool = False
            ) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 1, stride, bias=bias)


class DepthwiseConv2d(nn.Conv2d):
    """`nn.Conv2d` with one filter a channel (groups = channels), run on
    NCHW maps (`layout.on_nchw`): PyTorch's NCHW depthwise kernels, where
    cuDNN's channels_last ones are compiled at a process's first use."""

    def __init__(self, channels: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, bias: bool = False):
        super().__init__(channels, channels, kernel_size, stride, padding,
                         groups=channels, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layout.on_nchw(super().forward, x)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with flax's running-statistics rule.

    In train mode it normalises with the batch mean and biased variance,
    as `nn.BatchNorm2d` does, and updates
        running = 0.9 * running + 0.1 * batch
    with the *biased* batch variance, as flax's `nn.BatchNorm(momentum=
    0.9)` does; `nn.BatchNorm2d` would store the unbiased one, n/(n-1)
    times larger. State-dict names are `nn.BatchNorm2d`'s.
    """

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        # batch_norm updates copies (the backward keeps them, so the
        # buffers themselves may not change in place under it); the
        # copy of running_var gets (1 - m) * old + m * the unbiased var
        mean, var = self.running_mean.clone(), self.running_var.clone()
        out = F.batch_norm(x, mean, var, self.weight, self.bias, True,
                           self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            old = (1 - self.momentum) * self.running_var
            self.running_var = old + (var - old) * ((n - 1) / n)
            self.running_mean = mean
            self.num_batches_tracked.add_(1)
        return out


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


class GroupNorm32(nn.GroupNorm):
    """GroupNorm (8 groups by default, eps 1e-5) computed in float32 and
    cast back to the input dtype, as flax's `nn.GroupNorm(dtype=...)`
    normalises in float32. It keeps no running statistics, so train and
    eval mode give the same output. State-dict names are
    `nn.GroupNorm`'s: `weight` and `bias`. On the card F.group_norm
    takes and gives NCHW maps: a channels_last map is laid out NCHW with
    its cast to float32 and back with the cast back (`layout.relayout`,
    counted where there is no cast)."""

    def __init__(self, num_channels: int, num_groups: int = 8,
                 eps: float = 1e-5):
        super().__init__(num_groups, num_channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.group_norm(
            layout.relayout(x, torch.contiguous_format, torch.float32),
            self.num_groups, self.weight, self.bias, self.eps)
        return layout.relayout(out, layout.format_of(x), x.dtype)


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
