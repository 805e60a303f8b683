"""EfficientNetV2-S feature extractor (counterpart of
`simplerecon_tpu/models/efficientnet.py`), features_only.

TF "SAME" padding (asymmetric: the extra row and column go bottom and
right) and BatchNorm(eps=1e-3) with flax's running-statistics rule
(`layers.BatchNorm2d`), with timm's state_dict names (conv_stem, bn1,
blocks.{stage}.{block}.*). Returns the 5 feature maps
after stages (0, 1, 2, 4, 5): strides 2..32, channels 24/48/64/160/256.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from simplerecon_tpu_torch.models.layers import BatchNorm2d
from simplerecon_tpu_torch.ops import layout

# (block_type, repeats, stride, expand, channels, se_ratio)
V2_S_CONFIG = (
    ("cn", 2, 1, 1, 24, 0.0),
    ("er", 4, 2, 4, 48, 0.0),
    ("er", 4, 2, 4, 64, 0.0),
    ("ir", 6, 2, 4, 128, 0.25),
    ("ir", 9, 1, 6, 160, 0.25),
    ("ir", 15, 2, 6, 256, 0.25),
)
V2_S_FEATURE_STAGES = (0, 1, 2, 4, 5)
V2_S_FEATURE_CHANNELS = (24, 48, 64, 160, 256)
V2_S_STEM_CHANNELS = 24


class Conv2dSame(nn.Conv2d):
    """Conv2d with TF "SAME" padding: total pad
    max((ceil(i/s) - 1) * s + k - i, 0), the smaller half on top/left. A
    depthwise one (groups = channels) runs on NCHW maps, as
    `layers.DepthwiseConv2d` does."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.groups > 1 and self.groups == self.in_channels:
            return layout.on_nchw(self._same, x)
        return self._same(x)

    def _same(self, x: torch.Tensor) -> torch.Tensor:
        ih, iw = x.shape[-2:]
        kh, kw = self.kernel_size
        sh, sw = self.stride
        ph = max((-(-ih // sh) - 1) * sh + kh - ih, 0)
        pw = max((-(-iw // sw) - 1) * sw + kw - iw, 0)
        if ph or pw:
            x = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        return F.conv2d(x, self.weight, self.bias, self.stride, 0,
                        self.dilation, self.groups)


def _conv(cin, cout, k, stride=1, groups=1):
    if k == 1:
        return nn.Conv2d(cin, cout, 1, bias=False)
    return Conv2dSame(cin, cout, k, stride, groups=groups, bias=False)


def _bn(ch):
    return BatchNorm2d(ch, eps=1e-3)


class ConvBnAct(nn.Module):
    def __init__(self, cin, cout, stride):
        super().__init__()
        self.conv = _conv(cin, cout, 3, stride)
        self.bn1 = _bn(cout)
        self.has_skip = stride == 1 and cin == cout

    def forward(self, x):
        out = F.silu(self.bn1(self.conv(x)))
        return out + x if self.has_skip else out


class EdgeResidual(nn.Module):
    """FusedMBConv: fused 3x3 expand conv, then pointwise-linear."""

    def __init__(self, cin, cout, stride, expand):
        super().__init__()
        mid = cin * expand
        self.conv_exp = _conv(cin, mid, 3, stride)
        self.bn1 = _bn(mid)
        self.conv_pwl = _conv(mid, cout, 1)
        self.bn2 = _bn(cout)
        self.has_skip = stride == 1 and cin == cout

    def forward(self, x):
        out = F.silu(self.bn1(self.conv_exp(x)))
        out = self.bn2(self.conv_pwl(out))
        return out + x if self.has_skip else out


class SqueezeExcite(nn.Module):
    def __init__(self, ch, rd):
        super().__init__()
        self.conv_reduce = nn.Conv2d(ch, rd, 1)
        self.conv_expand = nn.Conv2d(rd, ch, 1)

    def forward(self, x):
        s = x.mean((2, 3), keepdim=True)
        s = F.silu(self.conv_reduce(s))
        return x * torch.sigmoid(self.conv_expand(s))


class InvertedResidual(nn.Module):
    """MBConv: pointwise expand, depthwise 3x3, squeeze-excite (reduce
    width from the block's input channels), pointwise-linear."""

    def __init__(self, cin, cout, stride, expand, se_ratio):
        super().__init__()
        mid = cin * expand
        self.conv_pw = _conv(cin, mid, 1)
        self.bn1 = _bn(mid)
        self.conv_dw = _conv(mid, mid, 3, stride, groups=mid)
        self.bn2 = _bn(mid)
        self.se = SqueezeExcite(mid, max(1, round(cin * se_ratio)))
        self.conv_pwl = _conv(mid, cout, 1)
        self.bn3 = _bn(cout)
        self.has_skip = stride == 1 and cin == cout

    def forward(self, x):
        out = F.silu(self.bn1(self.conv_pw(x)))
        out = F.silu(self.bn2(self.conv_dw(out)))
        out = self.bn3(self.conv_pwl(self.se(out)))
        return out + x if self.has_skip else out


class EfficientNetV2Features(nn.Module):
    """EfficientNetV2 backbone returning the 5-scale feature pyramid."""

    num_ch_enc = V2_S_FEATURE_CHANNELS

    def __init__(self):
        super().__init__()
        self.conv_stem = _conv(3, V2_S_STEM_CHANNELS, 3, 2)
        self.bn1 = _bn(V2_S_STEM_CHANNELS)
        stages = []
        cin = V2_S_STEM_CHANNELS
        for btype, repeats, stride, expand, cout, se in V2_S_CONFIG:
            blocks = []
            for bi in range(repeats):
                s = stride if bi == 0 else 1
                if btype == "cn":
                    blocks.append(ConvBnAct(cin, cout, s))
                elif btype == "er":
                    blocks.append(EdgeResidual(cin, cout, s, expand))
                elif btype == "ir":
                    blocks.append(InvertedResidual(cin, cout, s, expand, se))
                else:
                    raise ValueError(btype)
                cin = cout
            stages.append(nn.Sequential(*blocks))
        self.blocks = nn.Sequential(*stages)

    def forward(self, image_b3hw: torch.Tensor) -> List[torch.Tensor]:
        x = F.silu(self.bn1(self.conv_stem(image_b3hw)))
        feats = []
        for si, stage in enumerate(self.blocks):
            x = stage(x)
            if si in V2_S_FEATURE_STAGES:
                feats.append(x)
        return feats
