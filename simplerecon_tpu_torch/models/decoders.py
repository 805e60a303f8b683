"""Cost-volume encoder and UNet++ depth decoder (counterpart of
`simplerecon_tpu/models/decoders.py`), NCHW, with the reference
state_dict names (`convs.<block name>`).

The decoder is the UNet++ grid: row i is an encoder depth (0 = finest),
column j a decoder step. Node (i, j) fuses a "right" edge from (i, j-1),
an upsampled "diag" edge from (i+1, j-1) and, except at each column's
top, an upsampled "up" edge from (i+1, j). Each row's last column
(j = 4 - i) emits log-depth through that row's output head.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn as nn

from simplerecon_tpu_torch.models.layers import BasicBlock, DoubleBasicBlock
from simplerecon_tpu_torch.ops.sampling import upsample2x


class CVEncoder(nn.Module):
    """Block i: a BasicBlock (stride 2 after the first) on the running
    features, concat the image features at that scale, two BasicBlocks."""

    num_ch_outs = (64, 128, 256, 384)

    def __init__(self, num_ch_cv: int, num_ch_enc: Sequence[int]):
        super().__init__()
        num_ch_outs = self.num_ch_outs
        self.convs = nn.ModuleDict()
        for i, cout in enumerate(num_ch_outs):
            cin = num_ch_cv if i == 0 else num_ch_outs[i - 1]
            self.convs[f"ds_conv_{i}"] = BasicBlock(
                cin, cout, stride=1 if i == 0 else 2)
            self.convs[f"conv_{i}"] = nn.Sequential(
                BasicBlock(num_ch_enc[i] + cout, cout),
                BasicBlock(cout, cout))

    def forward(self, cost_volume: torch.Tensor,
                img_feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        x = cost_volume
        outputs = []
        for i in range(len(self.num_ch_outs)):
            x = self.convs[f"ds_conv_{i}"](x)
            x = torch.cat([x, img_feats[i].to(x.dtype)], dim=1)
            x = self.convs[f"conv_{i}"](x)
            outputs.append(x)
        return outputs


class DepthDecoderPP(nn.Module):
    """UNet++ grid decoder -> log-depth at 4 scales, keys
    `log_depth_pred_s{i}_b1hw`, each (b, 1, h_i, w_i)."""

    num_ch_dec = (64, 64, 128, 256)

    def __init__(self, num_ch_enc: Sequence[int]):
        super().__init__()
        num_ch_dec = self.num_ch_dec
        self.convs = nn.ModuleDict()
        for j in range(1, 5):
            for i in range(4 - j, -1, -1):
                cout = num_ch_dec[i]
                cin = num_ch_enc[i + 1] if j == 1 else num_ch_dec[i + 1]
                self.convs[f"diag_conv_{i + 1}{j - 1}"] = BasicBlock(cin, cout)
                cin = num_ch_enc[i] if j == 1 else num_ch_dec[i]
                self.convs[f"right_conv_{i}{j - 1}"] = BasicBlock(cin, cout)
                total = 2 * cout
                if i + j != 4:
                    self.convs[f"up_conv_{i + 1}{j}"] = BasicBlock(
                        num_ch_dec[i + 1], cout)
                    total += cout
                self.convs[f"in_conv_{i}{j}"] = DoubleBasicBlock(total, cout)
        for i in range(4):
            cout = num_ch_dec[i]
            self.convs[f"output_{i}"] = nn.Sequential(
                BasicBlock(cout, cout) if i != 0 else nn.Identity(),
                nn.Conv2d(cout, 1, 1))

    def forward(self, input_features: Sequence[torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        row_latest = list(input_features)  # rows 0..4, finest first
        outputs: Dict[str, torch.Tensor] = {}
        for j in range(1, 5):
            prev = list(row_latest)  # this column's inputs
            below = None             # node of row i+1 in this column
            for i in range(4 - j, -1, -1):
                inputs = [
                    self.convs[f"right_conv_{i}{j - 1}"](prev[i]),
                    upsample2x(self.convs[f"diag_conv_{i + 1}{j - 1}"](
                        prev[i + 1])),
                ]
                if i + j != 4:
                    inputs.append(upsample2x(
                        self.convs[f"up_conv_{i + 1}{j}"](below)))
                node = self.convs[f"in_conv_{i}{j}"](torch.cat(inputs, dim=1))
                row_latest[i] = node
                below = node
                if j == 4 - i:
                    outputs[f"log_depth_pred_s{i}_b1hw"] = \
                        self.convs[f"output_{i}"](node)
        return outputs
