"""Grid sampling and upsampling (counterpart of
`simplerecon_tpu/ops/sampling.py`).

`grid_sample` keeps the JAX package's NHWC image and flattened (b, n, 2)
grid layout; both functions are `torch.nn.functional` calls with
`align_corners=False`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample(img_bhwc: torch.Tensor, grid_bn2: torch.Tensor
                ) -> torch.Tensor:
    """Samples (b, h, w, c) bilinearly at (b, n, 2) normalised (x, y)
    coordinates with zeros padding. Returns (b, n, c)."""
    b, n, _ = grid_bn2.shape
    out = F.grid_sample(img_bhwc.permute(0, 3, 1, 2),
                        grid_bn2.reshape(b, 1, n, 2).to(img_bhwc.dtype),
                        mode="bilinear", padding_mode="zeros",
                        align_corners=False)           # (b, c, 1, n)
    return out[:, :, 0].transpose(1, 2)


def upsample2x(x_bchw: torch.Tensor) -> torch.Tensor:
    """Bilinear x2 upsample, align_corners=False: the decoder's
    upsampler. NCHW."""
    return F.interpolate(x_bchw, scale_factor=2, mode="bilinear",
                         align_corners=False)
