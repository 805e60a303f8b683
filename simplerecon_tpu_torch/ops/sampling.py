"""Grid sampling and upsampling (counterpart of
`simplerecon_tpu/ops/sampling.py`).

`grid_sample` and `sample_nearest` keep the JAX package's NHWC image and
flattened (b, n, 2) grid layout; every function follows
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


def sample_nearest(img_bhwc: torch.Tensor, grid_bn2: torch.Tensor
                   ) -> torch.Tensor:
    """Nearest sampling of (b, h, w, c) at (b, n, 2) normalised (x, y)
    coordinates, align_corners=False: index round(coord) (half to even,
    as torch.round), zeros outside the image or at NaN coordinates.
    Returns (b, n, c). The counterpart of the JAX one-hot sampler
    `sample_nearest_matmul`, as a gather."""
    b, h, w, c = img_bhwc.shape
    x = ((grid_bn2[..., 0].float() + 1.0) * w - 1.0) / 2.0
    y = ((grid_bn2[..., 1].float() + 1.0) * h - 1.0) / 2.0
    rx, ry = torch.round(x), torch.round(y)
    valid = (rx >= 0) & (rx <= w - 1) & (ry >= 0) & (ry <= h - 1)
    idx = torch.where(valid, ry * w + rx, torch.zeros_like(rx)).long()
    out = torch.gather(img_bhwc.reshape(b, h * w, c), 1,
                       idx[..., None].expand(b, idx.shape[1], c))
    return torch.where(valid[..., None], out, torch.zeros_like(out))


def resize_nearest(img_bhwc: torch.Tensor, out_h: int, out_w: int
                   ) -> torch.Tensor:
    """Nearest resize of (b, h, w, c) with src = floor(dst * in / out),
    F.interpolate(mode="nearest")'s rule."""
    b, h, w, c = img_bhwc.shape
    dev = img_bhwc.device
    ys = torch.floor(torch.arange(out_h, dtype=torch.float32, device=dev)
                     * (h / out_h)).long().clamp(0, h - 1)
    xs = torch.floor(torch.arange(out_w, dtype=torch.float32, device=dev)
                     * (w / out_w)).long().clamp(0, w - 1)
    return img_bhwc[:, ys][:, :, xs]


def _up2x_transpose(g: torch.Tensor, dim: int) -> torch.Tensor:
    """The transpose of the bilinear x2 upsample (align_corners=False)
    along `dim`: output 2i takes 3/4 of input i and 1/4 of input i-1,
    output 2i+1 3/4 of i and 1/4 of i+1, indices clamped to the edges."""
    shape = list(g.shape)
    shape[dim] //= 2
    shape.insert(dim + 1, 2)
    pairs = g.reshape(shape)
    ge, go = pairs.select(dim + 1, 0), pairs.select(dim + 1, 1)
    n = ge.shape[dim]
    out = 0.75 * (ge + go)
    # 1/4 of output 2i reaches input i-1 (input 0 for i = 0), 1/4 of
    # output 2i+1 input i+1 (input n-1 for i = n-1)
    left = torch.zeros_like(out)
    left.narrow(dim, 0, n - 1).add_(ge.narrow(dim, 1, n - 1))
    left.narrow(dim, 0, 1).add_(ge.narrow(dim, 0, 1))
    right = torch.zeros_like(out)
    right.narrow(dim, 1, n - 1).add_(go.narrow(dim, 0, n - 1))
    right.narrow(dim, n - 1, 1).add_(go.narrow(dim, n - 1, 1))
    return out + 0.25 * left + 0.25 * right


class _Upsample2x(torch.autograd.Function):
    """F.interpolate's bilinear x2 forward, with a backward that sums in a
    fixed order: on the card F.interpolate's backward adds with atomics,
    in no fixed order."""

    @staticmethod
    def forward(ctx, x_bchw):
        ctx.dtype = x_bchw.dtype
        return F.interpolate(x_bchw, scale_factor=2, mode="bilinear",
                             align_corners=False)

    @staticmethod
    def backward(ctx, g):
        g = g.to(torch.promote_types(g.dtype, torch.float32))
        return _up2x_transpose(_up2x_transpose(g, 3), 2).to(ctx.dtype)


def upsample2x(x_bchw: torch.Tensor) -> torch.Tensor:
    """Bilinear x2 upsample, align_corners=False: the decoder's
    upsampler. NCHW. Its backward sums in a fixed order (`_Upsample2x`);
    F.interpolate itself where no gradient is taken."""
    if torch.is_grad_enabled() and x_bchw.requires_grad:
        return _Upsample2x.apply(x_bchw)
    return F.interpolate(x_bchw, scale_factor=2, mode="bilinear",
                         align_corners=False)
