"""Small image filters used by the losses and by normals from depth
(counterpart of `simplerecon_tpu/ops/image.py`).

Images are NHWC (b, h, w, c), as in the JAX package. Each filter is a
fixed depthwise stencil, written as a sum of shifted slices: a window
that holds a NaN gives NaN, even under a zero tap (the centre column of
the Sobel kernel), exactly as the JAX convolution does. The gradient
loss relies on that NaN propagation to mask pixels near invalid depth.
"""

from __future__ import annotations

import functools
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from simplerecon_tpu_torch.ops import layout

_SOBEL_X = np.array([[-1.0, 0.0, 1.0],
                     [-2.0, 0.0, 2.0],
                     [-1.0, 0.0, 1.0]], dtype=np.float32) / 8.0
_SOBEL_Y = _SOBEL_X.T.copy()
_BINOMIAL3 = np.array([[1.0, 2.0, 1.0],
                       [2.0, 4.0, 2.0],
                       [1.0, 2.0, 1.0]], dtype=np.float32) / 16.0


@functools.lru_cache(maxsize=16)
def _gaussian_kernel_np(kernel_size: int, sigma: float) -> np.ndarray:
    xs = np.arange(kernel_size, dtype=np.float32) - (kernel_size - 1) / 2.0
    g = np.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def _unpad_dim(g: torch.Tensor, dim: int, n: int, before: int,
               after: int, mode: str) -> torch.Tensor:
    """The transpose of padding `dim` from `n` to `before + n + after`:
    each border element's gradient added to the element it copies, in a
    fixed order."""
    out = g.narrow(dim, before, n).clone()
    lo, hi = g.narrow(dim, 0, before), g.narrow(dim, before + n, after)
    if mode == "reflect":   # border element j copies x[before - j], x[n-2-j]
        out.narrow(dim, 1, before).add_(lo.flip(dim))
        out.narrow(dim, n - 1 - after, after).add_(hi.flip(dim))
    else:                   # replicate: every border element copies an edge
        out.narrow(dim, 0, 1).add_(lo.sum(dim, keepdim=True))
        out.narrow(dim, n - 1, 1).add_(hi.sum(dim, keepdim=True))
    return out


def _pad_in_layout(x_bchw: torch.Tensor, pads, mode: str) -> torch.Tensor:
    """`F.pad(x, pads, mode)` in x's layout. On the card F.pad gives a
    channels_last map back NCHW, so such a map is copied into the middle
    of a channels_last one, whose border rows, then columns, are copied
    from the rows and columns they repeat."""
    if layout.format_of(x_bchw) != torch.channels_last:
        return F.pad(x_bchw, pads, mode=mode)
    left, right, top, bottom = pads
    b, c, h, w = x_bchw.shape
    out = torch.empty((b, c, top + h + bottom, left + w + right),
                      dtype=x_bchw.dtype, device=x_bchw.device,
                      memory_format=torch.channels_last)
    out[:, :, top:top + h, left:left + w] = x_bchw
    for dim, n, before, after in ((2, h, top, bottom), (3, w, left, right)):
        # border element j copies x[before - j] (reflect) or x[0], and
        # after the map x[n - 2 - j] or x[n - 1]
        for j in range(before):
            src = before - j if mode == "reflect" else 0
            out.narrow(dim, j, 1).copy_(out.narrow(dim, before + src, 1))
        for j in range(after):
            src = n - 2 - j if mode == "reflect" else n - 1
            out.narrow(dim, before + n + j, 1).copy_(
                out.narrow(dim, before + src, 1))
    return out


class _PadEdges(torch.autograd.Function):
    """F.pad's forward (`_pad_in_layout`), with a backward that sums in a
    fixed order: on the card F.pad's backward adds the border's copies
    with atomics, in no fixed order."""

    @staticmethod
    def forward(ctx, x_bchw, pads, mode):
        ctx.pads, ctx.mode = pads, mode
        ctx.dtype, ctx.hw = x_bchw.dtype, x_bchw.shape[-2:]
        return _pad_in_layout(x_bchw, pads, mode)

    @staticmethod
    def backward(ctx, g):
        left, right, top, bottom = ctx.pads
        g = g.to(torch.promote_types(g.dtype, torch.float32))
        g = _unpad_dim(g, g.dim() - 1, ctx.hw[1], left, right, ctx.mode)
        g = _unpad_dim(g, g.dim() - 2, ctx.hw[0], top, bottom, ctx.mode)
        return g.to(ctx.dtype), None, None


def pad_edges(x_bchw: torch.Tensor, pads, mode: str) -> torch.Tensor:
    """`F.pad(x, (left, right, top, bottom), mode)` for "reflect" and
    "replicate", in x's layout, whose backward sums each element's copies
    in a fixed order (`_PadEdges`); the pad alone where no gradient is
    taken."""
    if mode not in ("reflect", "replicate"):
        raise ValueError(f"unknown pad mode {mode!r}")
    if torch.is_grad_enabled() and x_bchw.requires_grad:
        return _PadEdges.apply(x_bchw, tuple(pads), mode)
    return _pad_in_layout(x_bchw, tuple(pads), mode)


def _pad(x_bhwc: torch.Tensor, pad: int, mode: str) -> torch.Tensor:
    """Pads h and w by `pad` on each side ("reflect" or "replicate")."""
    x = pad_edges(x_bhwc.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode)
    return x.permute(0, 2, 3, 1)


def _stencil(xp_bhwc: torch.Tensor, kernel_hw: np.ndarray,
             stride: int = 1) -> torch.Tensor:
    """VALID correlation of every channel with `kernel_hw`, at `stride`."""
    kh, kw = kernel_hw.shape
    h = (xp_bhwc.shape[1] - kh) // stride + 1
    w = (xp_bhwc.shape[2] - kw) // stride + 1
    out = None
    for i in range(kh):
        for j in range(kw):
            tap = xp_bhwc[:, i:i + stride * (h - 1) + 1:stride,
                          j:j + stride * (w - 1) + 1:stride]
            term = tap * float(kernel_hw[i, j])
            out = term if out is None else out + term
    return out


def gaussian_blur(x_bhwc: torch.Tensor, kernel_size: int = 5,
                  sigma: float = 2.0) -> torch.Tensor:
    """Gaussian blur with reflect padding (kornia.gaussian_blur2d)."""
    return _stencil(_pad(x_bhwc, kernel_size // 2, "reflect"),
                    _gaussian_kernel_np(kernel_size, float(sigma)))


def spatial_gradient(x_bhwc: torch.Tensor) -> torch.Tensor:
    """Normalised Sobel gradients with replicate padding. Returns
    (b, h, w, c, 2) stacking (d/dx, d/dy)."""
    xp = _pad(x_bhwc, 1, "replicate")
    return torch.stack([_stencil(xp, _SOBEL_X), _stencil(xp, _SOBEL_Y)],
                       dim=-1)


def blur_pool(x_bhwc: torch.Tensor) -> torch.Tensor:
    """Anti-aliased 2x downsample: reflect pad 1, binomial 3x3, stride 2."""
    return _stencil(_pad(x_bhwc, 1, "reflect"), _BINOMIAL3, stride=2)


def pyrdown(x_bhwc: torch.Tensor, num_scales: int = 4) -> List[torch.Tensor]:
    """Blur-pool pyramid: [x, down2(x), down4(x), down8(x)]."""
    out = [x_bhwc]
    for _ in range(num_scales - 1):
        out.append(blur_pool(out[-1]))
    return out


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def reverse_imagenet_normalize(image_bhw3: torch.Tensor) -> torch.Tensor:
    """Undoes imagenet normalisation of an NHWC image."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=image_bhw3.dtype,
                        device=image_bhw3.device)
    std = torch.tensor(IMAGENET_STD, dtype=image_bhw3.dtype,
                       device=image_bhw3.device)
    return image_bhw3 * std + mean
