"""Plain float32 operations of the reference model: camera geometry, the
fixed image stencils of the losses, bilinear and nearest sampling, and
the lower-precision rounding of the control.

A frozen copy of SimpleRecon's layer equations, written for this
benchmark. It imports nothing of the measured program.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))
SOBEL_Y = tuple(zip(*SOBEL_X))
BINOMIAL3 = ((1.0, 2.0, 1.0), (2.0, 4.0, 2.0), (1.0, 2.0, 1.0))


# --------------------------------------------------------------------------
# precision: float32, or the control's fp8
# --------------------------------------------------------------------------

FP8_FORWARD = torch.float8_e4m3fn
FP8_BACKWARD = torch.float8_e5m2


def _fp8_round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`x` rounded to `dtype` under a per-tensor scale that maps its
    largest magnitude to the format's largest finite value, and back."""
    top = torch.finfo(dtype).max
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = top / amax
    return ((x.float() * scale).clamp(-top, top).to(dtype).float()
            / scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    """Rounds the value to e4m3 going forward and its gradient to e5m2
    going back, as fp8 training does at a product's operands."""

    @staticmethod
    def forward(ctx, x):
        return _fp8_round(x, FP8_FORWARD)

    @staticmethod
    def backward(ctx, g):
        return _fp8_round(g, FP8_BACKWARD)


def rounded(x: torch.Tensor, precision: str) -> torch.Tensor:
    """`x` as the product it feeds sees it: unchanged in "float32", at
    fp8 in the control's "fp8"."""
    if precision == "float32":
        return x
    if precision == "fp8":
        return _Fp8.apply(x)
    raise ValueError(f"unknown precision {precision!r}")


# --------------------------------------------------------------------------
# geometry (4x4 matrices on column vectors, pixel centres at +0.5)
# --------------------------------------------------------------------------

def pixel_grid(height: int, width: int, device=None) -> torch.Tensor:
    ys, xs = torch.meshgrid(
        torch.arange(height, device=device, dtype=torch.float32) + 0.5,
        torch.arange(width, device=device, dtype=torch.float32) + 0.5,
        indexing="ij")
    return torch.stack([xs, ys, torch.ones_like(xs)], -1).reshape(-1, 3)


def backproject_depth(depth_bhw, invK_b44):
    b, h, w = depth_bhw.shape
    rays = pixel_grid(h, w, depth_bhw.device) @ invK_b44[:, :3, :3].transpose(
        1, 2)
    return rays * depth_bhw.reshape(b, h * w, 1)


def transform_points(M_b44, points_bN3):
    return (points_bN3 @ M_b44[..., :3, :3].transpose(-1, -2)
            + M_b44[..., None, :3, 3])


def project_points(points_bN3, K_b44, cam_T_world_b44, eps: float = 1e-8):
    """(u, v, z + eps); pixels divided by z + eps where |z| > eps."""
    P = K_b44 @ cam_T_world_b44
    cam = points_bN3 @ P[..., :3, :3].transpose(-1, -2) + P[..., None, :3, 3]
    z = cam[..., 2:3]
    z_eps = z + eps
    scale = torch.where(z.abs() > eps, 1.0 / z_eps, torch.ones_like(z_eps))
    return torch.cat([cam[..., :2] * scale, z_eps], -1)


def normalize(v, eps: float = 1e-12):
    n = torch.sqrt(torch.sum(v * v, -1, keepdim=True) + 1e-30)
    return v / torch.clamp(n, min=eps)


def pose_distance(pose_b44):
    """DVMVS pose distance: (combined, rotation, translation)."""
    trace = pose_b44[..., 0, 0] + pose_b44[..., 1, 1] + pose_b44[..., 2, 2]
    r = torch.sqrt(torch.clamp(2.0 * (1.0 - torch.clamp(trace, max=3.0) / 3.0),
                               min=0.0))
    t = torch.linalg.vector_norm(pose_b44[..., :3, 3], dim=-1)
    return torch.sqrt(t ** 2 + r ** 2), r, t


def cosine_similarity(a, b, eps: float = 1e-5):
    dot = torch.sum(a * b, -1)
    na = torch.clamp(torch.linalg.vector_norm(a, dim=-1), min=eps)
    nb = torch.clamp(torch.linalg.vector_norm(b, dim=-1), min=eps)
    return dot / (na * nb)


# --------------------------------------------------------------------------
# image stencils (NHWC; a window holding a NaN gives NaN)
# --------------------------------------------------------------------------

def _pad_hw(x_bhwc, pad: int, mode: str):
    x = F.pad(x_bhwc.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode=mode)
    return x.permute(0, 2, 3, 1)


def _stencil(xp_bhwc, kernel, scale: float, stride: int = 1):
    kh, kw = len(kernel), len(kernel[0])
    h = (xp_bhwc.shape[1] - kh) // stride + 1
    w = (xp_bhwc.shape[2] - kw) // stride + 1
    out = None
    for i in range(kh):
        for j in range(kw):
            tap = xp_bhwc[:, i:i + stride * (h - 1) + 1:stride,
                          j:j + stride * (w - 1) + 1:stride]
            term = tap * (kernel[i][j] * scale)
            out = term if out is None else out + term
    return out


def gaussian_blur(x_bhwc, kernel_size: int = 5, sigma: float = 2.0):
    xs = torch.arange(kernel_size, dtype=torch.float64) - (kernel_size - 1) / 2
    g = torch.exp(-(xs ** 2) / (2.0 * sigma ** 2)).float()
    g = (g / g.sum()).tolist()
    kernel = [[a * b for b in g] for a in g]
    return _stencil(_pad_hw(x_bhwc, kernel_size // 2, "reflect"), kernel, 1.0)


def spatial_gradient(x_bhwc):
    """Sobel (d/dx, d/dy) / 8 with replicate padding: (b, h, w, c, 2)."""
    xp = _pad_hw(x_bhwc, 1, "replicate")
    return torch.stack([_stencil(xp, SOBEL_X, 1 / 8),
                        _stencil(xp, SOBEL_Y, 1 / 8)], -1)


def pyrdown(x_bhwc, num_scales: int = 4) -> List[torch.Tensor]:
    out = [x_bhwc]
    for _ in range(num_scales - 1):
        out.append(_stencil(_pad_hw(out[-1], 1, "reflect"), BINOMIAL3,
                            1 / 16, stride=2))
    return out


def normals_from_depth(depth_bhw, invK_b44):
    b, h, w = depth_bhw.shape
    smooth = gaussian_blur(depth_bhw[..., None])[..., 0]
    points = backproject_depth(smooth, invK_b44).reshape(b, h, w, 3)
    grads = spatial_gradient(points)
    return normalize(torch.linalg.cross(grads[..., 0], grads[..., 1], dim=-1))


# --------------------------------------------------------------------------
# sampling (align_corners=False)
# --------------------------------------------------------------------------

def grid_sample(img_bhwc, grid_bn2):
    """Bilinear samples of (b, h, w, c) at (b, n, 2) normalised (x, y),
    zeros outside: (b, n, c)."""
    b, n, _ = grid_bn2.shape
    out = F.grid_sample(img_bhwc.permute(0, 3, 1, 2),
                        grid_bn2.reshape(b, 1, n, 2), mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return out[:, :, 0].transpose(1, 2)


def sample_nearest(img_bhwc, grid_bn2):
    """Nearest samples (round half to even), zeros outside or at NaN."""
    b, h, w, c = img_bhwc.shape
    x = ((grid_bn2[..., 0] + 1.0) * w - 1.0) / 2.0
    y = ((grid_bn2[..., 1] + 1.0) * h - 1.0) / 2.0
    rx, ry = torch.round(x), torch.round(y)
    valid = (rx >= 0) & (rx <= w - 1) & (ry >= 0) & (ry <= h - 1)
    idx = torch.where(valid, ry * w + rx, torch.zeros_like(rx)).long()
    out = torch.gather(img_bhwc.reshape(b, h * w, c), 1,
                       idx[..., None].expand(b, idx.shape[1], c))
    return torch.where(valid[..., None], out, torch.zeros_like(out))


def resize_nearest(img_bhwc, out_h: int, out_w: int):
    """src = floor(dst * in / out)."""
    b, h, w, c = img_bhwc.shape
    dev = img_bhwc.device
    ys = torch.floor(torch.arange(out_h, dtype=torch.float32, device=dev)
                     * (h / out_h)).long().clamp(0, h - 1)
    xs = torch.floor(torch.arange(out_w, dtype=torch.float32, device=dev)
                     * (w / out_w)).long().clamp(0, w - 1)
    return img_bhwc[:, ys][:, :, xs]
