"""Visualization on the host with numpy (counterpart of
`simplerecon_tpu/utils/visualization.py`): the turbo colormap, robust
depth ranges, colormapped depth, normals from depth, the validation
panels of the training CLI, the eval CLI's `quick_viz_export` and
`write_video` (mp4 through OpenCV, imported when called, else PNGs).

PNGs are written with `zlib` and `struct` (8-bit grey, RGB or RGBA, or
16-bit grey; no filter), so no image library is needed; they hold the pixels that the
JAX package's Pillow writer gives.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, List, Optional

import numpy as np
import torch

from simplerecon_tpu_torch.data.io import reverse_imagenet_normalize_np

# Polynomial approximation of the Turbo colormap (Google, public),
# matching matplotlib's "turbo" to visual accuracy.
_TURBO_R = (0.13572138, 4.61539260, -42.66032258, 132.13108234,
            -152.94239396, 59.28637943)
_TURBO_G = (0.09140261, 2.19418839, 4.84296658, -14.18503333,
            4.27729857, 2.82956604)
_TURBO_B = (0.10667330, 12.64194608, -60.58204836, 110.36276771,
            -89.90310912, 27.34824973)

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour types by channel count: grey, RGB, RGBA
_COLOR_TYPES = {1: 0, 3: 2, 4: 6}


def _poly(x, coeffs):
    out = np.zeros_like(x)
    for c in reversed(coeffs):
        out = out * x + c
    return out


def turbo_colormap(x01: np.ndarray) -> np.ndarray:
    """Maps values in [0, 1] to RGB in [0, 1], shape (..., 3)."""
    x = np.clip(x01, 0.0, 1.0)
    rgb = np.stack([_poly(x, _TURBO_R), _poly(x, _TURBO_G),
                    _poly(x, _TURBO_B)], axis=-1)
    return np.clip(rgb, 0.0, 1.0)


def normalize_depth_robust(depth_hw: np.ndarray,
                           robust_percentile: float = 5.0,
                           mask: Optional[np.ndarray] = None):
    """Percentile-robust (vmin, vmax) of the finite depths."""
    vals = depth_hw[mask] if mask is not None else depth_hw
    vals = vals[np.isfinite(vals)]
    if vals.size == 0:
        return 0.0, 1.0
    vmin = float(np.percentile(vals, robust_percentile))
    vmax = float(np.percentile(vals, 100 - robust_percentile))
    if vmax <= vmin:
        vmax = vmin + 1e-6
    return vmin, vmax


def colormap_image(depth_hw: np.ndarray, vmin: Optional[float] = None,
                   vmax: Optional[float] = None,
                   invalid_color=(0.47, 0.47, 0.47)) -> np.ndarray:
    """Turbo-colormapped image (h, w, 3) in [0, 1]; NaN and inf pixels
    get `invalid_color`."""
    finite = np.isfinite(depth_hw)
    if vmin is None or vmax is None:
        auto_min, auto_max = normalize_depth_robust(depth_hw)
        vmin = auto_min if vmin is None else vmin
        vmax = auto_max if vmax is None else vmax
    x = (np.where(finite, depth_hw, vmin) - vmin) / max(vmax - vmin, 1e-9)
    rgb = turbo_colormap(x)
    rgb[~finite] = invalid_color
    return rgb


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(pixels: np.ndarray) -> bytes:
    """The PNG file of an image (h, w) or (h, w, 1, 3 or 4): uint16 as
    16-bit samples (big-endian, as PNG stores them), anything else as
    uint8."""
    arr = np.asarray(pixels)
    depth = 16 if arr.dtype == np.uint16 else 8
    arr = arr.astype(">u2") if depth == 16 else np.asarray(arr, np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, ch = arr.shape
    header = struct.pack(">IIBBBBB", w, h, depth, _COLOR_TYPES[ch], 0, 0, 0)
    # each row: filter type 0 (none), then its bytes
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           arr.view(np.uint8).reshape(h, -1)], axis=1)
    return (PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def save_image(path: str, image01) -> str:
    """Writes an image in [0, 1] ((h, w) or (h, w, c)) as an 8-bit PNG;
    values are scaled by 255 and truncated, as the JAX package does."""
    arr = np.clip(np.asarray(image01) * 255.0, 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(encode_png(arr))
    return path


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def quick_viz_export(viz_path: str, outputs: Dict, cur_data: Dict,
                     batch_ind: int = 0, prefix: str = "") -> List[str]:
    """Writes the colour image, the predicted depth, the GT depth and the
    lowest-cost depth of one batch element as PNGs (pred and GT share
    the GT's robust range); `outputs` and `cur_data` may hold tensors on
    any device or numpy arrays. Returns the paths written."""
    os.makedirs(viz_path, exist_ok=True)
    written = []

    image = _host(cur_data["image_b3hw"][batch_ind])
    rgb = reverse_imagenet_normalize_np(image).transpose(1, 2, 0)
    written.append(save_image(
        os.path.join(viz_path, f"{prefix}color.png"), rgb))

    depth_pred = _host(outputs["depth_pred_s0_bhw1"][batch_ind, ..., 0])
    gt = None
    if "full_res_depth_b1hw" in cur_data:
        gt = _host(cur_data["full_res_depth_b1hw"][batch_ind, 0])
    elif "depth_b1hw" in cur_data:
        gt = _host(cur_data["depth_b1hw"][batch_ind, 0])

    vmin, vmax = normalize_depth_robust(gt if gt is not None
                                        else depth_pred)
    written.append(save_image(
        os.path.join(viz_path, f"{prefix}depth_pred.png"),
        colormap_image(depth_pred, vmin, vmax)))
    if gt is not None:
        written.append(save_image(
            os.path.join(viz_path, f"{prefix}depth_gt.png"),
            colormap_image(gt, vmin, vmax)))

    if outputs.get("lowest_cost_bhw") is not None:
        lc = _host(outputs["lowest_cost_bhw"][batch_ind])
        written.append(save_image(
            os.path.join(viz_path, f"{prefix}lowest_cost.png"),
            colormap_image(lc, vmin, vmax)))
    return written


def write_video(path: str, frames01: List[np.ndarray], fps: int = 30
                ) -> str:
    """Writes frames in [0, 1] ((h, w, 3) RGB) as an mp4 through OpenCV
    when it imports and writes; otherwise as a PNG sequence in the
    directory `path` without its extension. Returns what it wrote."""
    try:
        import cv2
        h, w = frames01[0].shape[:2]
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                                 fps, (w, h))
        for f in frames01:
            bgr = (np.clip(f, 0, 1)[..., ::-1] * 255).astype(np.uint8)
            writer.write(bgr)
        writer.release()
        return path
    except Exception:
        base = os.path.splitext(path)[0]
        os.makedirs(base, exist_ok=True)
        for i, f in enumerate(frames01):
            save_image(os.path.join(base, f"{i:06d}.png"), f)
        return base


def _resize_nearest_np(img_hwc: np.ndarray, h: int, w: int) -> np.ndarray:
    sh, sw = img_hwc.shape[:2]
    ri = (np.arange(h) * sh // h).clip(0, sh - 1)
    ci = (np.arange(w) * sw // w).clip(0, sw - 1)
    return img_hwc[ri][:, ci]


def _conv2_same_np(x_hw: np.ndarray, k: np.ndarray,
                   pad_mode: str) -> np.ndarray:
    """Same-size 2D correlation with reflect or edge padding."""
    kh, kw = k.shape
    ph, pw = kh // 2, kw // 2
    xp = np.pad(x_hw, ((ph, ph), (pw, pw)),
                mode="reflect" if pad_mode == "reflect" else "edge")
    out = np.zeros_like(x_hw, dtype=np.float32)
    for i in range(kh):
        for j in range(kw):
            out += k[i, j] * xp[i:i + x_hw.shape[0], j:j + x_hw.shape[1]]
    return out


def normals_from_depth_np(depth_hw: np.ndarray, invK_44: np.ndarray,
                          kernel_size: int = 5,
                          sigma: float = 2.0) -> np.ndarray:
    """Normals of a depth map on the host, as `ops.geometry.
    normals_from_depth` computes them: Gaussian blur, back-projection of
    pixel centres, Sobel/8 gradients, their cross product, normalised.
    Returns (h, w, 3) unit normals (NaN where depth is NaN)."""
    h, w = depth_hw.shape
    ax = np.arange(kernel_size, dtype=np.float32) - (kernel_size - 1) / 2
    g1 = np.exp(-0.5 * (ax / sigma) ** 2)
    g1 /= g1.sum()
    g2 = np.outer(g1, g1)
    depth = _conv2_same_np(np.asarray(depth_hw, np.float32), g2, "reflect")

    xs = np.arange(w, dtype=np.float32) + 0.5
    ys = np.arange(h, dtype=np.float32) + 0.5
    xx, yy = np.meshgrid(xs, ys)
    pix = np.stack([xx, yy, np.ones_like(xx)], -1)          # (h, w, 3)
    rays = pix @ np.asarray(invK_44, np.float32)[:3, :3].T
    points = rays * depth[..., None]                        # (h, w, 3)

    sobel_x = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]],
                       np.float32) / 8.0
    gx = np.stack([_conv2_same_np(points[..., c], sobel_x, "edge")
                   for c in range(3)], -1)
    gy = np.stack([_conv2_same_np(points[..., c], sobel_x.T, "edge")
                   for c in range(3)], -1)
    n = np.cross(gx, gy)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    return n / np.maximum(norm, 1e-12)


def build_image_panels(cur_data: Dict, outputs: Dict,
                       max_items: int = 4) -> np.ndarray:
    """Validation panels: for up to `max_items` batch elements a row of
    [RGB | GT depth | predicted depth | predicted normals | lowest-cost
    depth] tiles, GT and predictions in the GT's robust range. Inputs
    may hold tensors on any device or numpy arrays. Returns
    (N, H, 5 * W, 3) float in [0, 1]."""
    images = _host(cur_data["image_b3hw"])
    n = min(max_items, images.shape[0])
    panels = []
    for i in range(n):
        image = images[i].astype(np.float32)
        rgb = np.clip(reverse_imagenet_normalize_np(image), 0, 1
                      ).transpose(1, 2, 0)
        h, w = rgb.shape[:2]

        if "depth_bhw" in cur_data:
            gt = _host(cur_data["depth_bhw"][i]).astype(np.float32)
        elif "depth_b1hw" in cur_data:
            gt = _host(cur_data["depth_b1hw"][i, 0]).astype(np.float32)
        else:
            gt = None
        pred = _host(outputs["depth_pred_s0_bhw1"][i, ..., 0]
                     ).astype(np.float32)
        vmin, vmax = normalize_depth_robust(gt if gt is not None else pred)

        tiles = [rgb]
        tiles.append(_resize_nearest_np(
            colormap_image(gt, vmin, vmax) if gt is not None
            else np.zeros_like(rgb), h, w))
        tiles.append(_resize_nearest_np(colormap_image(pred, vmin, vmax),
                                        h, w))
        if outputs.get("normals_pred_bhw3") is not None:
            nrm = _host(outputs["normals_pred_bhw3"][i]).astype(np.float32)
            nrm = np.clip(np.nan_to_num(0.5 * (nrm + 1.0)), 0, 1)
            tiles.append(_resize_nearest_np(nrm, h, w))
        else:
            tiles.append(np.zeros_like(rgb))
        if outputs.get("lowest_cost_bhw") is not None:
            lc = _host(outputs["lowest_cost_bhw"][i]).astype(np.float32)
            tiles.append(_resize_nearest_np(colormap_image(lc, vmin, vmax),
                                            h, w))
        else:
            tiles.append(np.zeros_like(rgb))
        panels.append(np.concatenate(tiles, axis=1))
    return np.stack(panels, axis=0)
