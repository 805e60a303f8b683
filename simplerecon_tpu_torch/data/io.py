"""Host-side helpers of the data layer (counterpart of
`simplerecon_tpu/data/io.py`): tuple files, image and depth files read
through `data/codec.py` (no Pillow) with the JAX reader's aspect crop,
resize and scaling, imagenet normalisation, the train-time colour jitter
and the DVMVS pose distance.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from simplerecon_tpu_torch.data import codec

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def readlines(path: str) -> List[str]:
    with open(path, "r") as f:
        return [line.rstrip() for line in f if line.strip()]


def imagenet_normalize_np(image_3hw: np.ndarray) -> np.ndarray:
    """In: (3, h, w) in [0, 1]."""
    return ((image_3hw - IMAGENET_MEAN[:, None, None])
            / IMAGENET_STD[:, None, None]).astype(np.float32)


def reverse_imagenet_normalize_np(image_3hw: np.ndarray) -> np.ndarray:
    return (image_3hw * IMAGENET_STD[:, None, None]
            + IMAGENET_MEAN[:, None, None]).astype(np.float32)


def read_image_file(filepath: str, height: Optional[int] = None,
                    width: Optional[int] = None,
                    value_scale_factor: float = 1.0,
                    resampling_mode: str = "bilinear",
                    target_aspect_ratio: Optional[float] = None
                    ) -> np.ndarray:
    """Decode (+ optional aspect crop, resize to (height, width) with
    Pillow's "bilinear" or "nearest", value scale) -> (c, h, w) float32;
    8-bit images in [0, 1], 16-bit ones as stored."""
    img = codec.read_image(filepath)
    if target_aspect_ratio:
        img = crop_image_to_target_ratio(img, target_aspect_ratio)
    if height is not None and width is not None:
        if img.shape[:2] != (height, width):
            img = codec.resize(img, height, width, resampling_mode)
    arr = np.asarray(img, np.float32)
    if arr.ndim == 2:
        arr = arr[None]
    else:
        arr = arr.transpose(2, 0, 1)
    if img.dtype == np.uint8:
        arr = arr / 255.0
    return arr * value_scale_factor


def crop_image_to_target_ratio(image: np.ndarray,
                               target_aspect_ratio: float = 4.0 / 3.0
                               ) -> np.ndarray:
    """Centre crop of an (h, w[, c]) image to an aspect ratio."""
    height, width = image.shape[:2]
    actual = width / height
    if actual > target_aspect_ratio:
        new_w = int(height * target_aspect_ratio)
        left = (width - new_w) // 2
        return image[:, left:left + new_w]
    if actual < target_aspect_ratio:
        new_h = int(width / target_aspect_ratio)
        top = (height - new_h) // 2
        return image[top:top + new_h]
    return image


def read_depth_png(path: str, height: Optional[int] = None,
                   width: Optional[int] = None) -> np.ndarray:
    """A millimetre depth PNG as (1, h, w) float32 metres, resized by
    nearest neighbour to (height, width) when given."""
    depth = codec.read_image(path)
    if height is not None and depth.shape != (height, width):
        depth = codec.resize(depth, height, width, "nearest")
    return np.asarray(depth, np.float32)[None] * 1e-3


class ColorJitter:
    """torchvision-style ColorJitter(0.2, 0.2, 0.2, 0.2) on (3, h, w)
    arrays in [0, 1]: brightness, contrast and saturation factors uniform
    in [1-x, 1+x], a hue shift uniform in [-0.2, 0.2], in random order.
    The draws come from the state a call is given, else from `rng`.
    """

    def __init__(self, brightness=0.2, contrast=0.2, saturation=0.2,
                 hue=0.2, rng: Optional[np.random.RandomState] = None):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue
        self.rng = rng if rng is not None else np.random.RandomState(0)

    def _grayscale(self, img):  # ITU-R 601-2 luma, as torchvision
        return (0.299 * img[0] + 0.587 * img[1] + 0.114 * img[2])[None]

    def __call__(self, img_3hw: np.ndarray,
                 rng: Optional[np.random.RandomState] = None) -> np.ndarray:
        img = img_3hw.astype(np.float32)
        r = self.rng if rng is None else rng
        ops = list(range(4))
        r.shuffle(ops)
        for op in ops:
            if op == 0 and self.brightness:
                f = r.uniform(1 - self.brightness, 1 + self.brightness)
                img = img * f
            elif op == 1 and self.contrast:
                f = r.uniform(1 - self.contrast, 1 + self.contrast)
                mean = self._grayscale(np.clip(img, 0, 1)).mean()
                img = mean + f * (img - mean)
            elif op == 2 and self.saturation:
                f = r.uniform(1 - self.saturation, 1 + self.saturation)
                gray = self._grayscale(np.clip(img, 0, 1))
                img = gray + f * (img - gray)
            elif op == 3 and self.hue:
                shift = r.uniform(-self.hue, self.hue)
                img = _hue_shift(np.clip(img, 0, 1), shift)
            img = np.clip(img, 0.0, 1.0)
        return img.astype(np.float32)


def _hue_shift(img_3hw: np.ndarray, shift: float) -> np.ndarray:
    """Hue rotation through HSV."""
    r, g, b = img_3hw[0], img_3hw[1], img_3hw[2]
    maxc = np.maximum(np.maximum(r, g), b)
    minc = np.minimum(np.minimum(r, g), b)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    dz = np.maximum(delta, 1e-12)
    rc = (maxc - r) / dz
    gc = (maxc - g) / dz
    bc = (maxc - b) / dz
    h = np.where(r == maxc, bc - gc,
                 np.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = (h / 6.0) % 1.0
    h = np.where(delta == 0, 0.0, h)
    h = (h + shift) % 1.0
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    r2 = np.choose(i, [v, q, p, p, t, v])
    g2 = np.choose(i, [t, v, v, q, p, p])
    b2 = np.choose(i, [p, p, t, v, v, q])
    return np.stack([r2, g2, b2], 0)


def pose_distance_np(pose_44: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """DVMVS pose distance of (..., 4, 4) relative poses: (distance,
    rotation measure, translation measure)."""
    R = pose_44[..., :3, :3]
    t = pose_44[..., :3, 3]
    R_trace = np.trace(R, axis1=-2, axis2=-1)
    r_measure = np.sqrt(2 * (1 - np.minimum(3.0, R_trace) / 3))
    t_measure = np.linalg.norm(t, axis=-1)
    return np.sqrt(t_measure ** 2 + r_measure ** 2), r_measure, t_measure
