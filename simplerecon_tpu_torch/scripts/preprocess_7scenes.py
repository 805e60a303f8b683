"""CLI: 7Scenes preprocessing — register Kinect depth into the RGB frame.

Counterpart of `simplerecon_tpu/scripts/preprocess_7scenes.py` (after
visloc_pseudo_gt_limitations), without Pillow: for each
`frame-XXXXXX.depth.png`, backproject with the depth intrinsics, transform by the depth->RGB
calibration, re-project with the RGB intrinsics, z-buffer scatter, and
write `frame-XXXXXX.depth.proj.png` (uint16 millimeters; 65535 =
invalid).

    python -m simplerecon_tpu_torch.scripts.preprocess_7scenes \
        --dataset_path /mnt/7scenes --scenes chess fire ...
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from simplerecon_tpu_torch.data import codec
from simplerecon_tpu_torch.utils.visualization import encode_png

# Kinect calibration used by visloc_pseudo_gt_limitations: focal lengths
# for depth (585) and RGB (525), plus the depth->RGB extrinsic.
K_DEPTH = np.array([[585.0, 0, 320.0], [0, 585.0, 240.0], [0, 0, 1.0]])
K_RGB = np.array([[525.0, 0, 320.0], [0, 525.0, 240.0], [0, 0, 1.0]])
# depth camera to RGB camera transform (meters)
D_TO_RGB = np.array([
    [0.99996518, 0.00826571, -0.00084152, -0.02571272],
    [-0.00826571, 0.99996518, 0.00004961, -0.00012057],
    [0.00084152, -0.00004961, 0.99999964, 0.00409617],
    [0.0, 0.0, 0.0, 1.0]])

INVALID = 65535


def register_depth(depth_mm: np.ndarray) -> np.ndarray:
    """Projects a depth map from the depth camera into the RGB camera."""
    h, w = depth_mm.shape
    valid = (depth_mm > 0) & (depth_mm != INVALID)
    v, u = np.nonzero(valid)
    z = depth_mm[v, u].astype(np.float64) / 1000.0

    x = (u + 0.5 - K_DEPTH[0, 2]) / K_DEPTH[0, 0] * z
    y = (v + 0.5 - K_DEPTH[1, 2]) / K_DEPTH[1, 1] * z
    pts = np.stack([x, y, z, np.ones_like(z)], 0)
    pts_rgb = D_TO_RGB @ pts
    z_rgb = pts_rgb[2]
    u_rgb = np.round(pts_rgb[0] / z_rgb * K_RGB[0, 0]
                     + K_RGB[0, 2] - 0.5).astype(np.int64)
    v_rgb = np.round(pts_rgb[1] / z_rgb * K_RGB[1, 1]
                     + K_RGB[1, 2] - 0.5).astype(np.int64)

    inside = (u_rgb >= 0) & (u_rgb < w) & (v_rgb >= 0) & (v_rgb < h) \
        & (z_rgb > 0)
    out = np.full((h, w), np.inf)
    # z-buffer scatter: keep the nearest depth per target pixel
    order = np.argsort(-z_rgb[inside])  # far to near; near overwrites
    uu, vv, zz = u_rgb[inside][order], v_rgb[inside][order], \
        z_rgb[inside][order]
    out[vv, uu] = zz
    out_mm = np.where(np.isfinite(out), np.round(out * 1000.0),
                      0).astype(np.uint16)
    return out_mm


def process_scene(scene_dir: str):
    depth_files = sorted(glob.glob(os.path.join(scene_dir, "seq-*",
                                                "frame-*.depth.png")))
    for path in depth_files:
        out_path = path.replace(".depth.png", ".depth.proj.png")
        if os.path.exists(out_path):
            continue
        depth = np.asarray(codec.read_image(path), np.uint16)
        with open(out_path, "wb") as f:
            f.write(encode_png(register_depth(depth)))
    print(f"{scene_dir}: {len(depth_files)} frames")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset_path", required=True)
    ap.add_argument("--scenes", nargs="+",
                    default=["chess", "fire", "heads", "office",
                             "pumpkin", "redkitchen", "stairs"])
    args = ap.parse_args(argv)
    for scene in args.scenes:
        process_scene(os.path.join(args.dataset_path, scene))


if __name__ == "__main__":
    main()
