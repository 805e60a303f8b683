"""A depth video per scene from cached model outputs (counterpart of
`simplerecon_tpu/scripts/visualize_scene_depth_output.py`).

Reads the per-frame pickles that the eval CLI writes with
`--cache_depths` and lays out each frame as

    [ lowest-cost depth       | predicted depth   | GT depth   ]
    [ RGB (+ source strip)    | predicted normals | GT normals ]

with white 4-pixel gaps between the panels, padded to multiples of 16
for the video encoder, and writes `<scan>.mp4` under
`<output_base_path>/<name>/<dataset>/<frame_tuple_type>/viz/depth_videos/`.
Colour limits come from the smoothed GT min/max cache
(`viz/gt_min_max_cache.pickle`, `scripts/generate_gt_min_max_cache.py`)
when it holds the frame, else a robust range of the frame's GT (or
prediction).

    python -m simplerecon_tpu_torch.scripts.visualize_scene_depth_output \
        --config_file configs/models/hero_model.yaml --dataset synthetic \
        --single_debug_scan_id scene --split test

Everything here runs on the host in numpy, as in the JAX package: there
is no model and no device work.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from simplerecon_tpu_torch.data.io import reverse_imagenet_normalize_np
from simplerecon_tpu_torch.data.registry import get_dataset
from simplerecon_tpu_torch.options import Options, OptionsHandler
from simplerecon_tpu_torch.utils.cache import load_cached_output
from simplerecon_tpu_torch.utils.visualization import (colormap_image,
                                                       normalize_depth_robust,
                                                       normals_from_depth_np,
                                                       write_video)

BUFFER_GAP = 4  # the white gap between panels


def _resize_nearest(img, h, w):
    """(H, W[, C]) nearest resize."""
    iy = (np.arange(h) * img.shape[0] // h).clip(0, img.shape[0] - 1)
    ix = (np.arange(w) * img.shape[1] // w).clip(0, img.shape[1] - 1)
    return img[iy][:, ix]


def _hbuf(width, height=None):
    """A white gap: a row strip `width` wide, or a column strip `height`
    high when `height` is given."""
    if height is None:
        return np.ones((BUFFER_GAP, width, 3), np.float32)
    return np.ones((height, BUFFER_GAP, 3), np.float32)


def _normals_panel(depth_hw, invK_44, h, w):
    n = normals_from_depth_np(depth_hw, invK_44)
    return _resize_nearest(
        np.clip(np.nan_to_num(0.5 * (1.0 + n)), 0, 1), h, w)


def build_frame_panels(rgb_3hw: np.ndarray, src_images_k3hw,
                       depth_pred_hw: np.ndarray,
                       lowest_cost_hw: np.ndarray,
                       gt_depth_hw, invK_44: np.ndarray,
                       vmin: float, vmax: float,
                       panel_hw=(480, 640)) -> np.ndarray:
    """One frame of the layout above, each panel `panel_hw`; returns
    (H', W', 3) in [0, 1]."""
    H, W = panel_hw

    # left column: the lowest-cost depth over the RGB with the source
    # frames along its bottom
    main_color = _resize_nearest(
        np.clip(reverse_imagenet_normalize_np(rgb_3hw), 0, 1
                ).transpose(1, 2, 0), H, W)
    if src_images_k3hw is not None and len(src_images_k3hw):
        sh, sw = int(round(H * 69 / 480)), int(round(W * 91 / 640))
        strip = np.concatenate(
            [_resize_nearest(
                np.clip(reverse_imagenet_normalize_np(s), 0, 1
                        ).transpose(1, 2, 0), sh, sw)
             for s in src_images_k3hw], axis=1)[:, :W]
        pad = W - strip.shape[1]
        if pad > 0:
            strip = np.pad(strip, ((0, 0), (0, pad), (0, 0)))
        main_color[H - sh:, :] = strip
    lc_panel = _resize_nearest(
        colormap_image(lowest_cost_hw, vmin, vmax), H, W)
    color_col = np.concatenate([lc_panel, _hbuf(W), main_color], axis=0)

    # predicted depth and normals
    ours_depth = _resize_nearest(
        colormap_image(depth_pred_hw, vmin, vmax), H, W)
    ours_normals = _normals_panel(depth_pred_hw, invK_44, H, W)
    ours_col = np.concatenate([ours_depth, _hbuf(W), ours_normals],
                              axis=0)

    # GT depth and normals (black without GT)
    if gt_depth_hw is not None:
        gt_mask = np.isfinite(gt_depth_hw) & (gt_depth_hw > 1e-3) & \
            (gt_depth_hw < 10)
        gt_depth_p = _resize_nearest(
            colormap_image(np.where(gt_mask, gt_depth_hw, 0.0),
                           vmin, vmax), H, W)
        gt_normals = _normals_panel(
            np.where(gt_mask, gt_depth_hw, 0.0), invK_44, H, W)
    else:
        gt_depth_p = np.zeros((H, W, 3), np.float32)
        gt_normals = np.zeros((H, W, 3), np.float32)
    gt_col = np.concatenate([gt_depth_p, _hbuf(W), gt_normals], axis=0)

    height = color_col.shape[0]
    frame = np.concatenate(
        [color_col, _hbuf(None, height), ours_col, _hbuf(None, height),
         gt_col], axis=1)
    # padded to multiples of 16 for the video encoder
    ph = (-frame.shape[0]) % 16
    pw = (-frame.shape[1]) % 16
    return np.pad(frame, ((0, ph), (0, pw), (0, 0)), constant_values=1.0)


def main(opts: Options) -> dict:
    """Writes the depth video of every scan of `opts` with cached depths.
    Returns {scan: (frames, the path written)}."""
    results_path = os.path.join(opts.output_base_path, opts.name,
                                opts.dataset, opts.frame_tuple_type)
    cache_root = os.path.join(results_path, "depths")
    out_dir = os.path.join(results_path, "viz", "depth_videos")
    os.makedirs(out_dir, exist_ok=True)

    minmax_path = os.path.join(results_path, "viz",
                               "gt_min_max_cache.pickle")
    minmax_cache = {}
    if os.path.exists(minmax_path):
        with open(minmax_path, "rb") as f:
            minmax_cache = pickle.load(f)

    dataset_class, scans = get_dataset(opts.dataset,
                                       opts.dataset_scan_split_file,
                                       opts.single_debug_scan_id)
    written = {}
    for scan in scans:
        scan_cache = os.path.join(cache_root, scan)
        if not os.path.isdir(scan_cache):
            print(f"no cached depths for {scan} under {scan_cache}")
            continue
        dataset = dataset_class(
            dataset_path=opts.dataset_path, split=opts.split,
            mv_tuple_file_suffix=opts.mv_tuple_file_suffix,
            tuple_info_file_location=opts.tuple_info_file_location or None,
            limit_to_scan_id=scan,
            num_images_in_tuple=opts.num_images_in_tuple
            or opts.model_num_views,
            image_height=opts.image_height, image_width=opts.image_width,
            pass_frame_id=True)
        scan_minmax = minmax_cache.get(scan, {})

        frames = []
        for idx in range(len(dataset)):
            cur_data, src_data = dataset[idx]
            frame_id = cur_data.get("frame_id_string", str(idx))
            if not os.path.exists(os.path.join(scan_cache,
                                               f"{frame_id}.pickle")):
                continue
            cached = load_cached_output(scan_cache, frame_id)
            depth_pred = np.asarray(cached["depth_pred_s0_b1hw"][0, 0],
                                    np.float32)

            gt = cur_data.get("depth_b1hw")
            gt_hw = np.asarray(gt[0], np.float32) if gt is not None \
                else None
            if frame_id in scan_minmax:
                vmin, vmax = scan_minmax[frame_id]
            else:
                vmin, vmax = normalize_depth_robust(
                    gt_hw if gt_hw is not None else depth_pred)

            lowest = np.asarray(
                cached.get("lowest_cost_bhw", depth_pred[None])[0],
                np.float32)
            if getattr(opts, "mask_pred_depth", False) and \
                    cached.get("overall_mask_bhw") is not None:
                lowest = np.where(
                    np.asarray(cached["overall_mask_bhw"][0], bool),
                    0.0, lowest)

            frames.append(build_frame_panels(
                np.asarray(cur_data["image_b3hw"], np.float32),
                np.asarray(src_data["image_b3hw"], np.float32)
                if src_data is not None and "image_b3hw" in src_data
                else None,
                depth_pred, lowest, gt_hw,
                np.asarray(cur_data["invK_s0_b44"], np.float32),
                vmin, vmax,
                panel_hw=(opts.image_height, opts.image_width)))

        if frames:
            fps = (opts.standard_fps if not opts.skip_frames
                   else round(opts.standard_fps / opts.skip_frames))
            out = write_video(os.path.join(out_dir, f"{scan}.mp4"),
                              frames, fps=fps)
            written[scan] = (len(frames), out)
            print(f"{scan}: {len(frames)} frames -> {out}")
    return written


if __name__ == "__main__":
    handler = OptionsHandler()
    opts = handler.parse_and_merge_options()
    main(opts)
