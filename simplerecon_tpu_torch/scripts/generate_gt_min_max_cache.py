"""CLI: per-scene smoothed GT depth vmin/vmax cache for video colormaps.

Counterpart of `simplerecon_tpu/scripts/generate_gt_min_max_cache.py`:
computes robust depth percentiles per frame, EMA-smooths them along the
scan, and pickles `{scan: {frame_id: (vmin, vmax)}}` for the depth-video
script to share color scales across frames.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from simplerecon_tpu_torch.data.registry import get_dataset
from simplerecon_tpu_torch.options import OptionsHandler
from simplerecon_tpu_torch.utils.visualization import normalize_depth_robust


def main(opts):
    dataset_class, scans = get_dataset(opts.dataset,
                                       opts.dataset_scan_split_file,
                                       opts.single_debug_scan_id)
    out_path = os.path.join(opts.output_base_path, opts.name, opts.dataset,
                            opts.frame_tuple_type, "viz",
                            "gt_min_max_cache.pickle")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)

    cache = {}
    alpha = 0.1
    for scan in scans:
        dataset = dataset_class(
            dataset_path=opts.dataset_path, split=opts.split,
            mv_tuple_file_suffix=opts.mv_tuple_file_suffix,
            tuple_info_file_location=opts.tuple_info_file_location or None,
            limit_to_scan_id=scan,
            num_images_in_tuple=opts.num_images_in_tuple
            or opts.model_num_views,
            image_height=opts.image_height, image_width=opts.image_width,
            pass_frame_id=True)
        scan_cache = {}
        vmin_s = vmax_s = None
        for idx in range(len(dataset)):
            cur_data, _ = dataset[idx]
            depth = cur_data.get("depth_b1hw")
            if depth is None:
                continue
            vmin, vmax = normalize_depth_robust(depth[0])
            vmin_s = vmin if vmin_s is None else \
                (1 - alpha) * vmin_s + alpha * vmin
            vmax_s = vmax if vmax_s is None else \
                (1 - alpha) * vmax_s + alpha * vmax
            fid = cur_data.get("frame_id_string", str(idx))
            scan_cache[fid] = (float(vmin_s), float(vmax_s))
        cache[scan] = scan_cache
        print(f"{scan}: {len(scan_cache)} frames")

    with open(out_path, "wb") as f:
        pickle.dump(cache, f)
    print(f"wrote {out_path}")
    return out_path


if __name__ == "__main__":
    handler = OptionsHandler()
    opts = handler.parse_and_merge_options()
    main(opts)
