"""Depth inference and multi-view-consistency point-cloud fusion
(counterpart of `simplerecon_tpu/scripts/pc_fusion.py`).

Per scan: predict depth for every tuple, set depths beyond
`fusion_max_depth` to 0, sample the colour at the depth's size, fuse the
frames with `fusion/point_cloud.py::process_scene` and write a PLY point
cloud to `<output_base_path>/<name>/<dataset>/<frame_tuple_type>/
pc_fusion/<scan>.ply`.

    python -m simplerecon_tpu_torch.scripts.pc_fusion \
        --config_file configs/models/hero_model.yaml --dataset synthetic \
        --single_debug_scan_id scene --split test

Runs on the CUDA card; `main(opts, device="cpu")` runs on the CPU.
Without `--load_weights_from_checkpoint` the model's weights are drawn
from `opts.random_seed`.
"""

from __future__ import annotations

import os
import time

import numpy as np

from simplerecon_tpu_torch.data.io import reverse_imagenet_normalize_np
from simplerecon_tpu_torch.data.loader import DataLoader, device_prefetch
from simplerecon_tpu_torch.data.registry import get_dataset
from simplerecon_tpu_torch.fusion.mesh import write_ply
from simplerecon_tpu_torch.fusion.point_cloud import process_scene
from simplerecon_tpu_torch.models.depth_model import resolve_device
from simplerecon_tpu_torch.options import Options, OptionsHandler
from simplerecon_tpu_torch.scripts.test import (load_model, make_forward_fn,
                                                upsample_nearest)


def main(opts: Options, device=None) -> dict:
    """Fuses every scan of `opts` on `device` (the CUDA card unless
    another is given). Returns the run's stats: frames, batches, points
    per scan, the PLY paths, host seconds by stage and, on a card, the
    CUDA-event ms of each consistency pass."""
    device = resolve_device(device)
    out_dir = os.path.join(opts.output_base_path, opts.name, opts.dataset,
                           opts.frame_tuple_type, "pc_fusion")
    os.makedirs(out_dir, exist_ok=True)

    dataset_class, scans = get_dataset(opts.dataset,
                                       opts.dataset_scan_split_file,
                                       opts.single_debug_scan_id)
    forward = make_forward_fn(load_model(opts, device))
    stats = dict(frames=0, batches=0, points={}, plys={}, forward_s=0.0,
                 fusion_s=0.0, pass_ms=[])

    for scan in scans:
        dataset = dataset_class(
            dataset_path=opts.dataset_path, split=opts.split,
            mv_tuple_file_suffix=opts.mv_tuple_file_suffix,
            tuple_info_file_location=opts.tuple_info_file_location or None,
            limit_to_scan_id=scan,
            num_images_in_tuple=opts.num_images_in_tuple
            or opts.model_num_views,
            image_height=opts.image_height, image_width=opts.image_width,
            include_full_depth_K=True)
        loader = DataLoader(dataset, batch_size=opts.batch_size,
                            num_workers=opts.num_workers)

        depths, poses, Ks, colors = [], [], [], []
        t0 = time.perf_counter()
        for batch in device_prefetch(loader, device):
            cur = batch["cur"]
            outputs = forward(cur, batch["src"])
            pred = outputs["depth_pred_s0_bhw1"][..., 0].float().cpu().numpy()
            pred[pred > opts.fusion_max_depth] = 0.0
            world_T_cam = cur["world_T_cam_b44"].cpu().numpy()
            K_s0 = cur["K_s0_b44"].cpu().numpy()
            images = cur["image_b3hw"].cpu().numpy()
            for i in range(pred.shape[0]):
                depths.append(pred[i])
                poses.append(world_T_cam[i])
                Ks.append(K_s0[i])
                colors.append(reverse_imagenet_normalize_np(images[i]))
            stats["frames"] += pred.shape[0]
            stats["batches"] += 1
        stats["forward_s"] += time.perf_counter() - t0

        if not depths:
            continue
        t0 = time.perf_counter()
        dh, dw = depths[0].shape
        colors_small = np.stack([upsample_nearest(c, dh, dw) for c in colors])
        points, cols = process_scene(
            np.stack(depths), np.stack(poses), np.stack(Ks),
            np.stack([np.linalg.inv(k) for k in Ks]),
            colors_f3hw=colors_small,
            z_thresh=opts.pc_fusion_z_thresh,
            n_consistent=opts.n_consistent_thresh,
            voxel_downsample_size=opts.voxel_downsample, device=device,
            timings=stats["pass_ms"])
        out = os.path.join(out_dir, f"{scan}.ply")
        write_ply(out, points, np.zeros((0, 3), np.int32), colors=cols)
        stats["fusion_s"] += time.perf_counter() - t0
        stats["points"][scan] = len(points)
        stats["plys"][scan] = out
        print(f"{scan}: {len(points)} fused points -> {out}")
    return stats


if __name__ == "__main__":
    handler = OptionsHandler()
    opts = handler.parse_and_merge_options()
    main(opts)
