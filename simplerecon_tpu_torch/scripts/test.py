"""Depth evaluation and optional TSDF fusion over test scans (counterpart
of `simplerecon_tpu/scripts/test.py`).

Per scan: build the tuple dataset, run the depth model batch by batch,
score each frame against full-resolution GT (the prediction upsampled by
nearest neighbour, GT > 0.5 m), keep per-frame and per-scene averages,
with `--dump_depth_visualization` write each frame's colour, predicted,
GT and lowest-cost depth as PNGs under `viz/quick_viz/<scan>/`, and,
with `--run_fusion`, fuse the depths into a TSDF and write a mesh per
scan. The model, the metrics' reductions and the TSDF update run on
the device; data, averaging, marching cubes and PLY writing on the host.

    python -m simplerecon_tpu_torch.scripts.test \
        --config_file configs/models/hero_model.yaml --dataset synthetic \
        --single_debug_scan_id scene --split test --run_fusion

Runs on the CUDA card; `main(opts, device="cpu")` runs on the CPU.
Without `--load_weights_from_checkpoint` the model's weights are drawn
from `opts.random_seed`. With `--data_parallel_eval` each batch is split
over a replica of the model on each visible card (`make_forward_fn`;
`main(opts, devices=[...])` names the devices, which may repeat), as the
JAX CLI splits it over its devices.
"""

from __future__ import annotations

import os
import time
from typing import Dict

import numpy as np
import torch

from simplerecon_tpu_torch import tracing
from simplerecon_tpu_torch.data.loader import DataLoader, device_prefetch
from simplerecon_tpu_torch.data.registry import get_dataset
from simplerecon_tpu_torch.models.depth_model import (build_depth_model,
                                                      resolve_device)
from simplerecon_tpu_torch.options import Options, OptionsHandler
from simplerecon_tpu_torch.utils.metrics import (ResultsAverager,
                                                 compute_depth_metrics_batched)

_FORWARD_KEYS = ("depth_pred_s0_bhw1", "lowest_cost_bhw",
                 "overall_mask_bhw")
# the fields of `Options` that define the model, taken from a
# checkpoint's options when it has them
MODEL_FIELDS = ("matching_scale", "matching_num_depth_bins",
                "min_matching_depth", "max_matching_depth",
                "matching_feature_dims", "matching_norm",
                "matching_pool_impl", "model_num_views",
                "feature_volume_type", "matching_encoder_type",
                "image_encoder_name", "depth_decoder_name",
                "cv_encoder_type")


def make_forward_fn(model, devices=None):
    """Inference forward in eval mode, under `torch.inference_mode()`,
    with the model's own autocast: the depth at s0, the lowest-cost depth
    and the overall mask.

    With `devices` (more than one), the data-parallel forward (the JAX
    `make_sharded_forward`): a replica of `model` on each distinct
    device; a batch is padded to a multiple of the device count by
    repeating its last element, cut into equal shards in order, each run
    on its device, and the outputs gathered in order onto the first
    device and cut back to the batch."""
    model.eval()

    def forward(cur_data, src_data):
        with tracing.span("sr.forward"), torch.inference_mode():
            outputs = model(cur_data, src_data, flip=False, return_mask=True)
        return {k: outputs[k] for k in _FORWARD_KEYS}

    if devices is None or len(devices) < 2:
        return forward
    import copy
    devices = [torch.device(d) for d in devices]
    replicas = {}
    for device in devices:
        if device not in replicas:
            replica = model if next(model.parameters()).device == device \
                else copy.deepcopy(model).to(device)
            replicas[device] = replica.eval()
    n = len(devices)

    def sharded(cur_data, src_data):
        b = cur_data["image_b3hw"].shape[0]
        pad = (-b) % n
        rows = (b + pad) // n

        def shard(data, i, device):
            out = {}
            for key, value in data.items():
                if not isinstance(value, torch.Tensor):
                    continue
                if pad:
                    value = torch.cat([value, value[-1:].expand(
                        pad, *value.shape[1:])])
                out[key] = value[i * rows:(i + 1) * rows].to(
                    device, non_blocking=True)
            return out

        parts = []
        with tracing.span("sr.forward"), torch.inference_mode():
            for i, device in enumerate(devices):
                outputs = replicas[device](
                    shard(cur_data, i, device), shard(src_data, i, device),
                    flip=False, return_mask=True)
                parts.append({k: outputs[k] for k in _FORWARD_KEYS})
            return {k: torch.cat([p[k].to(devices[0]) for p in parts])[:b]
                    for k in _FORWARD_KEYS}

    return sharded


def upsample_nearest(depth_bhw, h: int, w: int):
    """Nearest-neighbour upsample of (b, h', w') to (b, h, w): a numpy
    array or a tensor, returned as the same kind."""
    iy = (np.arange(h) * depth_bhw.shape[1] / h).astype(np.int64)
    ix = (np.arange(w) * depth_bhw.shape[2] / w).astype(np.int64)
    if isinstance(depth_bhw, torch.Tensor):
        iy = torch.from_numpy(iy).to(depth_bhw.device)
        ix = torch.from_numpy(ix).to(depth_bhw.device)
    return depth_bhw[:, iy][:, :, ix]


def evaluate_batch(depth_pred_bhw: torch.Tensor, full_gt_bhw: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
    """The eval protocol: the prediction upsampled by nearest neighbour to
    the GT's resolution, valid where GT > 0.5 m."""
    h, w = full_gt_bhw.shape[-2:]
    up = upsample_nearest(depth_pred_bhw, h, w)
    valid = torch.isfinite(full_gt_bhw) & (full_gt_bhw > 0.5)
    return compute_depth_metrics_batched(full_gt_bhw, up, valid, mult_a=True)


def _scan_trajectory(dataset, scan):
    """(n, 4, 4) world_T_cam of every reference frame in the scan's tuples
    (for trajectory-derived TSDF bounds); None if unavailable."""
    poses = []
    for line in dataset.frame_tuples:
        parts = line.split(" ")
        if len(parts) < 2 or parts[0] != scan:
            continue
        try:
            world_T_cam, _ = dataset.load_pose(scan, parts[1])
        except Exception:
            return None
        if np.all(np.isfinite(world_T_cam)):
            poses.append(world_T_cam)
    return np.stack(poses) if poses else None


def _scan_invK(dataset, scan):
    """(invK_44, (h, w)) at the s0 scale for frustum bounds, or (None,
    None) when intrinsics are unavailable."""
    try:
        for line in dataset.frame_tuples:
            parts = line.split(" ")
            if len(parts) < 2 or parts[0] != scan:
                continue
            intr = dataset.load_intrinsics(scan, parts[1])
            invK = np.asarray(intr["invK_s0_b44"]).reshape(4, 4)
            return invK, (dataset.image_height // 2,
                          dataset.image_width // 2)
    except Exception:
        pass
    return None, None


def load_model(opts: Options, device) -> torch.nn.Module:
    """The depth model of `opts` on `device`: with the weights (and the
    model's options) of `opts.load_weights_from_checkpoint` (a checkpoint
    directory, a step directory or a file) when given, else seeded from
    `opts.random_seed`."""
    from simplerecon_tpu_torch.utils import checkpoint as ckpt_lib
    path = opts.load_weights_from_checkpoint
    model_opts = opts
    if path:
        stored = ckpt_lib.load_options_from_checkpoint(path)
        if stored is not None:
            model_opts = Options.from_dict(opts.to_dict())
            for key in MODEL_FIELDS:
                model_opts.set(key, getattr(stored, key))
    model = build_depth_model(model_opts, device=device,
                              seed=opts.random_seed)
    if path:
        ckpt_lib.load_weights(path, model)
    return model.eval()


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(opts: Options, device=None, devices=None):
    """Runs the evaluation of `opts` on `device` (the CUDA card unless
    another is given). With `opts.data_parallel_eval` the forward is split
    over `devices` (by default every visible card), the first of which
    holds the batches, the metrics and the fusion. Returns the (frame,
    scene) `ResultsAverager`s; each has `run_stats`, the seconds spent in
    each stage and counts."""
    if opts.data_parallel_eval and devices is None and device is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    if opts.data_parallel_eval and devices:
        device = devices[0]
    else:
        devices = None
    device = resolve_device(device)
    results_path = os.path.join(opts.output_base_path, opts.name,
                                opts.dataset, opts.frame_tuple_type)
    scores_dir = os.path.join(results_path, "scores")
    os.makedirs(scores_dir, exist_ok=True)
    mesh_dir = os.path.join(results_path, "meshes",
                            f"{int(opts.fusion_resolution * 100)}cm"
                            f"_{opts.fusion_max_depth}m")
    if opts.run_fusion:
        os.makedirs(mesh_dir, exist_ok=True)

    dataset_class, scans = get_dataset(
        opts.dataset, opts.dataset_scan_split_file,
        opts.single_debug_scan_id)

    model = load_model(opts, device)
    forward = make_forward_fn(model, devices)

    all_frame_avg = ResultsAverager(opts.name, "frame metrics")
    all_scene_avg = ResultsAverager(opts.name, "scene metrics")
    # seconds by stage (forward_device: CUDA-event time of the forwards)
    stages = dict(loader=0.0, forward=0.0, forward_device=0.0, metrics=0.0,
                  fusion=0.0, marching_cubes=0.0, ply=0.0)
    counts = dict(frames=0, batches=0, fused_frames=0, voxels=0,
                  mesh_vertices=0, mesh_faces=0)
    events = ([torch.cuda.Event(enable_timing=True) for _ in range(2)]
              if device.type == "cuda" else None)
    batch_ms = []       # the CUDA-event ms of each batch's forward

    for scan in scans:
        scan_frame_avg = ResultsAverager(opts.name, f"scan {scan}")
        dataset = dataset_class(
            dataset_path=opts.dataset_path,
            split=opts.split,
            mv_tuple_file_suffix=opts.mv_tuple_file_suffix,
            tuple_info_file_location=opts.tuple_info_file_location or None,
            limit_to_scan_id=scan,
            num_images_in_tuple=opts.num_images_in_tuple
            or opts.model_num_views,
            image_height=opts.image_height, image_width=opts.image_width,
            include_full_res_depth=True, include_full_depth_K=True,
            include_high_res_color=(opts.fuse_color and opts.run_fusion),
            pass_frame_id=opts.cache_depths,
            skip_frames=opts.skip_frames, skip_to_frame=opts.skip_to_frame)
        loader = DataLoader(dataset, batch_size=opts.batch_size,
                            num_workers=opts.num_workers)

        fuser = None
        if opts.run_fusion:
            from simplerecon_tpu_torch.fusion.fusers import (
                bounds_from_trajectory, get_fuser)
            gt_mesh = ""
            try:
                gt_mesh = dataset.get_gt_mesh_path(opts.dataset_path,
                                                   opts.split, scan)
                if not os.path.exists(gt_mesh):
                    gt_mesh = ""
            except NotImplementedError:
                pass
            bounds = None
            if not gt_mesh:
                # the scan's camera frustums bound the grid
                trajectory = _scan_trajectory(dataset, scan)
                if trajectory is not None:
                    invK, hw = _scan_invK(dataset, scan)
                    bounds = bounds_from_trajectory(
                        trajectory, opts.fusion_max_depth,
                        invK_44=invK, image_hw=hw)
            fuser = get_fuser(opts, gt_mesh, bounds_3x2=bounds,
                              device=device)

        batches = iter(device_prefetch(loader, device))
        while True:
            with tracing.span("sr.loader.wait") as wait:
                batch = next(batches, None)
            stages["loader"] += wait.seconds
            if batch is None:
                break
            cur, src = batch["cur"], batch["src"]
            b = cur["image_b3hw"].shape[0]
            counts["frames"] += b
            counts["batches"] += 1

            _sync(device)
            t0 = time.perf_counter()
            if events:
                events[0].record()
            outputs = forward(cur, src)
            depth_pred = outputs["depth_pred_s0_bhw1"][..., 0]
            if events:
                events[1].record()
            _sync(device)
            model_time = (time.perf_counter() - t0) / b
            stages["forward"] += model_time * b
            if events:
                batch_ms.append(events[0].elapsed_time(events[1]))
                stages["forward_device"] += batch_ms[-1] / 1e3

            t0 = time.perf_counter()
            full_gt = cur["full_res_depth_b1hw"][:, 0]
            metrics = evaluate_batch(depth_pred, full_gt)
            rows = torch.stack([metrics[k] for k in metrics], 1).cpu().numpy()
            for i in range(b):
                frame = {k: float(rows[i, j]) for j, k in enumerate(metrics)}
                frame["model_time"] = model_time
                scan_frame_avg.update_results(frame)
                all_frame_avg.update_results(frame)
            stages["metrics"] += time.perf_counter() - t0

            if opts.dump_depth_visualization:
                from simplerecon_tpu_torch.utils.visualization import \
                    quick_viz_export
                viz_dir = os.path.join(results_path, "viz", "quick_viz",
                                       scan)
                for i in range(b):
                    quick_viz_export(viz_dir, outputs, cur, batch_ind=i,
                                     prefix=f"{scan}_{i}_")

            if opts.cache_depths:
                from simplerecon_tpu_torch.utils.cache import \
                    cache_model_outputs
                cache_dir = os.path.join(results_path, "depths", scan)
                frame_ids = cur.get("frame_id_string",
                                    [str(i) for i in range(b)])
                cache_model_outputs(cache_dir, outputs, cur, src, b,
                                    frame_ids)

            if fuser is not None:
                t0 = time.perf_counter()
                fusion_depth = depth_pred.clone()
                if opts.fusion_use_raw_lowest_cost:
                    fusion_depth = outputs["lowest_cost_bhw"].clone()
                if opts.mask_pred_depth:
                    mask = outputs["overall_mask_bhw"].float()
                    fusion_depth = torch.where(mask > 0.5, fusion_depth, 0.0)
                fusion_depth[fusion_depth > opts.fusion_max_depth] = 0.0
                full_h, full_w = full_gt.shape[-2:]
                up = upsample_nearest(fusion_depth, full_h, full_w)
                # high-res colour when the loader gives it, else the
                # model's input
                color = cur.get("high_res_color_b3hw", cur["image_b3hw"]) \
                    if opts.fuse_color else None
                fuser.fuse_frames(up[:, None], cur["K_full_depth_b44"],
                                  cur["cam_T_world_b44"], color)
                _sync(device)
                stages["fusion"] += time.perf_counter() - t0
                counts["fused_frames"] += b

        if fuser is not None:
            t0 = time.perf_counter()
            mesh = fuser.get_mesh(include_colors=opts.fuse_color)
            stages["marching_cubes"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            from simplerecon_tpu_torch.fusion.mesh import write_ply
            colors = mesh[2] if opts.fuse_color else None
            write_ply(os.path.join(mesh_dir, f"{scan}.ply"), mesh[0],
                      mesh[1], colors=colors)
            stages["ply"] += time.perf_counter() - t0
            counts["voxels"] += int(np.prod(fuser.fuser.tsdf.dims))
            counts["mesh_vertices"] += len(mesh[0])
            counts["mesh_faces"] += len(mesh[1])

        scan_frame_avg.compute_final_average()
        scan_frame_avg.output_json(
            os.path.join(scores_dir, f"{scan}_avg_metrics.json"))
        if scan_frame_avg.final_metrics:
            all_scene_avg.update_results(scan_frame_avg.final_metrics)
        scan_frame_avg.pretty_print_results(print_running_metrics=False)

    all_frame_avg.compute_final_average()
    all_scene_avg.compute_final_average()
    all_frame_avg.output_json(
        os.path.join(scores_dir, "all_frame_avg_metrics.json"))
    all_scene_avg.output_json(
        os.path.join(scores_dir, "all_scene_avg_metrics.json"))
    print("\nPer-frame averages:")
    all_frame_avg.print_sheets_friendly(print_running_metrics=False)
    print("\nPer-scene averages:")
    all_scene_avg.print_sheets_friendly(print_running_metrics=False)
    all_frame_avg.run_stats = dict(stages, **counts,
                                   batch_forward_ms=batch_ms)
    return all_frame_avg, all_scene_avg


if __name__ == "__main__":
    handler = OptionsHandler()
    opts = handler.parse_and_merge_options()
    handler.pretty_print_options()
    main(opts)
