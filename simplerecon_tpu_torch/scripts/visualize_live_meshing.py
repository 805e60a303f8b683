"""Incremental reconstruction videos (counterpart of
`simplerecon_tpu/scripts/visualize_live_meshing.py`).

Per scan, one keyframe tuple at a time (batch 1, as a live session
runs): predict depth (or read the frame's cached depth when
`--cache_depths` finds one), fuse it into the TSDF, extract the partial
mesh, render it from the camera with the depth in the top-right corner
and from a smoothed bird's-eye camera with back faces shaded
(`back_face_alpha`), and write the two videos `<scan>_fpv.mp4` and
`<scan>_birdseye.mp4` under
`<output_base_path>/<name>/<dataset>/<frame_tuple_type>/live_meshing/`.

    python -m simplerecon_tpu_torch.scripts.visualize_live_meshing \
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

from simplerecon_tpu_torch.data.loader import DataLoader, device_prefetch
from simplerecon_tpu_torch.data.registry import get_dataset
from simplerecon_tpu_torch.fusion.fusers import get_fuser
from simplerecon_tpu_torch.models.depth_model import resolve_device
from simplerecon_tpu_torch.options import Options, OptionsHandler
from simplerecon_tpu_torch.render.renderer import (Renderer,
                                                   SmoothBirdsEyeCamera)
from simplerecon_tpu_torch.scripts.test import (_scan_trajectory, load_model,
                                                make_forward_fn,
                                                upsample_nearest)
from simplerecon_tpu_torch.utils.visualization import (colormap_image,
                                                       write_video)


def main(opts: Options, device=None) -> dict:
    """Writes the videos of every scan of `opts`, with the model and the
    TSDF on `device` (the CUDA card unless another is given). Returns the
    run's stats: keyframes, forwards, cached depths used, frames written
    and the videos by scan, and host seconds a keyframe."""
    device = resolve_device(device)
    out_dir = os.path.join(opts.output_base_path, opts.name, opts.dataset,
                           opts.frame_tuple_type, "live_meshing")
    os.makedirs(out_dir, exist_ok=True)

    dataset_class, scans = get_dataset(opts.dataset,
                                       opts.dataset_scan_split_file,
                                       opts.single_debug_scan_id)
    forward = make_forward_fn(load_model(opts, device))
    renderer = Renderer(opts.viz_render_height, opts.viz_render_width)
    stats = dict(keyframes=0, forwards=0, cached=0, frames={}, videos={},
                 keyframe_s=[])

    for scan in scans:
        dataset = dataset_class(
            dataset_path=opts.dataset_path, split=opts.split,
            mv_tuple_file_suffix=opts.mv_tuple_file_suffix,
            tuple_info_file_location=opts.tuple_info_file_location or None,
            limit_to_scan_id=scan,
            num_images_in_tuple=opts.num_images_in_tuple
            or opts.model_num_views,
            image_height=opts.image_height, image_width=opts.image_width,
            include_full_depth_K=True, pass_frame_id=opts.cache_depths)
        # live meshing is online: one keyframe a batch
        loader = DataLoader(dataset, batch_size=1,
                            num_workers=opts.num_workers)
        fuser = get_fuser(opts, "", trajectory_world_T_cam=_scan_trajectory(
            dataset, scan), device=device)
        birdseye = SmoothBirdsEyeCamera()
        cache_dir = os.path.join(opts.output_base_path, opts.name,
                                 opts.dataset, opts.frame_tuple_type,
                                 "depths", scan)

        fpv_frames, bird_frames = [], []
        for frame_index, batch in enumerate(device_prefetch(loader, device)):
            t0 = time.perf_counter()
            cur, src = batch["cur"], batch["src"]
            stats["keyframes"] += 1

            cached = None
            if opts.cache_depths:
                fid = cur.get("frame_id_string", [str(frame_index)])[0]
                if os.path.exists(os.path.join(cache_dir, f"{fid}.pickle")):
                    from simplerecon_tpu_torch.utils.cache import \
                        load_cached_output
                    cached = load_cached_output(cache_dir, fid)
            if cached is not None:
                depth = np.array(cached["depth_pred_s0_b1hw"][:, 0],
                                 np.float32)
                stats["cached"] += 1
            else:
                outputs = forward(cur, src)
                depth = outputs["depth_pred_s0_bhw1"][..., 0].float(
                ).cpu().numpy()
                stats["forwards"] += 1
            depth[depth > opts.fusion_max_depth] = 0.0

            # fused at the prediction's (s0) size with its intrinsics
            K_s0 = cur["K_s0_b44"][0].cpu().numpy()
            K_full = cur["K_full_depth_b44"][0].cpu().numpy()
            world_T_cam = cur["world_T_cam_b44"][0].cpu().numpy()
            color = cur["image_b3hw"] if opts.fuse_color else None
            fuser.fuse_frames(depth[:, None], K_s0[None],
                              cur["cam_T_world_b44"], color)

            verts, faces = fuser.get_mesh()
            if len(verts) == 0:
                stats["keyframe_s"].append(time.perf_counter() - t0)
                continue
            K_render = K_full.copy()
            K_render[0] *= opts.viz_render_width / (2 * K_full[0, 2])
            K_render[1] *= opts.viz_render_height / (2 * K_full[1, 2])
            fpv_rgb, _ = renderer.render_mesh(verts, faces, world_T_cam,
                                              K_render)
            # the depth in the top-right corner
            dh = opts.viz_render_height // 4
            dw = opts.viz_render_width // 4
            dsmall = upsample_nearest(depth, dh, dw)[0]
            fpv = fpv_rgb.astype(np.float32) / 255.0
            fpv[:dh, -dw:] = colormap_image(dsmall, 0.5,
                                            opts.fusion_max_depth)
            fpv_frames.append(fpv)

            bird_pose = birdseye.get_bird_eye_trans(world_T_cam)
            bird_rgb, _ = renderer.render_mesh(
                verts, faces, bird_pose, K_render,
                back_face_alpha=opts.back_face_alpha)
            bird_frames.append(bird_rgb.astype(np.float32) / 255.0)
            stats["keyframe_s"].append(time.perf_counter() - t0)

        if fpv_frames:
            stats["videos"][scan] = [
                write_video(os.path.join(out_dir, f"{scan}_{kind}.mp4"),
                            frames, fps=opts.standard_fps)
                for kind, frames in (("fpv", fpv_frames),
                                     ("birdseye", bird_frames))]
            stats["frames"][scan] = len(fpv_frames)
            print(f"{scan}: wrote {len(fpv_frames)} frames")
    return stats


if __name__ == "__main__":
    handler = OptionsHandler()
    opts = handler.parse_and_merge_options()
    main(opts)
