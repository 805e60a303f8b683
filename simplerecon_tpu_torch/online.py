"""Online (streaming) inference: keyframe buffer + depth model
(counterpart of `simplerecon_tpu/online.py`).

    session = OnlineSession(opts, model)
    for frame in stream:                       # dict per frame
        result = session.process_frame(frame)
        if result is not None:                 # keyframe -> depth map
            fuse(result["depth_pred_s0_bhw1"], ...)

Frames arrive one at a time; the DVMVS `KeyframeBuffer` decides which are
keyframes, and each keyframe is matched against the best buffered source
views. When fewer than `model_num_views - 1` sources are buffered, the
last one is repeated, so every forward has the same shapes.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from simplerecon_tpu.data.keyframe_buffer import DVMVS_Config, KeyframeBuffer


def make_batch(frame: Dict, src_frames, matching_scale: int, device
               ) -> tuple:
    """(cur_data, src_data) with batch size 1 on `device`, from one
    reference frame dict and its source frame dicts."""
    m = matching_scale

    def stack(key, frames):
        return torch.from_numpy(np.stack([f[key] for f in frames])
                                ).to(device)[None]

    cur_data = {key: stack(key, [frame])[:, 0] for key in (
        "image_b3hw", f"invK_s{m}_b44", "world_T_cam_b44", "cam_T_world_b44")}
    src_data = {key: stack(key, src_frames) for key in (
        "image_b3hw", f"K_s{m}_b44", "world_T_cam_b44", "cam_T_world_b44")}
    return cur_data, src_data


class OnlineSession:
    """Streaming depth estimation over a posed RGB stream.

    Args:
        opts: options object (`model_num_views`, `matching_scale`,
            `test_keyframe_buffer_size`).
        model: an eval-mode port `DepthModel`; the forward runs on the
            device its parameters are on.

    `process_frame(frame)` takes a dict of numpy arrays:
        image_b3hw      (3, h, w) imagenet-normalised image
        world_T_cam_b44 / cam_T_world_b44  (4, 4)
        K_s{m}_b44 / invK_s{m}_b44 at the matching scale m
        dist_to_last_valid (optional int) tracking-loss hint
    """

    def __init__(self, opts, model):
        self.opts = opts
        self.model = model
        self.device = next(model.parameters()).device
        self.num_sources = opts.model_num_views - 1
        self.buffer = KeyframeBuffer(
            buffer_size=opts.test_keyframe_buffer_size,
            keyframe_pose_distance=DVMVS_Config.test_keyframe_pose_distance,
            optimal_t_score=DVMVS_Config.test_optimal_t_measure,
            optimal_R_score=DVMVS_Config.test_optimal_R_measure,
            store_return_indices=False)

    @torch.no_grad()
    def process_frame(self, frame: Dict[str, np.ndarray]
                      ) -> Optional[Dict[str, np.ndarray]]:
        """Feeds one frame; returns the model outputs as numpy arrays when
        it is a keyframe with at least one source view, else None."""
        response = self.buffer.try_new_keyframe(
            np.asarray(frame["world_T_cam_b44"], np.float64),
            frame, frame.get("dist_to_last_valid"))
        if response != 1:
            return None
        sources = self.buffer.get_best_measurement_frames(self.num_sources)
        src_frames = [s[1] for s in sources]
        if not src_frames:
            return None
        while len(src_frames) < self.num_sources:  # pad (fixed shapes)
            src_frames.append(src_frames[-1])

        cur_data, src_data = make_batch(frame, src_frames,
                                        self.opts.matching_scale, self.device)
        outputs = self.model(cur_data, src_data, flip=False, return_mask=True)
        return {k: v.cpu().numpy() for k, v in outputs.items()
                if v is not None}
