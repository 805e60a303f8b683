"""Per-frame model-output caching for `--cache_depths` (counterpart of
`simplerecon_tpu/utils/cache.py`): each frame's predicted depth,
intrinsics, pose and frame id pickled as numpy arrays under
`<cache_dir>/<frame_id>.pickle`, the format the JAX package writes; and
`copy_code_state`, the source snapshot of a training run.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional

import numpy as np
import torch


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def cache_model_outputs(output_path: str, outputs: Dict, cur_data: Dict,
                        src_data: Dict, batch_size: int,
                        frame_ids: List[str],
                        src_frame_ids: Optional[List[List[str]]] = None):
    """Writes one pickle per frame of the batch. `outputs` and `cur_data`
    may hold tensors on any device or numpy arrays."""
    os.makedirs(output_path, exist_ok=True)
    depth = _host(outputs["depth_pred_s0_bhw1"])
    lowest = (None if outputs.get("lowest_cost_bhw") is None
              else _host(outputs["lowest_cost_bhw"]))
    K_full = _host(cur_data.get("K_full_depth_b44", cur_data["K_s0_b44"]))
    K_s0 = _host(cur_data["K_s0_b44"])
    world_T_cam = _host(cur_data["world_T_cam_b44"])
    cam_T_world = _host(cur_data["cam_T_world_b44"])
    for i in range(batch_size):
        record = {
            # (1, 1, h, w): a b1hw array of this one frame
            "depth_pred_s0_b1hw": depth[i, ..., 0][None, None],
            "K_full_depth_b44": K_full[i],
            "K_s0_b44": K_s0[i],
            "world_T_cam_b44": world_T_cam[i],
            "cam_T_world_b44": cam_T_world[i],
            "frame_id": frame_ids[i],
        }
        if lowest is not None:
            record["lowest_cost_bhw"] = lowest[i][None]  # (1, h, w)
        if src_frame_ids is not None:
            record["src_ids"] = src_frame_ids[i]
        with open(os.path.join(output_path, f"{frame_ids[i]}.pickle"),
                  "wb") as f:
            pickle.dump(record, f)


def load_cached_output(output_path: str, frame_id: str) -> Dict:
    with open(os.path.join(output_path, f"{frame_id}.pickle"), "rb") as f:
        return pickle.load(f)


def copy_code_state(log_dir: str) -> str:
    """Copies this package's source (Python, CUDA and C++ files) into
    `<log_dir>/code/simplerecon_tpu_torch/`, for reproducibility. Returns
    `<log_dir>/code`."""
    import shutil

    package_root = os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))
    dst_root = os.path.join(log_dir, "code")
    for dirpath, dirnames, filenames in os.walk(package_root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fname in filenames:
            if not fname.endswith((".py", ".cu", ".cuh", ".cpp")):
                continue
            src = os.path.join(dirpath, fname)
            dst = os.path.join(dst_root, os.path.relpath(
                src, os.path.dirname(package_root)))
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            shutil.copy2(src, dst)
    return dst_root
