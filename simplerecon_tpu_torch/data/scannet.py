"""ScanNet v2 dataset, host-side (counterpart of
`simplerecon_tpu/data/scannet.py`).

Layout:
  `<root>/scans[_test]/<scan>/sensor_data/frame-XXXXXX.{color.jpg,
  depth.png,pose.txt}` with optional precached resized
  `color.<W>.png` / `depth.<w>.png`; per-scene metadata `<scan>.txt`
  (depthWidth/depthHeight/colorWidth/colorHeight); intrinsics from
  `intrinsic/intrinsic_depth.txt`; GT mesh `<scan>_vh_clean_2.ply`.

Depth PNGs are millimeters (x 1e-3); valid depth in (1e-3, 10) m, NaN
outside. Valid-frame scanning checks
color/depth/pose existence and pose finiteness, tracking
`dist_to_last_valid_frame` as tracking-loss hints, and caches
`valid_frames.txt` in the scan folder. Images are decoded by
`data/codec.py`, without Pillow.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
from simplerecon_tpu_torch.data import io as dio
from simplerecon_tpu_torch.data.generic_dataset import GenericMVSDataset


class ScannetDataset(GenericMVSDataset):
    min_valid_depth = 1e-3
    max_valid_depth = 10.0

    def get_sub_folder_dir(self, split: str) -> str:
        return "scans_test" if split == "test" else "scans"

    # ------------------------------ paths ------------------------------
    def _sensor_dir(self, scan_id: str) -> str:
        return os.path.join(self.scenes_path, scan_id, "sensor_data")

    def get_color_filepath(self, scan_id, frame_id) -> str:
        cached = os.path.join(
            self._sensor_dir(scan_id),
            f"frame-{frame_id}.color.{self.image_width}.png")
        if os.path.exists(cached):
            return cached
        return os.path.join(self._sensor_dir(scan_id),
                            f"frame-{frame_id}.color.jpg")

    def get_high_res_color_filepath(self, scan_id, frame_id) -> str:
        cached = os.path.join(
            self._sensor_dir(scan_id),
            f"frame-{frame_id}.color.{self.high_res_image_height}.png")
        if os.path.exists(cached):
            return cached
        return os.path.join(self._sensor_dir(scan_id),
                            f"frame-{frame_id}.color.jpg")

    def get_cached_depth_filepath(self, scan_id, frame_id) -> str:
        return os.path.join(
            self._sensor_dir(scan_id),
            f"frame-{frame_id}.depth.{self.depth_width}.png")

    def get_full_res_depth_filepath(self, scan_id, frame_id) -> str:
        return os.path.join(self._sensor_dir(scan_id),
                            f"frame-{frame_id}.depth.png")

    def get_pose_filepath(self, scan_id, frame_id) -> str:
        return os.path.join(self._sensor_dir(scan_id),
                            f"frame-{frame_id}.pose.txt")

    def get_gt_mesh_path(self, dataset_path, split, scan_id) -> str:
        return os.path.join(dataset_path, self.get_sub_folder_dir(split),
                            scan_id, f"{scan_id}_vh_clean_2.ply")

    def get_frame_id_string(self, frame_id) -> str:
        return str(frame_id)

    def get_valid_frame_path(self, split, scan) -> str:
        return os.path.join(self.scenes_path, scan, "valid_frames.txt")

    # --------------------------- valid frames ---------------------------
    def get_valid_frame_ids(self, split, scan, store_computed: bool = True
                            ) -> List[str]:
        """Each line: `scan_id frame_id dist_to_last_valid_frame`."""
        scan = scan.rstrip("\n")
        valid_path = self.get_valid_frame_path(split, scan)
        if os.path.exists(valid_path):
            return dio.readlines(valid_path)

        # scan the metadata for the frame count, then test each frame
        meta = self._read_scene_metadata(scan)
        n_frames = int(float(meta.get("numColorFrames", 0)))
        valid = []
        dist_to_last_valid = 0
        for f in range(n_frames):
            frame_id = f"{f:06d}"
            pose_path = self.get_pose_filepath(scan, frame_id)
            color_ok = os.path.exists(self.get_color_filepath(scan,
                                                              frame_id))
            depth_ok = (os.path.exists(
                self.get_cached_depth_filepath(scan, frame_id))
                or os.path.exists(
                    self.get_full_res_depth_filepath(scan, frame_id)))
            pose_ok = False
            if os.path.exists(pose_path):
                pose = np.genfromtxt(pose_path)
                pose_ok = np.isfinite(pose).all()
            if color_ok and depth_ok and pose_ok:
                valid.append(f"{scan} {frame_id} {dist_to_last_valid}")
                dist_to_last_valid = 0
            else:
                dist_to_last_valid += 1
        if store_computed:
            try:
                with open(valid_path, "w") as fh:
                    fh.write("\n".join(valid) + "\n")
            except Exception as e:  # read-only datasets
                print(f"couldn't save valid_frames.txt: {e}")
        return valid

    # ------------------------------ loading ------------------------------
    def _read_scene_metadata(self, scan_id) -> Dict[str, str]:
        path = os.path.join(self.scenes_path, scan_id, f"{scan_id}.txt")
        data = {}
        for line in dio.readlines(path):
            if " = " in line:
                k, v = line.split(" = ", 1)
                data[k] = v
        return data

    def load_pose(self, scan_id, frame_id):
        world_T_cam = np.genfromtxt(
            self.get_pose_filepath(scan_id, frame_id)).astype(np.float32)
        return world_T_cam, np.linalg.inv(world_T_cam)

    def load_color(self, scan_id, frame_id) -> np.ndarray:
        return dio.read_image_file(
            self.get_color_filepath(scan_id, frame_id),
            height=self.image_height, width=self.image_width)

    def load_high_res_color(self, scan_id, frame_id) -> np.ndarray:
        return dio.read_image_file(
            self.get_high_res_color_filepath(scan_id, frame_id),
            height=self.high_res_image_height,
            width=self.high_res_image_width)

    def load_intrinsics(self, scan_id, frame_id=None, flip: bool = False
                        ) -> Dict[str, np.ndarray]:
        meta = self._read_scene_metadata(scan_id)
        K = np.genfromtxt(os.path.join(
            self.scenes_path, scan_id, "intrinsic", "intrinsic_depth.txt"
        )).astype(np.float64)
        native_w = float(meta["depthWidth"])
        native_h = float(meta["depthHeight"])
        return self._scaled_intrinsics(
            K, native_w, native_h, self.depth_width, self.depth_height,
            flip, self.include_full_depth_K)

    def _depth_from_png(self, path: str, h: Optional[int] = None,
                        w: Optional[int] = None) -> np.ndarray:
        return dio.read_depth_png(path, h, w)

    def load_target_size_depth_and_mask(self, scan_id, frame_id):
        path = self.get_cached_depth_filepath(scan_id, frame_id)
        if not os.path.exists(path):
            path = self.get_full_res_depth_filepath(scan_id, frame_id)
        depth = self._depth_from_png(path, self.depth_height,
                                     self.depth_width)
        mask_b = (depth > self.min_valid_depth) \
            & (depth < self.max_valid_depth)
        depth = np.where(mask_b, depth, np.nan).astype(np.float32)
        return depth, mask_b.astype(np.float32), mask_b

    def load_full_res_depth_and_mask(self, scan_id, frame_id):
        depth = self._depth_from_png(
            self.get_full_res_depth_filepath(scan_id, frame_id))
        mask_b = (depth > self.min_valid_depth) \
            & (depth < self.max_valid_depth)
        depth = np.where(mask_b, depth, np.nan).astype(np.float32)
        return depth, mask_b.astype(np.float32), mask_b
