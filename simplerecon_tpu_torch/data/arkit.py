"""ARKit (NeuralRecon ios-logger) dataset, no GT depth (dummy data)
(counterpart of `simplerecon_tpu/data/arkit.py`).

Layout: `<root>/scans/<scan>/`
with `images/<frame_id>.png`, `poses/<frame_id>.txt` (4x4 world_T_cam
already gravity-aligned by preprocessing) and `intrinsics/<frame_id>.txt`.
The raw ios-logger capture (`Frames.m4v` + `Frames.txt` + `ARposes.txt`)
needs a video decoder to convert, which the port does not have yet.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from simplerecon_tpu_torch.data import io as dio
from simplerecon_tpu_torch.data.generic_dataset import GenericMVSDataset


class ArkitDataset(GenericMVSDataset):
    def get_sub_folder_dir(self, split: str) -> str:
        return "scans"

    def _scene_path(self, scan_id: str) -> str:
        return os.path.join(self.scenes_path, scan_id)

    def get_frame_id_string(self, frame_id) -> str:
        return str(frame_id)

    def get_color_filepath(self, scan_id, frame_id) -> str:
        images = os.path.join(self._scene_path(scan_id), "images")
        cached = os.path.join(images,
                              f"{frame_id}.{self.image_width}.png")
        if os.path.exists(cached):
            return cached
        return os.path.join(images, f"{frame_id}.png")

    def get_high_res_color_filepath(self, scan_id, frame_id) -> str:
        return self.get_color_filepath(scan_id, frame_id)

    def get_pose_filepath(self, scan_id, frame_id) -> str:
        return os.path.join(self._scene_path(scan_id), "poses",
                            f"{frame_id}.txt")

    def get_intrinsics_filepath(self, scan_id, frame_id) -> str:
        return os.path.join(self._scene_path(scan_id), "intrinsics",
                            f"{frame_id}.txt")

    def get_valid_frame_path(self, split, scan) -> str:
        return os.path.join(self._scene_path(scan.rstrip("\n")),
                            "valid_frames.txt")

    def get_valid_frame_ids(self, split, scan, store_computed=True
                            ) -> List[str]:
        scan = scan.rstrip("\n")
        valid_path = self.get_valid_frame_path(split, scan)
        if os.path.exists(valid_path):
            return dio.readlines(valid_path)
        images_dir = os.path.join(self._scene_path(scan), "images")
        frame_ids = sorted(os.path.splitext(f)[0]
                           for f in os.listdir(images_dir)
                           if f.endswith(".png") and "." not in
                           os.path.splitext(f)[0])
        valid, dist = [], 0
        for fid in frame_ids:
            pose_path = self.get_pose_filepath(scan, fid)
            ok = os.path.exists(pose_path)
            if ok:
                ok = np.isfinite(np.genfromtxt(pose_path)).all()
            if ok:
                valid.append(f"{scan} {fid} {dist}")
                dist = 0
            else:
                dist += 1
        if store_computed:
            try:
                with open(valid_path, "w") as f:
                    f.write("\n".join(valid) + "\n")
            except Exception as e:
                print(f"couldn't save valid_frames.txt: {e}")
        return valid

    def load_pose(self, scan_id, frame_id):
        world_T_cam = np.genfromtxt(
            self.get_pose_filepath(scan_id, frame_id)).astype(np.float32)
        return world_T_cam, np.linalg.inv(world_T_cam)

    def load_color(self, scan_id, frame_id) -> np.ndarray:
        return dio.read_image_file(
            self.get_color_filepath(scan_id, frame_id),
            height=self.image_height, width=self.image_width,
            target_aspect_ratio=4.0 / 3.0)

    def load_high_res_color(self, scan_id, frame_id) -> np.ndarray:
        return dio.read_image_file(
            self.get_high_res_color_filepath(scan_id, frame_id),
            height=self.high_res_image_height,
            width=self.high_res_image_width,
            target_aspect_ratio=4.0 / 3.0)

    def load_intrinsics(self, scan_id, frame_id=None, flip: bool = False
                        ) -> Dict[str, np.ndarray]:
        vals = np.genfromtxt(self.get_intrinsics_filepath(scan_id,
                                                          frame_id))
        # file rows: fx fy cx cy [native_w native_h]
        fx, fy, cx, cy = [float(v) for v in vals.flatten()[:4]]
        native_w = float(vals.flatten()[4]) if vals.size > 4 else 2 * cx
        native_h = float(vals.flatten()[5]) if vals.size > 5 else 2 * cy
        K = np.eye(4, dtype=np.float64)
        K[0, 0], K[1, 1], K[0, 2], K[1, 2] = fx, fy, cx, cy
        return self._scaled_intrinsics(K, native_w, native_h,
                                       self.depth_width, self.depth_height,
                                       flip, self.include_full_depth_K)

    def load_target_size_depth_and_mask(self, scan_id, frame_id):
        """No GT depth for ARKit captures: dummy ones."""
        shape = (1, self.depth_height, self.depth_width)
        return (np.ones(shape, np.float32), np.ones(shape, np.float32),
                np.ones(shape, bool))

    def load_full_res_depth_and_mask(self, scan_id, frame_id):
        shape = (1, self.depth_height, self.depth_width)
        return (np.ones(shape, np.float32), np.ones(shape, np.float32),
                np.ones(shape, bool))
