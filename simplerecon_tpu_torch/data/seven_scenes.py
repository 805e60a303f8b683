"""7Scenes dataset, pre-processed: depth registered into the RGB frame
(counterpart of `simplerecon_tpu/data/seven_scenes.py`).

Scan ids are
`<scene>/seq-XX` folders containing `frame-XXXXXX.{color.png,pose.txt,
depth.proj.png}` (depth in millimeters, registered to RGB by
`scripts/preprocess_7scenes.py`). Fixed Kinect RGB intrinsics fx=fy=525,
cx=320, cy=240 at 640x480; poses rotated `rotx(pi/2)` into the ScanNet
gravity convention.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
from simplerecon_tpu_torch.data import io as dio
from simplerecon_tpu_torch.data.generic_dataset import GenericMVSDataset
from simplerecon_tpu_torch.ops.geometry import rotx


class SevenScenesDataset(GenericMVSDataset):
    min_valid_depth = 1e-3
    max_valid_depth = 10.0

    def get_sub_folder_dir(self, split: str) -> str:
        return ""

    def _scene_path(self, scan_id: str) -> str:
        return os.path.join(self.scenes_path, scan_id)

    def get_frame_id_string(self, frame_id) -> str:
        return str(frame_id)

    def get_color_filepath(self, scan_id, frame_id) -> str:
        cached = os.path.join(
            self._scene_path(scan_id),
            f"frame-{frame_id}.color.{self.image_width}.png")
        if os.path.exists(cached):
            return cached
        return os.path.join(self._scene_path(scan_id),
                            f"frame-{frame_id}.color.png")

    def get_high_res_color_filepath(self, scan_id, frame_id) -> str:
        cached = os.path.join(
            self._scene_path(scan_id),
            f"frame-{frame_id}.color.{self.high_res_image_height}.png")
        if os.path.exists(cached):
            return cached
        return os.path.join(self._scene_path(scan_id),
                            f"frame-{frame_id}.color.png")

    def get_cached_depth_filepath(self, scan_id, frame_id) -> str:
        return os.path.join(
            self._scene_path(scan_id),
            f"frame-{frame_id}.depth.proj.{self.depth_width}.png")

    def get_full_res_depth_filepath(self, scan_id, frame_id) -> str:
        return os.path.join(self._scene_path(scan_id),
                            f"frame-{frame_id}.depth.proj.png")

    def get_pose_filepath(self, scan_id, frame_id) -> str:
        return os.path.join(self._scene_path(scan_id),
                            f"frame-{frame_id}.pose.txt")

    def get_valid_frame_path(self, split, scan) -> str:
        return os.path.join(self._scene_path(scan.rstrip("\n")),
                            "valid_frames.txt")

    def get_valid_frame_ids(self, split, scan, store_computed=True
                            ) -> List[str]:
        scan = scan.rstrip("\n")
        valid_path = self.get_valid_frame_path(split, scan)
        if os.path.exists(valid_path):
            return dio.readlines(valid_path)
        frame_ids = sorted(
            f[len("frame-"):-len(".pose.txt")]
            for f in os.listdir(self._scene_path(scan))
            if f.startswith("frame-") and f.endswith(".pose.txt"))
        valid, dist = [], 0
        for fid in frame_ids:
            ok = (os.path.exists(self.get_color_filepath(scan, fid))
                  and os.path.exists(
                      self.get_full_res_depth_filepath(scan, fid)))
            if ok:
                pose = np.genfromtxt(self.get_pose_filepath(scan, fid))
                ok = np.isfinite(pose).all()
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
        world_T_cam[:3, :3] = rotx(np.pi / 2) @ world_T_cam[:3, :3]
        world_T_cam[:3, 3] = rotx(np.pi / 2) @ world_T_cam[:3, 3]
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

    def load_intrinsics(self, scan_id=None, frame_id=None,
                        flip: bool = False) -> Dict[str, np.ndarray]:
        K = np.eye(4, dtype=np.float64)
        K[0, 0] = K[1, 1] = 525.0
        K[0, 2], K[1, 2] = 320.0, 240.0
        return self._scaled_intrinsics(K, 640.0, 480.0, self.depth_width,
                                       self.depth_height, flip,
                                       self.include_full_depth_K)

    def _depth_from_png(self, path, h=None, w=None) -> np.ndarray:
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
