"""COLMAP text-reconstruction dataset, no GT depth (dummy data)
(counterpart of `simplerecon_tpu/data/colmap.py`).

Layout:
`<root>/scans/<scan>/undistorted/sparse/{cameras.txt,images.txt}` plus
`images_low_res/<frame_id>.JPG` undistorted images. Camera models
SIMPLE_PINHOLE / PINHOLE / SIMPLE_RADIAL / RADIAL / OPENCV are parsed
(distortion ignored — images are undistorted); poses come from
images.txt (qvec/tvec = cam_T_world), inverted, then rotated
`rotx(pi/2)` into the gravity convention.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from simplerecon_tpu_torch.data import io as dio
from simplerecon_tpu_torch.data.generic_dataset import GenericMVSDataset
from simplerecon_tpu_torch.ops.geometry import qvec2rotmat, rotx


class ColmapDataset(GenericMVSDataset):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.capture_poses: Dict[str, Dict] = {}

    def get_sub_folder_dir(self, split: str) -> str:
        return "scans"

    def _sparse_path(self, scan_id: str) -> str:
        return os.path.join(self.scenes_path, scan_id, "undistorted",
                            "sparse")

    def get_frame_id_string(self, frame_id) -> str:
        return str(frame_id)

    def get_color_filepath(self, scan_id, frame_id) -> str:
        return os.path.join(self._sparse_path(scan_id), "images_low_res",
                            f"{frame_id}.JPG")

    def get_high_res_color_filepath(self, scan_id, frame_id) -> str:
        return os.path.join(self._sparse_path(scan_id), "images",
                            f"{frame_id}.JPG")

    def get_valid_frame_path(self, split, scan) -> str:
        return os.path.join(self.scenes_path, scan.rstrip("\n"),
                            "valid_frames.txt")

    def get_valid_frame_ids(self, split, scan, store_computed=True
                            ) -> List[str]:
        scan = scan.rstrip("\n")
        valid_path = self.get_valid_frame_path(split, scan)
        if os.path.exists(valid_path):
            return dio.readlines(valid_path)
        self.load_capture_poses(scan)
        valid, dist = [], 0
        for fid in sorted(self.capture_poses[scan]):
            world_T_cam = self.capture_poses[scan][fid]["world_T_cam"]
            if np.isfinite(world_T_cam).all() and os.path.exists(
                    self.get_color_filepath(scan, fid)):
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

    def load_capture_poses(self, scan_id: str):
        """Parses images.txt."""
        if scan_id in self.capture_poses:
            return
        self.capture_poses[scan_id] = {}
        bottom = np.array([[0.0, 0.0, 0.0, 1.0]])
        with open(os.path.join(self._sparse_path(scan_id),
                               "images.txt")) as f:
            i = 0
            for line in f:
                line = line.strip()
                if not line or line[0] == "#":
                    continue
                i += 1
                if i % 2 == 1:
                    elems = line.split(" ")
                    image_id = "".join(elems[9:]).strip().split(".")[0]
                    qvec = np.array([float(v) for v in elems[1:5]])
                    tvec = np.array([float(v) for v in elems[5:8]])
                    R = qvec2rotmat(-qvec)
                    m = np.concatenate(
                        [np.concatenate([R, tvec.reshape(3, 1)], 1),
                         bottom], 0)
                    world_T_cam = np.linalg.inv(m)
                    self.capture_poses[scan_id][image_id] = {
                        "world_T_cam": world_T_cam,
                        "cam_T_world": np.linalg.inv(world_T_cam)}

    def load_pose(self, scan_id, frame_id):
        self.load_capture_poses(scan_id)
        world_T_cam = self.capture_poses[scan_id][frame_id][
            "world_T_cam"].astype(np.float32).copy()
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

    def _parse_camera(self, scan_id) -> Dict[str, float]:
        cam = {}
        with open(os.path.join(self._sparse_path(scan_id),
                               "cameras.txt")) as f:
            for line in f:
                if line.startswith("#") or not line.strip():
                    continue
                els = line.split(" ")
                w, h = float(els[2]), float(els[3])
                fx = fy = float(els[4])
                cx, cy = w / 2, h / 2
                model = els[1]
                if model == "SIMPLE_PINHOLE":
                    cx, cy = float(els[5]), float(els[6])
                elif model == "PINHOLE":
                    fy, cx, cy = float(els[5]), float(els[6]), float(els[7])
                elif model in ("SIMPLE_RADIAL", "RADIAL"):
                    cx, cy = float(els[5]), float(els[6])
                elif model == "OPENCV":
                    fy, cx, cy = float(els[5]), float(els[6]), float(els[7])
                else:
                    print(f"unknown camera model {model}")
                cam = {"w": w, "h": h, "fx": fx, "fy": fy,
                       "cx": cx, "cy": cy}
                break  # single shared camera assumed, as in the reference
        return cam

    def load_intrinsics(self, scan_id, frame_id=None, flip: bool = False
                        ) -> Dict[str, np.ndarray]:
        cam = self._parse_camera(scan_id)
        K = np.eye(4, dtype=np.float64)
        K[0, 0], K[1, 1] = cam["fx"], cam["fy"]
        K[0, 2], K[1, 2] = cam["cx"], cam["cy"]
        return self._scaled_intrinsics(K, cam["w"], cam["h"],
                                       self.depth_width, self.depth_height,
                                       flip, self.include_full_depth_K)

    def load_target_size_depth_and_mask(self, scan_id, frame_id):
        shape = (1, self.depth_height, self.depth_width)
        return (np.ones(shape, np.float32), np.ones(shape, np.float32),
                np.ones(shape, bool))

    def load_full_res_depth_and_mask(self, scan_id, frame_id):
        shape = (1, self.depth_height, self.depth_width)
        return (np.ones(shape, np.float32), np.ones(shape, np.float32),
                np.ones(shape, bool))
