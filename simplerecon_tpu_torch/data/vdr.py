"""VDR (iPhone) dataset, the reference's out-of-the-box sample format
(counterpart of `simplerecon_tpu/data/vdr.py`).

Layout:
  `<root>/scans/<scan>/` with `capture.json` (per-frame `pose4x4`
  column-major OpenGL pose, `intrinsics` [fx fy cx cy _], `resolution`),
  `frame_<id>.jpg` color, `depth_<id>.bin` float32 and
  `confidence_<id>.bin` uint8 raw binaries at native 256x192
  (rows = width-major with width 256). Mask = confidence != 0; pose is
  OpenGL -> CV sign-flip then `rotx(-pi/2)` gravity alignment.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np
from simplerecon_tpu_torch.data import io as dio
from simplerecon_tpu_torch.data.generic_dataset import GenericMVSDataset
from simplerecon_tpu_torch.ops.geometry import rotx

_GL_TO_CV = np.array([[1, -1, -1, 1],
                      [-1, 1, 1, -1],
                      [-1, 1, 1, -1],
                      [1, 1, 1, 1]], np.float32)


class VDRDataset(GenericMVSDataset):
    native_depth_width = 256
    native_depth_height = 192

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.capture_metadata: Dict[str, list] = {}

    def get_sub_folder_dir(self, split: str) -> str:
        return "scans"

    def get_frame_id_string(self, frame_id) -> str:
        return str(frame_id)

    def _scene_path(self, scan_id: str) -> str:
        return os.path.join(self.dataset_path,
                            self.get_sub_folder_dir(self.split), scan_id)

    # ----------------------------- metadata -----------------------------
    def load_capture_metadata(self, scan_id: str):
        if scan_id in self.capture_metadata:
            return
        with open(os.path.join(self._scene_path(scan_id),
                               "capture.json")) as f:
            self.capture_metadata[scan_id] = json.load(f)["frames"]

    # ----------------------------- paths -----------------------------
    def get_color_filepath(self, scan_id, frame_id) -> str:
        cached = os.path.join(
            self._scene_path(scan_id),
            f"frame.{self.image_width}_{frame_id}.jpg")
        if os.path.exists(cached):
            return cached
        return os.path.join(self._scene_path(scan_id),
                            f"frame_{frame_id}.jpg")

    def get_high_res_color_filepath(self, scan_id, frame_id) -> str:
        cached = os.path.join(
            self._scene_path(scan_id),
            f"frame.{self.high_res_image_height}_{frame_id}.jpg")
        if os.path.exists(cached):
            return cached
        return os.path.join(self._scene_path(scan_id),
                            f"frame_{frame_id}.jpg")

    def get_cached_depth_filepath(self, scan_id, frame_id) -> str:
        return os.path.join(self._scene_path(scan_id),
                            f"depth.{self.depth_width}_{frame_id}.bin")

    def get_full_res_depth_filepath(self, scan_id, frame_id) -> str:
        return os.path.join(self._scene_path(scan_id),
                            f"depth_{frame_id}.bin")

    def get_cached_confidence_filepath(self, scan_id, frame_id) -> str:
        return os.path.join(self._scene_path(scan_id),
                            f"confidence.{self.depth_width}_{frame_id}.bin")

    def get_full_res_confidence_filepath(self, scan_id, frame_id) -> str:
        return os.path.join(self._scene_path(scan_id),
                            f"confidence_{frame_id}.bin")

    def get_valid_frame_path(self, split, scan) -> str:
        return os.path.join(self._scene_path(scan), "valid_frames.txt")

    def get_valid_frame_ids(self, split, scan, store_computed=True
                            ) -> List[str]:
        scan = scan.rstrip("\n")
        valid_path = self.get_valid_frame_path(split, scan)
        if os.path.exists(valid_path):
            return dio.readlines(valid_path)
        self.load_capture_metadata(scan)
        valid, dist = [], 0
        for i in range(len(self.capture_metadata[scan])):
            world_T_cam, _ = self.load_pose(scan, i)
            if not np.isfinite(world_T_cam).all():
                dist += 1
                continue
            valid.append(f"{scan} {i} {dist}")
            dist = 0
        if store_computed:
            try:
                with open(valid_path, "w") as f:
                    f.write("\n".join(valid) + "\n")
            except Exception as e:
                print(f"couldn't save valid_frames.txt: {e}")
        return valid

    # ----------------------------- loading -----------------------------
    def load_pose(self, scan_id, frame_id):
        self.load_capture_metadata(scan_id)
        meta = self.capture_metadata[scan_id][int(frame_id)]
        # json stores the pose column-major; transpose, then flip
        # OpenGL -> CV axes, then rotate into gravity convention
        world_T_cam = np.asarray(meta["pose4x4"], np.float32
                                 ).reshape(4, 4).T
        world_T_cam = world_T_cam * _GL_TO_CV
        world_T_cam[:3, :3] = rotx(-np.pi / 2) @ world_T_cam[:3, :3]
        world_T_cam[:3, 3] = rotx(-np.pi / 2) @ world_T_cam[:3, 3]
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
        self.load_capture_metadata(scan_id)
        meta = self.capture_metadata[scan_id][int(frame_id)]
        image_width, image_height = meta["resolution"]
        fx, fy, cx, cy = meta["intrinsics"][:4]
        K = np.eye(4, dtype=np.float64)
        K[0, 0], K[1, 1], K[0, 2], K[1, 2] = fx, fy, cx, cy

        out = {}
        if self.include_full_depth_K:
            fK = K.copy()
            fK[0] *= self.native_depth_width / image_width
            fK[1] *= self.native_depth_height / image_height
            out["K_full_depth_b44"] = fK.astype(np.float32)
            out["invK_full_depth_b44"] = np.linalg.inv(fK).astype(
                np.float32)
        if flip:
            K[0, 2] = image_width - K[0, 2]
        K[0] *= self.depth_width / image_width
        K[1] *= self.depth_height / image_height
        for i in range(5):
            Ks = K.copy()
            Ks[:2] /= 2 ** i
            out[f"K_s{i}_b44"] = Ks.astype(np.float32)
            out[f"invK_s{i}_b44"] = np.linalg.inv(Ks).astype(np.float32)
        return out

    def _read_bin(self, path: str, dtype, width: int) -> np.ndarray:
        return np.fromfile(path, dtype=dtype).reshape(-1, width)

    @staticmethod
    def _resize_nearest(arr_hw: np.ndarray, h: int, w: int) -> np.ndarray:
        iy = (np.arange(h) * arr_hw.shape[0] / h).astype(np.int64)
        ix = (np.arange(w) * arr_hw.shape[1] / w).astype(np.int64)
        return arr_hw[iy][:, ix]

    def load_target_size_depth_and_mask(self, scan_id, frame_id):
        path = self.get_cached_depth_filepath(scan_id, frame_id)
        if os.path.exists(path):
            depth = self._read_bin(path, np.float32, self.depth_width)
        else:
            depth = self._read_bin(
                self.get_full_res_depth_filepath(scan_id, frame_id),
                np.float32, self.native_depth_width)
            depth = self._resize_nearest(depth, self.depth_height,
                                         self.depth_width)
        cpath = self.get_cached_confidence_filepath(scan_id, frame_id)
        if os.path.exists(cpath):
            conf = self._read_bin(cpath, np.uint8, self.depth_width)
        else:
            conf = self._read_bin(
                self.get_full_res_confidence_filepath(scan_id, frame_id),
                np.uint8, self.native_depth_width)
            conf = self._resize_nearest(conf, self.depth_height,
                                        self.depth_width)
        mask_b = conf[None] != 0
        depth = np.where(mask_b, depth[None], np.nan).astype(np.float32)
        return depth, mask_b.astype(np.float32), mask_b

    def load_full_res_depth_and_mask(self, scan_id, frame_id):
        depth = self._read_bin(
            self.get_full_res_depth_filepath(scan_id, frame_id),
            np.float32, self.native_depth_width)[None]
        conf = self._read_bin(
            self.get_full_res_confidence_filepath(scan_id, frame_id),
            np.uint8, self.native_depth_width)[None]
        mask_b = conf != 0
        depth = np.where(mask_b, depth, np.nan).astype(np.float32)
        return depth, mask_b.astype(np.float32), mask_b
