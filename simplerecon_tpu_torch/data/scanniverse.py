"""Scanniverse dataset, no GT depth (dummy data) (counterpart of
`simplerecon_tpu/data/scanniverse.py`).

Each scan folder
holds a text-proto `frames.txt` with per-frame blocks

    frames {
      id: N
      camera { width ... height ... f ... px ... py ... }
      pose { rotation: [x, y, z, w] translation: [x, y, z] }
      is_large_image: true
    }

parsed with regexes, plus JPG frames
`IMG_<id>.jpg` (large variants preferred for high-res color).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List

import numpy as np

from simplerecon_tpu_torch.data import io as dio
from simplerecon_tpu_torch.data.generic_dataset import GenericMVSDataset
from simplerecon_tpu_torch.ops.geometry import rotx


def _quat_xyzw_to_rotmat(q) -> np.ndarray:
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


class ScanniverseDataset(GenericMVSDataset):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.capture_metadata: Dict[str, Dict] = {}

    def get_sub_folder_dir(self, split: str) -> str:
        return "scans"

    def _scene_path(self, scan_id: str) -> str:
        return os.path.join(self.scenes_path, scan_id)

    def get_frame_id_string(self, frame_id) -> str:
        return str(frame_id)

    # --------------------------- metadata ---------------------------
    def load_capture_metadata(self, scan_id: str):
        """Regex text-proto parse."""
        if scan_id in self.capture_metadata:
            return
        with open(os.path.join(self._scene_path(scan_id),
                               "frames.txt")) as f:
            data = f.read()

        starts = [m.start(0) for m in re.finditer(r"frames \{", data)]
        ends = [m.start(0) + 1 for m in re.finditer(r"\n\}", data)]
        frames = {}
        for idx, s in enumerate(starts):
            e = next(end for end in ends if end > s)
            block = data[s:e + 1]
            lines = block.split("\n")
            info = {"id": 0, "intrinsics": {}, "extrinsics": {},
                    "large_image": False}
            for li, line in enumerate(lines):
                if "id:" in line:
                    info["id"] = line.split(" ")[-1].strip()
                if "camera" in line:
                    info["intrinsics"] = {
                        "width": int(lines[li + 1].split(" ")[-1]),
                        "height": int(lines[li + 2].split(" ")[-1]),
                        "f": float(lines[li + 3].split(" ")[-1]),
                        "px": float(lines[li + 4].split(" ")[-1]),
                        "py": float(lines[li + 5].split(" ")[-1]),
                    }
                if "rotation:" in line:
                    seg = line.split("rotation:", 1)[1]
                    q = re.search(r"\[(.+?)\]", seg).group(1).split(",")
                    info["extrinsics"]["quadR"] = [float(v) for v in q]
                if "translation:" in line:
                    seg = line.split("translation:", 1)[1]
                    t = re.search(r"\[(.+?)\]", seg).group(1).split(",")
                    info["extrinsics"]["T"] = [float(v) for v in t]
                if "is_large_image:" in line and "true" in line:
                    info["large_image"] = True
            frames[str(idx)] = info
        self.capture_metadata[scan_id] = frames

    # --------------------------- paths ---------------------------
    def get_color_filepath(self, scan_id, frame_id) -> str:
        self.load_capture_metadata(scan_id)
        fid = self.capture_metadata[scan_id][str(frame_id)]["id"]
        return os.path.join(self._scene_path(scan_id), f"IMG_{fid}.jpg")

    def get_high_res_color_filepath(self, scan_id, frame_id) -> str:
        return self.get_color_filepath(scan_id, frame_id)

    def get_valid_frame_path(self, split, scan) -> str:
        return os.path.join(self._scene_path(scan.rstrip("\n")),
                            "valid_frames.txt")

    def get_valid_frame_ids(self, split, scan, store_computed=True
                            ) -> List[str]:
        scan = scan.rstrip("\n")
        valid_path = self.get_valid_frame_path(split, scan)
        if os.path.exists(valid_path):
            return dio.readlines(valid_path)
        self.load_capture_metadata(scan)
        valid, dist = [], 0
        for fid in sorted(self.capture_metadata[scan], key=int):
            world_T_cam, _ = self.load_pose(scan, fid)
            if np.isfinite(world_T_cam).all():
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

    # --------------------------- loading ---------------------------
    def load_pose(self, scan_id, frame_id):
        self.load_capture_metadata(scan_id)
        ext = self.capture_metadata[scan_id][str(frame_id)]["extrinsics"]
        world_T_cam = np.eye(4, dtype=np.float32)
        world_T_cam[:3, :3] = _quat_xyzw_to_rotmat(ext["quadR"])
        world_T_cam[:3, 3] = ext["T"]
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

    def load_intrinsics(self, scan_id, frame_id=None, flip: bool = False
                        ) -> Dict[str, np.ndarray]:
        self.load_capture_metadata(scan_id)
        intr = self.capture_metadata[scan_id][str(frame_id)]["intrinsics"]
        K = np.eye(4, dtype=np.float64)
        K[0, 0] = K[1, 1] = intr["f"]
        K[0, 2], K[1, 2] = intr["px"], intr["py"]
        return self._scaled_intrinsics(
            K, float(intr["width"]), float(intr["height"]),
            self.depth_width, self.depth_height, flip,
            self.include_full_depth_K)

    def load_target_size_depth_and_mask(self, scan_id, frame_id):
        shape = (1, self.depth_height, self.depth_width)
        return (np.ones(shape, np.float32), np.ones(shape, np.float32),
                np.ones(shape, bool))

    def load_full_res_depth_and_mask(self, scan_id, frame_id):
        shape = (1, self.depth_height, self.depth_width)
        return (np.ones(shape, np.float32), np.ones(shape, np.float32),
                np.ones(shape, bool))
