"""Generic MVS dataset base class, host-side numpy (counterpart of
`simplerecon_tpu/data/generic_dataset.py`): each element is a
`(cur_data, src_data)` pair of dicts with the reference's key schema
(`image_b3hw`, `depth_b1hw`, `mask_b1hw`, `mask_b_b1hw`,
`world_T_cam_b44`, `cam_T_world_b44`, `K_s{i}_b44`, `invK_s{i}_b44`,
...), stored per frame as numpy arrays (the loader adds the batch dim).

  * tuple file `{split}{mv_tuple_file_suffix}` with lines
    `scan_id f0 f1 ... fN-1`, f0 the reference frame;
  * a 50% geometric flip at train time: pose right-multiplied by
    diag(-1,1,1,1), images and depths x-flipped, intrinsics cx mirrored;
  * ColorJitter(0.2,0.2,0.2,0.2) on train colour;
  * every random draw of an item (the flip coin, the jitter's order and
    factors, the `shuffle_tuple` shuffle) from one `RandomState`: the
    one `__getitem__` is given (the loader gives each item its own, from
    (seed, epoch, index): `loader.item_rng`), else the dataset's `rng`;
  * imagenet normalisation;
  * NaN where depth is invalid;
  * source frames sorted by DVMVS pose distance to the reference.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from simplerecon_tpu_torch.data import io as dio


class GenericMVSDataset:
    # subclasses override
    def get_sub_folder_dir(self, split: str) -> str:
        return ""

    def __init__(self,
                 dataset_path: str,
                 split: str,
                 mv_tuple_file_suffix: Optional[str],
                 tuple_info_file_location: Optional[str] = None,
                 limit_to_scan_id: Optional[str] = None,
                 num_images_in_tuple: Optional[int] = None,
                 image_height: int = 384,
                 image_width: int = 512,
                 high_res_image_width: int = 640,
                 high_res_image_height: int = 480,
                 image_depth_ratio: int = 2,
                 shuffle_tuple: bool = False,
                 include_full_res_depth: bool = False,
                 include_high_res_color: bool = False,
                 include_full_depth_K: bool = False,
                 pass_frame_id: bool = False,
                 skip_frames: Optional[int] = None,
                 skip_to_frame: Optional[int] = None,
                 color_jitter: bool = True,
                 decode_cache_size: int = 128,
                 rng: Optional[np.random.RandomState] = None):
        self.dataset_path = dataset_path
        self.split = split
        self.scenes_path = os.path.join(dataset_path,
                                        self.get_sub_folder_dir(split))
        self.mv_tuple_file_suffix = mv_tuple_file_suffix
        self.num_images_in_tuple = num_images_in_tuple
        self.shuffle_tuple = shuffle_tuple

        self.image_width = image_width
        self.image_height = image_height
        self.high_res_image_width = high_res_image_width
        self.high_res_image_height = high_res_image_height
        self.depth_height = image_height // image_depth_ratio
        self.depth_width = image_width // image_depth_ratio

        self.include_full_res_depth = include_full_res_depth
        self.include_high_res_color = include_high_res_color
        self.include_full_depth_K = include_full_depth_K
        self.pass_frame_id = pass_frame_id

        # the draws of an item called without a state of its own
        self.rng = rng if rng is not None else np.random.RandomState(0)
        self.color_transform = (dio.ColorJitter(rng=self.rng)
                                if color_jitter else None)

        # LRU cache of DETERMINISTIC per-frame decodes (color before
        # augmentation, depth, pose, intrinsics). Consecutive tuples in a
        # scan share most frames, so this cuts host decode work ~8x for
        # 8-view tuples. Augmentation (jitter, flip) happens after the
        # cache, so randomness is preserved; cached arrays are never
        # mutated in place downstream.
        from collections import OrderedDict
        import threading
        self._decode_cache: "OrderedDict" = OrderedDict()
        self._decode_cache_size = decode_cache_size
        self._decode_lock = threading.Lock()

        self.frame_tuples: List[str] = []
        if mv_tuple_file_suffix is not None:
            loc = tuple_info_file_location or os.path.join(dataset_path,
                                                           "tuples")
            path = os.path.join(loc, f"{split}{mv_tuple_file_suffix}")
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"tuple file {path} doesn't exist; pass "
                    "mv_tuple_file_suffix=None if you don't need tuples")
            self.frame_tuples = dio.readlines(path)
            if limit_to_scan_id is not None:
                self.frame_tuples = [
                    t for t in self.frame_tuples
                    if t.split(" ")[0] == limit_to_scan_id]
            if skip_to_frame is not None:
                self.frame_tuples = self.frame_tuples[skip_to_frame:]
            if skip_frames is not None:
                self.frame_tuples = self.frame_tuples[::skip_frames]

    def __len__(self) -> int:
        return len(self.frame_tuples)

    # ----------------------------------------------------------------
    # per-dataset hooks
    # ----------------------------------------------------------------
    def load_pose(self, scan_id, frame_id
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (world_T_cam, cam_T_world), each (4, 4) float."""
        raise NotImplementedError

    def load_color(self, scan_id, frame_id) -> np.ndarray:
        """(3, image_height, image_width) float32 in [0, 1]."""
        raise NotImplementedError

    def load_intrinsics(self, scan_id, frame_id=None, flip: bool = False
                        ) -> Dict[str, np.ndarray]:
        """K_s{0..4}_b44 + inverses (+ K_full_depth_b44 when enabled)."""
        raise NotImplementedError

    def load_target_size_depth_and_mask(self, scan_id, frame_id):
        """(depth (1,h,w) with NaN invalid, mask float, mask_b bool)."""
        raise NotImplementedError

    def load_full_res_depth_and_mask(self, scan_id, frame_id):
        raise NotImplementedError

    def load_high_res_color(self, scan_id, frame_id) -> np.ndarray:
        raise NotImplementedError

    def get_frame_id_string(self, frame_id) -> str:
        return str(frame_id)

    def get_valid_frame_ids(self, split, scan, store_computed=True):
        raise NotImplementedError

    def get_gt_mesh_path(self, dataset_path, split, scan_id) -> str:
        raise NotImplementedError

    # ----------------------------------------------------------------
    # shared element assembly
    # ----------------------------------------------------------------
    @staticmethod
    def _scaled_intrinsics(K_44: np.ndarray, native_w: float,
                           native_h: float, depth_w: int, depth_h: int,
                           flip: bool, include_full: bool
                           ) -> Dict[str, np.ndarray]:
        """Shared helper: mirror cx when flipped (at native res), scale to
        the depth (s0) resolution, then halve through s4."""
        K = K_44.astype(np.float64).copy()
        if flip:
            K[0, 2] = native_w - K[0, 2]
        out = {}
        if include_full:
            out["K_full_depth_b44"] = K.astype(np.float32).copy()
            out["invK_full_depth_b44"] = np.linalg.inv(K).astype(np.float32)
        K[0] *= depth_w / native_w
        K[1] *= depth_h / native_h
        for i in range(5):
            Ks = K.copy()
            Ks[:2] /= 2 ** i
            out[f"K_s{i}_b44"] = Ks.astype(np.float32)
            out[f"invK_s{i}_b44"] = np.linalg.inv(Ks).astype(np.float32)
        return out

    def _decode_frame(self, scan_id, frame_id, load_depth: bool):
        """Cached deterministic decode: pose, color (pre-augmentation),
        depth/mask."""
        if not hasattr(self, "_decode_cache"):  # subclasses that skip
            from collections import OrderedDict  # the base __init__
            import threading
            self._decode_cache = OrderedDict()
            self._decode_cache_size = 128
            self._decode_lock = threading.Lock()
        key = (scan_id, frame_id, load_depth)
        with self._decode_lock:
            if key in self._decode_cache:
                self._decode_cache.move_to_end(key)
                return self._decode_cache[key]
        pose = self.load_pose(scan_id, frame_id)
        color = self.load_color(scan_id, frame_id)
        depth = (self.load_target_size_depth_and_mask(scan_id, frame_id)
                 if load_depth else None)
        entry = (pose, color, depth)
        if self._decode_cache_size > 0:
            with self._decode_lock:
                self._decode_cache[key] = entry
                while len(self._decode_cache) > self._decode_cache_size:
                    self._decode_cache.popitem(last=False)
        return entry

    def get_frame(self, scan_id, frame_id, load_depth: bool,
                  flip: bool = False,
                  rng: Optional[np.random.RandomState] = None
                  ) -> Dict[str, np.ndarray]:
        """One frame's data; the colour jitter draws from `rng` (by
        default the dataset's)."""
        out: Dict[str, np.ndarray] = {}

        (world_T_cam, cam_T_world), image, depth_entry = \
            self._decode_frame(scan_id, frame_id, load_depth)
        if flip:
            T = np.eye(4, dtype=world_T_cam.dtype)
            T[0, 0] = -1.0
            world_T_cam = world_T_cam @ T
            cam_T_world = np.linalg.inv(world_T_cam)

        if self.split == "train" and self.color_transform is not None:
            image = self.color_transform(image, rng)
        if flip:
            image = image[..., ::-1].copy()
        image = dio.imagenet_normalize_np(image)

        out.update({
            "image_b3hw": image.astype(np.float32),
            "world_T_cam_b44": world_T_cam.astype(np.float32),
            "cam_T_world_b44": cam_T_world.astype(np.float32),
        })
        out.update(self.load_intrinsics(scan_id, frame_id, flip=flip))

        if load_depth:
            depth, mask, mask_b = depth_entry
            if flip:
                depth = depth[..., ::-1].copy()
                mask = mask[..., ::-1].copy()
                mask_b = mask_b[..., ::-1].copy()
            out.update({"depth_b1hw": depth.astype(np.float32),
                        "mask_b1hw": mask.astype(np.float32),
                        "mask_b_b1hw": mask_b.astype(bool)})

        if self.include_high_res_color:
            hrc = dio.imagenet_normalize_np(
                self.load_high_res_color(scan_id, frame_id))
            if flip:
                hrc = hrc[..., ::-1].copy()
            out["high_res_color_b3hw"] = hrc

        if self.include_full_res_depth:
            frd, frm, frmb = self.load_full_res_depth_and_mask(scan_id,
                                                               frame_id)
            if flip:
                frd = frd[..., ::-1].copy()
                frm = frm[..., ::-1].copy()
                frmb = frmb[..., ::-1].copy()
            out.update({"full_res_depth_b1hw": frd.astype(np.float32),
                        "full_res_mask_b1hw": frm.astype(np.float32),
                        "full_res_mask_b_b1hw": frmb.astype(bool)})

        if self.pass_frame_id:
            out["frame_id_string"] = self.get_frame_id_string(frame_id)
        return out

    @staticmethod
    def stack_src_data(src_data: List[Dict]) -> Dict[str, np.ndarray]:
        """Stacks the source frames' arrays (frame ids as lists)."""
        stacked = {}
        for name in src_data[0].keys():
            if "frame_id_string" in name:
                stacked[name] = [f[name] for f in src_data]
            else:
                stacked[name] = np.stack([f[name] for f in src_data], 0)
        return stacked

    def __getitem__(self, idx: int,
                    rng: Optional[np.random.RandomState] = None
                    ) -> Tuple[Dict, Dict]:
        """Item `idx`; its flip coin, shuffle and colour jitter draw from
        `rng`, by default the dataset's own state."""
        rng = self.rng if rng is None else rng
        flip_threshold = 0.5 if self.split == "train" else 0.0
        flip = bool(rng.rand() < flip_threshold)

        scan_id, *frame_ids = self.frame_tuples[idx].split(" ")

        if self.shuffle_tuple:  # ablation switch
            rest = frame_ids[1:]
            rng.shuffle(rest)
            frame_ids = [frame_ids[0]] + rest

        if self.num_images_in_tuple is not None:
            frame_ids = frame_ids[:self.num_images_in_tuple]

        frames = [self.get_frame(scan_id, fid, load_depth=True, flip=flip,
                                 rng=rng)
                  for fid in frame_ids]
        cur_data, *src_list = frames

        if not self.shuffle_tuple:
            # sort sources by DVMVS pose distance to the reference
            src_world_T_cam = np.stack(
                [f["world_T_cam_b44"] for f in src_list], 0)
            cur_cam_T_src = cur_data["cam_T_world_b44"][None] \
                @ src_world_T_cam
            penalty, _, _ = dio.pose_distance_np(cur_cam_T_src)
            src_list = [src_list[i] for i in np.argsort(penalty)]

        return cur_data, self.stack_src_data(src_list)
