"""Synthetic multi-view dataset rendered with the native rasterizer
(counterpart of `simplerecon_tpu/data/synthetic.py`).

Geometrically consistent RGB, depth and poses without external data: a
finely tessellated "room" (floor, back wall, side wall) with random
vertex colours (texture for the matching network), rendered from a
smooth camera trajectory. Dataset name "synthetic" in the registry.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from simplerecon_tpu_torch.data.generic_dataset import GenericMVSDataset


def make_room_mesh(tess: int = 64, seed: int = 0
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A simple room: floor (y=1), back wall (z=4), left wall (x=-2).

    Returns (vertices (V,3), faces (F,3), colors (V,3) in [0,1]) with
    `tess`x`tess` tessellation per surface so random vertex colors act
    as a high-frequency texture.
    """
    rng = np.random.RandomState(seed)
    verts: List[np.ndarray] = []
    faces: List[np.ndarray] = []

    def add_quad_grid(origin, du, dv):
        base = sum(len(vv) for vv in verts)
        u = np.linspace(0, 1, tess + 1)
        v = np.linspace(0, 1, tess + 1)
        uu, vv = np.meshgrid(u, v, indexing="ij")
        pts = (np.asarray(origin)[None, None]
               + uu[..., None] * np.asarray(du)[None, None]
               + vv[..., None] * np.asarray(dv)[None, None])
        verts.append(pts.reshape(-1, 3))
        idx = np.arange((tess + 1) * (tess + 1)).reshape(tess + 1,
                                                         tess + 1) + base
        a = idx[:-1, :-1].reshape(-1)
        b = idx[1:, :-1].reshape(-1)
        c = idx[1:, 1:].reshape(-1)
        d = idx[:-1, 1:].reshape(-1)
        faces.append(np.stack([a, b, c], 1))
        faces.append(np.stack([a, c, d], 1))

    # winding chosen so faces point toward the camera region (the
    # rasterizer culls back faces)
    add_quad_grid([-2.0, 1.0, 0.0], [4.0, 0.0, 0.0], [0.0, 0.0, 5.0])
    add_quad_grid([-2.0, -1.5, 4.0], [0.0, 2.5, 0.0], [4.0, 0.0, 0.0])
    add_quad_grid([-2.0, -1.5, 0.0], [0.0, 2.5, 0.0], [0.0, 0.0, 5.0])

    v = np.concatenate(verts).astype(np.float32)
    f = np.concatenate(faces).astype(np.int32)
    colors = rng.rand(len(v), 3).astype(np.float32)
    return v, f, colors


def camera_trajectory(n_frames: int, radius: float = 0.35,
                      step: float = 0.06) -> List[np.ndarray]:
    """Gentle forward walk with lateral sway, looking down +z.

    The default step keeps 48 frames inside the room (back wall at
    z = 4 m): cameras past the wall see nothing, every masked loss term
    zeroes out, and training silently walks on empty batches."""
    poses = []
    for i in range(n_frames):
        world_T_cam = np.eye(4, dtype=np.float64)
        world_T_cam[0, 3] = radius * np.sin(0.55 * i)
        world_T_cam[1, 3] = 0.15 * np.cos(0.4 * i)
        world_T_cam[2, 3] = step * i
        # slight yaw so views genuinely differ
        yaw = 0.1 * np.sin(0.3 * i)
        cy, sy = np.cos(yaw), np.sin(yaw)
        world_T_cam[:3, :3] = np.array([[cy, 0, sy], [0, 1, 0],
                                        [-sy, 0, cy]])
        poses.append(world_T_cam)
    return poses


DEFAULT_NUM_FRAMES = 48


class SyntheticDataset(GenericMVSDataset):
    """In-memory rendered dataset; scan_id is ignored (one scene).

    Frames are rendered lazily with the native rasterizer and cached.
    Tuples are consecutive-frame windows ending at the reference, built
    internally (no tuple file needed).
    """

    def __init__(self, num_frames: int | None = None, image_height: int = 64,
                 image_width: int = 96, num_images_in_tuple: int = 4,
                 split: str = "train", seed: int = 0, **kwargs):
        if num_frames is None:
            # settable default, so that a CLI that builds the dataset
            # through the registry (which has no num_frames) can size
            # the scene
            num_frames = DEFAULT_NUM_FRAMES
        # bypass GenericMVSDataset file plumbing entirely
        self.split = split
        self.image_height = image_height
        self.image_width = image_width
        self.depth_height = image_height // 2
        self.depth_width = image_width // 2
        self.num_images_in_tuple = num_images_in_tuple
        self.shuffle_tuple = False
        self.include_high_res_color = False
        self.include_full_res_depth = bool(
            kwargs.get("include_full_res_depth", False))
        self.include_full_depth_K = bool(
            kwargs.get("include_full_depth_K", False))
        self.pass_frame_id = bool(kwargs.get("pass_frame_id", False))
        self.rng = np.random.RandomState(seed)
        self.color_transform = None

        from simplerecon_tpu_torch.render.renderer import Renderer
        self._mesh = make_room_mesh(seed=seed)
        self._poses = camera_trajectory(num_frames)
        self._renderer = Renderer(image_height, image_width)
        self._K = np.eye(4, dtype=np.float64)
        f = 0.9 * image_width
        self._K[0, 0], self._K[1, 1] = f, f
        self._K[0, 2], self._K[1, 2] = image_width / 2, image_height / 2
        self._cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

        n = num_images_in_tuple
        self.frame_tuples = [
            "scene " + " ".join(str(j) for j in
                                [i] + list(range(i - n + 1, i)))
            for i in range(n - 1, num_frames)]

    # ----------------------------------------------------------------
    def _render(self, idx: int):
        if idx not in self._cache:
            v, f, c = self._mesh
            rgb, depth = self._renderer.render_mesh(
                v, f, self._poses[idx], self._K, vert_colors=c,
                background=(0.0, 0.0, 0.0))
            self._cache[idx] = (rgb.astype(np.float32) / 255.0, depth)
        return self._cache[idx]

    def load_pose(self, scan_id, frame_id):
        world_T_cam = self._poses[int(frame_id)].astype(np.float32)
        return world_T_cam, np.linalg.inv(world_T_cam)

    def load_color(self, scan_id, frame_id):
        rgb, _ = self._render(int(frame_id))
        return rgb.transpose(2, 0, 1)

    def load_intrinsics(self, scan_id, frame_id=None, flip: bool = False):
        return self._scaled_intrinsics(
            self._K, float(self.image_width), float(self.image_height),
            self.depth_width, self.depth_height, flip,
            self.include_full_depth_K)

    def get_frame_id_string(self, frame_id):
        return str(frame_id)

    def load_full_res_depth_and_mask(self, scan_id, frame_id):
        _, depth = self._render(int(frame_id))
        mask_b = depth[None] > 0
        d = np.where(mask_b, depth[None], np.nan).astype(np.float32)
        return d, mask_b.astype(np.float32), mask_b

    def load_target_size_depth_and_mask(self, scan_id, frame_id):
        _, depth = self._render(int(frame_id))
        dh, dw = self.depth_height, self.depth_width
        iy = (np.arange(dh) * depth.shape[0] / dh).astype(np.int64)
        ix = (np.arange(dw) * depth.shape[1] / dw).astype(np.int64)
        d = depth[iy][:, ix][None]
        mask_b = d > 0
        d = np.where(mask_b, d, np.nan).astype(np.float32)
        return d, mask_b.astype(np.float32), mask_b
