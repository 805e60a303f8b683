"""Mesh renderer over the native rasterizer (counterpart of
`simplerecon_tpu/render/renderer.py`): `Renderer(height,
width).render_mesh(verts, faces, world_T_cam, K, ...)` returns an
(h, w, 3) uint8 image and a depth map; `SmoothBirdsEyeCamera` follows a
camera path from above.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from simplerecon_tpu_torch import native


def _lib():
    lib = native.load_library("rasterizer")
    lib.raster_mesh.restype = None
    lib.raster_mesh.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_float,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float)]
    return lib


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class Renderer:
    """Offscreen z-buffer renderer."""

    def __init__(self, height: int = 480, width: int = 640):
        self.height = height
        self.width = width
        self.lib = _lib()

    def render_mesh(self, vertices: np.ndarray, faces: np.ndarray,
                    world_T_cam: np.ndarray, K: np.ndarray,
                    vert_colors: Optional[np.ndarray] = None,
                    base_color=(0.75, 0.75, 0.75),
                    background=(1.0, 1.0, 1.0),
                    back_face_alpha: float = 0.0
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Renders a mesh seen from `world_T_cam` with pinhole `K`.

        Returns (rgb (h, w, 3) uint8, depth (h, w) float32, 0 where no
        face is hit).
        """
        cam_T_world = np.linalg.inv(np.asarray(world_T_cam, np.float64)
                                    ).astype(np.float32)
        verts = np.ascontiguousarray(vertices, np.float32)
        tris = np.ascontiguousarray(faces, np.int32)
        K33 = np.ascontiguousarray(np.asarray(K, np.float32)[:3, :3])

        rgb = np.empty((self.height, self.width, 3), np.uint8)
        rgb[:] = np.clip(np.asarray(background) * 255, 0,
                         255).astype(np.uint8)
        depth = np.zeros((self.height, self.width), np.float32)
        base = np.asarray(base_color, np.float32)

        colors_ptr = None
        if vert_colors is not None:
            vert_colors = np.ascontiguousarray(vert_colors, np.float32)
            colors_ptr = _fptr(vert_colors)

        self.lib.raster_mesh(
            _fptr(verts), len(verts),
            tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(tris),
            _fptr(np.ascontiguousarray(cam_T_world)), _fptr(K33),
            self.width, self.height,
            colors_ptr, _fptr(base),
            ctypes.c_float(back_face_alpha),
            rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            depth.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return rgb, depth


class SmoothBirdsEyeCamera:
    """Exponentially smoothed overhead follow camera: tracks the FPV
    camera's position with smoothing `alpha` and looks down at it from
    `height_above` metres up the gravity axis (`up_axis`, pointing
    down)."""

    def __init__(self, height_above: float = 4.0, alpha: float = 0.05,
                 up_axis: int = 1):
        self.height_above = height_above
        self.alpha = alpha
        self.up_axis = up_axis
        self._smoothed: Optional[np.ndarray] = None

    def get_bird_eye_trans(self, fpv_world_T_cam: np.ndarray
                           ) -> np.ndarray:
        """The bird's-eye camera's (4, 4) float64 world_T_cam for the next
        FPV pose."""
        target = np.asarray(fpv_world_T_cam, np.float64)[:3, 3]
        if self._smoothed is None:
            self._smoothed = target.copy()
        else:
            self._smoothed = (1 - self.alpha) * self._smoothed \
                + self.alpha * target
        eye = self._smoothed.copy()
        eye[self.up_axis] -= self.height_above

        # look at the target; x orthogonal to the world's up
        z = target - eye
        z = z / max(np.linalg.norm(z), 1e-9)
        up = np.zeros(3)
        up[(self.up_axis + 2) % 3] = 1.0
        x = np.cross(up, z)
        if np.linalg.norm(x) < 1e-6:
            up = np.zeros(3)
            up[(self.up_axis + 1) % 3] = 1.0
            x = np.cross(up, z)
        x = x / max(np.linalg.norm(x), 1e-9)
        y = np.cross(z, x)
        world_T_cam = np.eye(4)
        world_T_cam[:3, 0] = x
        world_T_cam[:3, 1] = y
        world_T_cam[:3, 2] = z
        world_T_cam[:3, 3] = eye
        return world_T_cam
