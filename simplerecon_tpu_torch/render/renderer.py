"""Mesh renderer over the native rasterizer (counterpart of
`simplerecon_tpu/render/renderer.py`): `Renderer(height,
width).render_mesh(verts, faces, world_T_cam, K, ...)` returns an
(h, w, 3) uint8 image and a depth map.
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
