"""Mesh extraction and PLY I/O (counterpart of
`simplerecon_tpu/fusion/mesh.py`).

`marching_cubes` binds the native C++ kernel
(`simplerecon_tpu_torch/native/marching_cubes.cpp`, a copy of the JAX
package's); NaN voxels (unobserved space) generate no geometry. PLY read
and write are plain numpy: binary little-endian, with the vertex and face
layout of ScanNet GT meshes, and ascii on read.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Optional, Tuple

import numpy as np

from simplerecon_tpu_torch import native


def marching_cubes(volume_xyz: np.ndarray, level: float = 0.0
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Extracts the `level` isosurface of a 3D scalar field.

    Args:
        volume_xyz: (X, Y, Z) float array; NaNs mark unobserved voxels.
        level: iso level (0.0 for a TSDF).

    Returns:
        (vertices (V, 3) float32 in voxel coordinates, faces (F, 3) int32).
    """
    lib = native.load_library("marching_cubes")
    lib.mc_run.restype = ctypes.c_int
    lib.mc_run.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]

    vol = np.ascontiguousarray(volume_xyz, np.float32)
    nx, ny, nz = vol.shape
    verts_p = ctypes.POINTER(ctypes.c_float)()
    faces_p = ctypes.POINTER(ctypes.c_int32)()
    nv = ctypes.c_int64()
    nf = ctypes.c_int64()
    rc = lib.mc_run(vol.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    nx, ny, nz, ctypes.c_float(level),
                    ctypes.byref(verts_p), ctypes.byref(faces_p),
                    ctypes.byref(nv), ctypes.byref(nf))
    if rc != 0:
        raise RuntimeError("marching_cubes native kernel failed")
    try:
        v = np.ctypeslib.as_array(verts_p, shape=(nv.value, 3)).copy() \
            if nv.value else np.zeros((0, 3), np.float32)
        f = np.ctypeslib.as_array(faces_p, shape=(nf.value, 3)).copy() \
            if nf.value else np.zeros((0, 3), np.int32)
    finally:
        lib.mc_free(verts_p)
        lib.mc_free(faces_p)
    return v.astype(np.float32), f.astype(np.int32)


def write_ply(path: str, vertices: np.ndarray, faces: np.ndarray,
              colors: Optional[np.ndarray] = None):
    """Binary little-endian PLY with optional per-vertex uchar colors."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int32)
    n_v, n_f = len(vertices), len(faces)
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n_v}",
              "property float x", "property float y", "property float z"]
    if colors is not None:
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors = np.clip(colors * 255.0, 0, 255).astype(np.uint8)
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header += [f"element face {n_f}",
               "property list uchar int vertex_indices", "end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if colors is not None:
            rec = np.zeros(n_v, dtype=[("xyz", np.float32, 3),
                                       ("rgb", np.uint8, 3)])
            rec["xyz"], rec["rgb"] = vertices, colors
            f.write(rec.tobytes())
        else:
            f.write(vertices.tobytes())
        face_rec = np.zeros(n_f, dtype=[("n", np.uint8),
                                        ("idx", np.int32, 3)])
        face_rec["n"] = 3
        face_rec["idx"] = faces
        f.write(face_rec.tobytes())


def read_ply(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Reads vertices/faces from ascii or binary-LE PLY (subset: float32
    x/y/z leading vertex properties, uchar-count int32 face lists)."""
    with open(path, "rb") as f:
        # ---- header ----
        line = f.readline().strip()
        assert line == b"ply", f"not a ply file: {path}"
        fmt = None
        n_vert = n_face = 0
        vert_props = []  # (name, dtype-size) for the vertex element
        cur_element = None
        while True:
            line = f.readline().strip().decode()
            if line == "end_header":
                break
            parts = line.split()
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                cur_element = parts[1]
                if parts[1] == "vertex":
                    n_vert = int(parts[2])
                elif parts[1] == "face":
                    n_face = int(parts[2])
            elif parts[0] == "property" and cur_element == "vertex" \
                    and parts[1] != "list":
                vert_props.append((parts[2], parts[1]))

        type_map = {"float": ("f4", 4), "float32": ("f4", 4),
                    "double": ("f8", 8), "uchar": ("u1", 1),
                    "uint8": ("u1", 1), "int": ("i4", 4),
                    "int32": ("i4", 4), "ushort": ("u2", 2),
                    "short": ("i2", 2), "uint": ("u4", 4)}

        if fmt == "ascii":
            verts = np.zeros((n_vert, 3), np.float32)
            for i in range(n_vert):
                vals = f.readline().split()
                verts[i] = [float(v) for v in vals[:3]]
            faces = np.zeros((n_face, 3), np.int32)
            for i in range(n_face):
                vals = f.readline().split()
                faces[i] = [int(v) for v in vals[1:4]]
            return verts, faces

        # binary little endian
        dtype = np.dtype([(name, type_map[t][0])
                          for name, t in vert_props])
        vert_data = np.frombuffer(f.read(dtype.itemsize * n_vert),
                                  dtype=dtype, count=n_vert)
        verts = np.stack([vert_data["x"], vert_data["y"],
                          vert_data["z"]], axis=1).astype(np.float32)
        faces = np.zeros((n_face, 3), np.int32)
        raw = f.read()
        off = 0
        for i in range(n_face):
            n = raw[off]
            off += 1
            faces[i] = struct.unpack_from("<3i", raw, off)[:3]
            off += 4 * n
        return verts, faces
