"""CLI: re-color scan meshes by their vertex normals.

Counterpart of
`simplerecon_tpu/scripts/load_meshes_and_include_normals.py`: reads
each scan's PLY, computes area-weighted vertex normals (host-side numpy
— the reference delegates to open3d's `compute_vertex_normals`), maps
them to RGB as 0.5 * (1 + n), and writes a normal-colored PLY.

    python -m simplerecon_tpu_torch.scripts.load_meshes_and_include_normals \
        --input_path .../meshes/0.04_3.0_color/ \
        --output_path .../meshes/0.04_3.0_color_normals/

or, mirroring the reference's ScanNet pattern mode:

    ... --scannet_scans_path_pattern path_to/SCAN_NAME.ply \
        --scan_list data_splits/ScanNetv2/standard_split/\
scannetv2_test.txt --output_path OUT
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from simplerecon_tpu_torch.fusion.mesh import read_ply, write_ply


def vertex_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted per-vertex normals (open3d
    `compute_vertex_normals` semantics: un-normalized face cross
    products accumulated per vertex, then L2-normalized)."""
    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64)
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    vn = np.zeros_like(v)
    for i in range(3):
        np.add.at(vn, f[:, i], fn)
    norm = np.linalg.norm(vn, axis=-1, keepdims=True)
    return (vn / np.maximum(norm, 1e-12)).astype(np.float32)


def process_mesh(in_path: str, out_path: str) -> None:
    vertices, faces = read_ply(in_path)
    normals = vertex_normals(vertices, faces)
    colors = 0.5 * (1.0 + normals)
    write_ply(out_path, vertices, faces, colors=colors)


def main(argv=None):
    parser = argparse.ArgumentParser(description="mesh normal visualizer")
    parser.add_argument("--scannet_scans_path_pattern", default=None,
                        help="pattern with SCAN_NAME placeholder, e.g. "
                             "path_to_scans/SCAN_NAME.ply")
    parser.add_argument("--scan_list", default=None,
                        help="text file of scan names for the pattern "
                             "mode (one per line)")
    parser.add_argument("--input_path", default=None,
                        help="directory of *.ply meshes")
    parser.add_argument("--output_path", required=True)
    args = parser.parse_args(argv)

    os.makedirs(args.output_path, exist_ok=True)

    if args.scannet_scans_path_pattern:
        if not args.scan_list:
            raise SystemExit("--scan_list is required with "
                             "--scannet_scans_path_pattern")
        with open(args.scan_list) as f:
            scans = [line.strip() for line in f if line.strip()]
        mesh_paths = [args.scannet_scans_path_pattern
                      .replace("SCAN_NAME", scan) for scan in scans]
    elif args.input_path:
        mesh_paths = sorted(glob.glob(os.path.join(args.input_path,
                                                   "*.ply")))
    else:
        raise SystemExit("No valid input path found.")

    for path in mesh_paths:
        name = os.path.splitext(os.path.basename(path))[0]
        out = os.path.join(args.output_path, f"{name}.ply")
        process_mesh(path, out)
        print(f"{path} -> {out}")


if __name__ == "__main__":
    main()
