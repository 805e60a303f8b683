"""ios-logger (ARKit) capture preprocessing (counterpart of
`simplerecon_tpu/scripts/preprocess_ios_logger.py`): reads the frames of
`Frames.m4v` with OpenCV, pairs each line of `Frames.txt` (timestamp,
frame, fx, fy, cx, cy) with the line of `ARposes.txt` (timestamp, tx ty
tz, qw qx qy qz) nearest in time, turns the quaternions into matrices
with ARKit's axis flip and the `rotx(pi/2)` gravity alignment, and
writes the `images/` (PNG), `poses/` and `intrinsics/` layout that
`data/arkit.py::ArkitDataset` reads.

    python -m simplerecon_tpu_torch.scripts.preprocess_ios_logger \
        --dataset_path /mnt/arkit --scan_id my_scan
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from simplerecon_tpu_torch.ops.geometry import rotx

ARKIT_FLIP = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float64)


def quat_wxyz_to_rotmat(q) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def arkit_pose_to_world_T_cam(trans, quat_wxyz) -> np.ndarray:
    R = rotx(np.pi / 2) @ (quat_wxyz_to_rotmat(quat_wxyz) @ ARKIT_FLIP)
    world_T_cam = np.eye(4)
    world_T_cam[:3, :3] = R
    world_T_cam[:3, 3] = rotx(np.pi / 2) @ np.asarray(trans, np.float64)
    return world_T_cam


def _rows(lines, min_values: int) -> list:
    """The lines with at least `min_values` numbers (commas or spaces
    between them), as lists of floats."""
    rows = [[float(v) for v in line.replace(",", " ").split()]
            for line in lines]
    return [row for row in rows if len(row) >= min_values]


def sync_intrinsics_and_poses(frames_lines, pose_lines) -> list:
    """(frame row [ts, frame, fx, fy, cx, cy], pose row [ts, tx, ty, tz,
    qw, qx, qy, qz]) pairs, each frame with the pose nearest in time."""
    frames = _rows(frames_lines, 6)
    poses = _rows(pose_lines, 8)
    pose_ts = np.array([p[0] for p in poses])
    return [(f, poses[int(np.argmin(np.abs(pose_ts - f[0])))])
            for f in frames]


def process_scan(scan_dir: str) -> int:
    """Writes the scan's frames, poses and intrinsics; returns the number
    of frames written."""
    import cv2

    images_dir = os.path.join(scan_dir, "images")
    poses_dir = os.path.join(scan_dir, "poses")
    intr_dir = os.path.join(scan_dir, "intrinsics")
    for d in (images_dir, poses_dir, intr_dir):
        os.makedirs(d, exist_ok=True)

    def lines(name):
        with open(os.path.join(scan_dir, name)) as f:
            return [line for line in f if not line.startswith("#")]

    synced = sync_intrinsics_and_poses(lines("Frames.txt"),
                                       lines("ARposes.txt"))
    cap = cv2.VideoCapture(os.path.join(scan_dir, "Frames.m4v"))
    count = 0
    for frame_info, pose_info in synced:
        ok, frame = cap.read()
        if not ok:
            break
        fid = f"{count:06d}"
        cv2.imwrite(os.path.join(images_dir, f"{fid}.png"), frame)
        np.savetxt(os.path.join(poses_dir, f"{fid}.txt"),
                   arkit_pose_to_world_T_cam(pose_info[1:4], pose_info[4:8]))
        _, _, fx, fy, cx, cy = frame_info[:6]
        h, w = frame.shape[:2]
        np.savetxt(os.path.join(intr_dir, f"{fid}.txt"),
                   np.array([fx, fy, cx, cy, w, h]))
        count += 1
    cap.release()
    print(f"{scan_dir}: exported {count} frames")
    return count


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset_path", required=True)
    ap.add_argument("--scan_id", default=None)
    args = ap.parse_args(argv)
    scans_dir = os.path.join(args.dataset_path, "scans")
    scans = ([args.scan_id] if args.scan_id
             else sorted(os.listdir(scans_dir)))
    for scan in scans:
        process_scan(os.path.join(scans_dir, scan))


if __name__ == "__main__":
    main()
