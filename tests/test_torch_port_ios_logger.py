"""The port's `scripts/preprocess_ios_logger.py` against the JAX
script, on the CPU: a tiny ios-logger capture (`testing.write_ios_capture`:
a `Frames.m4v` written with `cv2.VideoWriter`, `Frames.txt` and
`ARposes.txt` with comment lines and more poses than frames, at other
timestamps) goes
through both scripts' `process_scan`: the same files, equal PNG pixels
(read by cv2 and by the port's decoder), equal pose and intrinsics text.
"""

import os
import shutil

import numpy as np

FRAMES, H, W = 5, 48, 64


def write_capture(scan_dir):
    from simplerecon_tpu_torch.testing import write_ios_capture
    rng = np.random.RandomState(0)
    frames = []
    for i in range(FRAMES):
        frame = np.zeros((H, W, 3), np.uint8)
        frame[:, :, 0] = (np.arange(W) * 4 + 20 * i) % 256
        frame[:, :, 1] = (np.arange(H)[:, None] * 5) % 256
        frame[:, :, 2] = rng.randint(0, 256)
        frames.append(frame)
    write_ios_capture(scan_dir, frames)


def test_ios_logger_outputs_match_jax(tmp_path):
    import cv2
    from simplerecon_tpu.scripts import preprocess_ios_logger as jax_script
    from simplerecon_tpu_torch.data import codec
    from simplerecon_tpu_torch.scripts import preprocess_ios_logger as port
    write_capture(str(tmp_path / "port"))
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    assert port.process_scan(str(tmp_path / "port")) == FRAMES
    jax_script.process_scan(str(tmp_path / "jax"))
    for sub in ("images", "poses", "intrinsics"):
        names = sorted(os.listdir(tmp_path / "jax" / sub))
        assert len(names) == FRAMES
        assert sorted(os.listdir(tmp_path / "port" / sub)) == names
        for name in names:
            got, want = (str(tmp_path / pkg / sub / name)
                         for pkg in ("port", "jax"))
            if sub == "images":
                pixels = cv2.imread(got)
                assert pixels.shape == (H, W, 3)
                np.testing.assert_array_equal(pixels, cv2.imread(want))
                np.testing.assert_array_equal(codec.read_image(got),
                                              pixels[..., ::-1])
            else:
                with open(got) as g, open(want) as w:
                    assert g.read() == w.read(), name


def test_pose_conversion_and_sync_match_jax():
    from simplerecon_tpu.scripts import preprocess_ios_logger as jax_script
    from simplerecon_tpu_torch.scripts import preprocess_ios_logger as port
    rng = np.random.RandomState(3)
    for _ in range(5):
        q = rng.randn(4)
        q /= np.linalg.norm(q)
        t = rng.randn(3)
        np.testing.assert_array_equal(
            port.arkit_pose_to_world_T_cam(t, q),
            jax_script.arkit_pose_to_world_T_cam(t, q))
    frames = ["0.10 0 1 2 3 4", "0.2 1 2", "0.31,1,1,2,3,4"]
    poses = ["0.0 1 2 3 1 0 0 0", "0.3 4 5 6 0 1 0 0", "1.0 7 8 9 0 0 1 0"]
    assert port.sync_intrinsics_and_poses(frames, poses) == \
        jax_script.sync_intrinsics_and_poses(frames, poses)
