"""The port's visualization pieces against the JAX package's, on the CPU:
`render/renderer.py::SmoothBirdsEyeCamera`,
`scripts/visualize_scene_depth_output.py` (`build_frame_panels` and the
CLI) and `scripts/visualize_live_meshing.py`, with each CLI's
`write_video` replaced by one that keeps the frames.

- The bird's-eye poses over the synthetic camera path: equal (the same
  float64 numpy arithmetic).
- `write_video` through OpenCV and, when `cv2` does not import, as PNGs:
  the mp4s decode to the same frames as the JAX function's, the PNGs
  hold the same pixels.
- `build_frame_panels` on seeded inputs, with and without GT and source
  frames, and the depth-video CLIs over one cache of depth pickles (the
  9-frame synthetic scene, a GT min/max cache for half the frames):
  equal bits.
- The live-meshing CLIs on the 9-frame synthetic scene (6 keyframes at
  b1) at 64x96, 4 views, 8 planes, float32, with the port's seeded
  weights (a weights file for the port, `convert_state_dict` for the
  JAX CLI), a 16 cm TSDF, rendering at 96x128: the same number of
  frames in both videos, every frame in [0, 1], and each frame within
  1/255 of JAX's at 99% of its values. The two forwards' depths differ by ~1e-5
  (`test_torch_port_eval.py`), which may move a TSDF zero crossing and so
  a few rendered pixels.
"""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

import simplerecon_tpu.data.synthetic as jsynthetic
import simplerecon_tpu.scripts.visualize_live_meshing as jlive
import simplerecon_tpu.scripts.visualize_scene_depth_output as jdepth
import simplerecon_tpu_torch.data.synthetic as tsynthetic
import simplerecon_tpu_torch.scripts.visualize_live_meshing as tlive
import simplerecon_tpu_torch.scripts.visualize_scene_depth_output as tdepth
from simplerecon_tpu.options import OptionsHandler as JaxHandler
from simplerecon_tpu.render import SmoothBirdsEyeCamera as JaxBirdsEye
from simplerecon_tpu.utils.convert_reference_checkpoint import \
    convert_state_dict
from simplerecon_tpu_torch.data.synthetic import (SyntheticDataset,
                                                  camera_trajectory)
from simplerecon_tpu_torch.models.depth_model import build_depth_model
from simplerecon_tpu_torch.options import OptionsHandler
from simplerecon_tpu_torch.render.renderer import SmoothBirdsEyeCamera
from simplerecon_tpu_torch.testing import spread_outputs_
from simplerecon_tpu_torch.utils.cache import cache_model_outputs
from simplerecon_tpu_torch.utils.checkpoint import save_weights
from test_torch_port_ops import few_torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 64, 96


@pytest.mark.parametrize("up_axis", [1, 2])
def test_birds_eye_poses_match_jax(up_axis):
    port = SmoothBirdsEyeCamera(up_axis=up_axis)
    ref = JaxBirdsEye(up_axis=up_axis)
    poses = camera_trajectory(48)
    for pose in poses:
        np.testing.assert_array_equal(port.get_bird_eye_trans(pose),
                                      ref.get_bird_eye_trans(pose))


@pytest.mark.parametrize("route", ["cv2", "png"])
def test_write_video_matches_jax(tmp_path, monkeypatch, route):
    from simplerecon_tpu.utils.visualization import \
        write_video as jax_write_video
    from simplerecon_tpu_torch.data.io import read_image_file
    from simplerecon_tpu_torch.utils.visualization import write_video
    if route == "png":
        monkeypatch.setitem(sys.modules, "cv2", None)
    rng = np.random.RandomState(6)
    frames = [rng.uniform(-0.1, 1.1, (48, 64, 3)).astype(np.float32)
              for _ in range(5)]
    got = write_video(str(tmp_path / "port.mp4"), frames, fps=10)
    want = jax_write_video(str(tmp_path / "jax.mp4"), frames, fps=10)
    if route == "png":
        assert got == str(tmp_path / "port")
        names = sorted(os.listdir(got))
        assert names == sorted(os.listdir(want)) and len(names) == 5
        for name in names:
            np.testing.assert_array_equal(
                read_image_file(os.path.join(got, name)),
                read_image_file(os.path.join(want, name)))
        return
    import cv2
    assert got == str(tmp_path / "port.mp4")
    decoded = []
    for path in (got, want):
        cap = cv2.VideoCapture(path)
        decoded.append([])
        ok, frame = cap.read()
        while ok:
            decoded[-1].append(frame)
            ok, frame = cap.read()
        cap.release()
    assert len(decoded[0]) == len(decoded[1]) == 5
    for g, w in zip(*decoded):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("with_gt", [True, False], ids=["gt", "no_gt"])
def test_frame_panels_match_jax(with_gt):
    rng = np.random.RandomState(4)
    rgb = rng.randn(3, H, W).astype(np.float32)
    srcs = rng.randn(3, 3, H, W).astype(np.float32) if with_gt else None
    depth = rng.uniform(0.5, 4.0, (H // 2, W // 2)).astype(np.float32)
    lowest = rng.uniform(0.5, 4.0, (H // 2, W // 2)).astype(np.float32)
    gt = None
    if with_gt:
        gt = rng.uniform(0.5, 4.0, (H, W)).astype(np.float32)
        gt[::5, ::3] = np.nan
    invK = np.linalg.inv(np.array([[40.0, 0, 24, 0], [0, 40.0, 16, 0],
                                   [0, 0, 1, 0], [0, 0, 0, 1]],
                                  np.float32))
    args = (rgb, srcs, depth, lowest, gt, invK, 0.6, 3.5)
    got = tdepth.build_frame_panels(*args, panel_hw=(H, W))
    want = jdepth.build_frame_panels(*args, panel_hw=(H, W))
    assert got.shape[0] % 16 == 0 and got.shape[1] % 16 == 0
    np.testing.assert_array_equal(got, want)


def cl_args(out, extra=()):
    return ["--config_file",
            os.path.join(REPO, "configs", "models", "hero_model.yaml"),
            "--dataset", "synthetic", "--single_debug_scan_id", "scene",
            "--split", "test", "--output_base_path", str(out),
            "--image_height", str(H), "--image_width", str(W),
            "--num_images_in_tuple", "4", "--model_num_views", "4",
            "--matching_num_depth_bins", "8", "--precision", "32",
            "--num_workers", "2", *extra]


@pytest.fixture
def nine_frames(monkeypatch):
    for module in (jsynthetic, tsynthetic):
        monkeypatch.setattr(module, "DEFAULT_NUM_FRAMES", 9)


def capture(monkeypatch, module):
    """Replaces `module.write_video` with one that keeps the frames:
    {file name: frames}."""
    videos = {}

    def keep(path, frames, fps=30):
        videos[os.path.basename(path)] = [np.array(f) for f in frames]
        return path

    monkeypatch.setattr(module, "write_video", keep)
    return videos


def write_depth_cache(out):
    """Seeded depth pickles for every frame of the synthetic test split,
    as the eval CLI's `--cache_depths` writes them, and a GT min/max
    cache for the even frames."""
    dataset = SyntheticDataset(split="test", image_height=H, image_width=W,
                               num_images_in_tuple=4, pass_frame_id=True,
                               include_full_depth_K=True)
    results = os.path.join(str(out), "hero_model", "synthetic", "default")
    rng = np.random.RandomState(5)
    minmax = {}
    for idx in range(len(dataset)):
        cur, src = dataset[idx]
        fid = cur["frame_id_string"]
        outputs = {"depth_pred_s0_bhw1": rng.uniform(
            0.5, 4.0, (1, H // 2, W // 2, 1)).astype(np.float32),
                   "lowest_cost_bhw": rng.uniform(
            0.5, 4.0, (1, H // 2, W // 2)).astype(np.float32)}
        batch = {k: np.asarray(v)[None] for k, v in cur.items()
                 if k != "frame_id_string"}
        cache_model_outputs(os.path.join(results, "depths", "scene"),
                            outputs, batch, src, 1, [fid])
        if idx % 2 == 0:
            minmax[fid] = (0.7 + 0.01 * idx, 3.0 + 0.01 * idx)
    os.makedirs(os.path.join(results, "viz"), exist_ok=True)
    with open(os.path.join(results, "viz", "gt_min_max_cache.pickle"),
              "wb") as f:
        pickle.dump({"scene": minmax}, f)
    return len(dataset)


def test_depth_video_clis_match_jax(tmp_path, monkeypatch, nine_frames):
    frames = write_depth_cache(tmp_path)
    got_videos = capture(monkeypatch, tdepth)
    want_videos = capture(monkeypatch, jdepth)
    written = tdepth.main(OptionsHandler().parse_and_merge_options(
        cl_args_list=cl_args(tmp_path)))
    jdepth.main(JaxHandler().parse_and_merge_options(
        cl_args_list=cl_args(tmp_path)))
    assert written["scene"][0] == frames == 6
    assert sorted(got_videos) == sorted(want_videos) == ["scene.mp4"]
    got, want = got_videos["scene.mp4"], want_videos["scene.mp4"]
    assert len(got) == len(want) == frames
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_live_meshing_clis_match_jax(tmp_path, monkeypatch, nine_frames):
    extra = ("--viz_render_height", "96", "--viz_render_width", "128",
             "--fusion_resolution", "0.16")
    opts = OptionsHandler().parse_and_merge_options(
        cl_args_list=cl_args(tmp_path / "port", extra))
    model = spread_outputs_(build_depth_model(opts, device="cpu", seed=3),
                            seed=3)
    opts.load_weights_from_checkpoint = save_weights(
        str(tmp_path / "weights.pt"), model, opts)
    got_videos = capture(monkeypatch, tlive)
    stats = tlive.main(opts, device="cpu")
    assert stats["keyframes"] == stats["forwards"] == 6

    params, batch_stats, _ = convert_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()})
    monkeypatch.setattr(
        jlive, "_load_or_init_variables",
        lambda jmodel, jopts: {"params": params, "batch_stats": batch_stats})
    want_videos = capture(monkeypatch, jlive)
    jlive.main(JaxHandler().parse_and_merge_options(
        cl_args_list=cl_args(tmp_path / "jax", extra)))

    names = ["scene_birdseye.mp4", "scene_fpv.mp4"]
    assert sorted(got_videos) == sorted(want_videos) == names
    for name in names:
        got, want = got_videos[name], want_videos[name]
        assert len(got) == len(want) == stats["frames"]["scene"] > 0
        for g, w in zip(got, want):
            assert g.shape == w.shape == (96, 128, 3)
            assert g.min() >= 0 and g.max() <= 1
            assert np.mean(np.abs(g - w) <= 1 / 255 + 1e-6) >= 0.99


def test_live_meshing_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlive.main(OptionsHandler().parse_and_merge_options(
            cl_args_list=cl_args("/nonexistent")))
