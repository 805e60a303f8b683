"""The port's OnlineSession on the CPU, and the port's import boundary:
importing the port, a forward and a training step of the hero model and
of the dot-product model (with the fused stem pool) load none of jax,
flax, yaml, PIL or the JAX package.

OnlineSession must make the same keyframe decisions as the JAX package's
bare `KeyframeBuffer` fed the same poses, and each answer must equal a
direct DepthModel forward on the same (reference, padded sources) tuple.
The port's own copy of the keyframe buffer must choose as the JAX
package's does.
"""

import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from simplerecon_tpu.data.keyframe_buffer import DVMVS_Config, KeyframeBuffer
from simplerecon_tpu_torch.data import keyframe_buffer as port_kfb
from simplerecon_tpu_torch.models.depth_model import build_depth_model
from simplerecon_tpu_torch.online import OnlineSession
from test_torch_port_ops import few_torch_threads  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
H, W = 64, 96


def tiny_opts(**kw):
    opts = dict(feature_volume_type="mlp_feature_volume",
                matching_encoder_type="resnet", matching_scale=1,
                matching_num_depth_bins=8, min_matching_depth=0.25,
                max_matching_depth=5.0, matching_feature_dims=16,
                model_num_views=4, precision="32",
                cost_volume_backend="xla_fused", test_keyframe_buffer_size=30)
    opts.update(kw)
    return types.SimpleNamespace(**opts)


def posed_stream(n, seed=0):
    """Frames on a smooth trajectory; every other step is too short to be
    a keyframe."""
    rng = np.random.RandomState(seed)
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1] = 0.9 * W / 4, 1.1 * H / 4
    K[0, 2], K[1, 2] = W / 8, H / 8
    frames = []
    x = 0.0
    for i in range(n):
        x += 0.13 if i % 2 == 0 else 0.02
        world_T_cam = np.eye(4, dtype=np.float32)
        c, s = np.cos(0.05 * i), np.sin(0.05 * i)
        world_T_cam[[0, 0, 2, 2], [0, 2, 0, 2]] = (c, s, -s, c)
        world_T_cam[:3, 3] = (x, 0.01 * i, 0.0)
        frames.append({
            "image_b3hw": rng.randn(3, H, W).astype(np.float32),
            "world_T_cam_b44": world_T_cam,
            "cam_T_world_b44": np.linalg.inv(world_T_cam).astype(np.float32),
            "K_s1_b44": K, "invK_s1_b44": np.linalg.inv(K).astype(np.float32),
        })
    return frames


def test_online_session_matches_keyframe_buffer_and_direct_forward():
    opts = tiny_opts()
    model = build_depth_model(opts, device="cpu", seed=3)
    session = OnlineSession(opts, model)
    buffer = KeyframeBuffer(
        buffer_size=opts.test_keyframe_buffer_size,
        keyframe_pose_distance=DVMVS_Config.test_keyframe_pose_distance,
        optimal_t_score=DVMVS_Config.test_optimal_t_measure,
        optimal_R_score=DVMVS_Config.test_optimal_R_measure,
        store_return_indices=False)

    answered = 0
    for frame in posed_stream(8):
        result = session.process_frame(frame)
        code = buffer.try_new_keyframe(
            frame["world_T_cam_b44"].astype(np.float64), frame)
        if code != 1:
            assert result is None
            continue
        answered += 1
        sources = [s[1] for s in buffer.get_best_measurement_frames(3)]
        sources += [sources[-1]] * (3 - len(sources))

        def stack(key, frames):
            return torch.from_numpy(np.stack([f[key] for f in frames]))[None]

        cur = {k: stack(k, [frame])[:, 0] for k in (
            "image_b3hw", "invK_s1_b44", "world_T_cam_b44",
            "cam_T_world_b44")}
        src = {k: stack(k, sources) for k in (
            "image_b3hw", "K_s1_b44", "world_T_cam_b44", "cam_T_world_b44")}
        with torch.no_grad():
            want = model(cur, src, return_mask=True)
        assert sorted(result) == sorted(want)
        assert result["depth_pred_s0_bhw1"].shape == (1, H // 2, W // 2, 1)
        for key, value in want.items():
            np.testing.assert_array_equal(result[key], value.numpy(),
                                          err_msg=key)
    assert answered == 3


def test_port_keyframe_buffer_chooses_as_the_jax_one():
    """The port's own copy of the numpy buffer against the JAX package's,
    on one stream with short steps, missing poses and a tracking reset."""
    kw = dict(buffer_size=5,
              keyframe_pose_distance=DVMVS_Config.test_keyframe_pose_distance,
              optimal_t_score=DVMVS_Config.test_optimal_t_measure,
              optimal_R_score=DVMVS_Config.test_optimal_R_measure,
              store_return_indices=False)
    ours, theirs = port_kfb.KeyframeBuffer(**kw), KeyframeBuffer(**kw)
    codes = []
    for i, frame in enumerate(posed_stream(16, seed=5)):
        pose = frame["world_T_cam_b44"].astype(np.float64)
        if i in (9, 10):
            pose = np.full((4, 4), np.nan)
        gap = 40 if i == 12 else None
        got = ours.try_new_keyframe(pose, i, gap)
        assert got == theirs.try_new_keyframe(pose, i, gap), i
        codes.append(got)
        if got == 1:
            assert ([f[1] for f in ours.get_best_measurement_frames(3)]
                    == [f[1] for f in theirs.get_best_measurement_frames(3)])
    assert {0, 1, 2, 3, 5} <= set(codes), codes
    for key, value in vars(DVMVS_Config).items():
        if not key.startswith("__"):
            assert getattr(port_kfb.DVMVS_Config, key) == value, key


def test_build_depth_model_defaults_to_the_card():
    if torch.cuda.is_available():
        model = build_depth_model(tiny_opts())
        assert next(model.parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            build_depth_model(tiny_opts())


def test_port_imports_no_jax_flax_yaml_or_pil():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import numpy as np
        import torch
        import simplerecon_tpu_torch as pkg
        for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(mod.name)
        from simplerecon_tpu_torch.models.depth_model import \\
            build_depth_model
        from simplerecon_tpu_torch.parallel import train
        from simplerecon_tpu_torch.testing import (dot_options, hero_options,
                                                   train_batch)
        opts = hero_options(image_height=64, image_width=64,
                            matching_num_depth_bins=4, model_num_views=2,
                            precision="32")
        model = build_depth_model(opts, device="cpu")
        eye = torch.eye(4)[None]
        K = torch.eye(4)[None]
        cur = {"image_b3hw": torch.randn(1, 3, 64, 64), "invK_s1_b44": K,
               "cam_T_world_b44": eye, "world_T_cam_b44": eye}
        src = {"image_b3hw": torch.randn(1, 1, 3, 64, 64),
               "K_s1_b44": K[:, None], "cam_T_world_b44": eye[:, None],
               "world_T_cam_b44": eye[:, None]}
        with torch.no_grad():
            out = model(cur, src, return_mask=True)
        assert torch.isfinite(out["depth_pred_s0_bhw1"]).all()
        optimizer = train.make_optimizer(opts, model)
        metrics = train.train_step(
            model, optimizer,
            train.batch_to_device(train_batch(opts, 1, seed=0), "cpu"),
            torch.Generator().manual_seed(0))
        assert torch.isfinite(metrics["loss"]) and optimizer.count == 1
        dot = build_depth_model(dot_options(
            image_height=64, image_width=64, matching_num_depth_bins=4,
            model_num_views=2, precision="32"), device="cpu")
        with torch.no_grad():
            out = dot(cur, src, return_mask=True)
        assert torch.isfinite(out["depth_pred_s0_bhw1"]).all()
        optimizer = train.make_optimizer(opts, dot)
        metrics = train.train_step(
            dot, optimizer,
            train.batch_to_device(train_batch(opts, 1, seed=0), "cpu"),
            torch.Generator().manual_seed(0))
        assert torch.isfinite(metrics["loss"]) and optimizer.count == 1
        # the training program's checkpoints and panels
        import tempfile
        from simplerecon_tpu_torch.utils import checkpoint, visualization
        state = train.TrainState(dot, optimizer, torch.Generator(), step=1)
        with tempfile.TemporaryDirectory() as tmp:
            checkpoint.save_checkpoint(tmp, state)
            checkpoint.restore_checkpoint(tmp, state)
            visualization.save_image(tmp + "/panel.png",
                                     visualization.turbo_colormap(
                                         np.zeros((4, 4))))
        loaded = [m for m in sys.modules
                  if m in ("jax", "flax", "yaml", "PIL")
                  or m == "simplerecon_tpu"
                  or m.startswith("simplerecon_tpu.")]
        assert not loaded, loaded
        print("ok")
    """)
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("ok")


@pytest.mark.parametrize("backend", ["pallas_full", "pallas_v1"])
def test_inference_only_backends_build_and_answer(backend):
    """The hero model with the sweep of K4 ("pallas_full") or of the
    warp and K5 ("pallas_v1") answers keyframes on the CPU."""
    opts = tiny_opts(cost_volume_backend=backend)
    model = build_depth_model(opts, device="cpu", seed=3)
    assert model.cost_volume.backend == backend
    session = OnlineSession(opts, model)
    answers = [out for out in map(session.process_frame, posed_stream(3))
               if out is not None]
    assert len(answers) == 1
    depth = answers[0]["depth_pred_s0_bhw1"]
    assert depth.shape == (1, H // 2, W // 2, 1) and np.isfinite(depth).all()


def test_sweep_backends_select_the_one_path():
    for backend in ("pallas", "pallas_interpret", "xla", "xla_fused"):
        model = build_depth_model(tiny_opts(cost_volume_backend=backend,
                                            fast_cost_volume=True),
                                  device="cpu")
        assert type(model.cost_volume).__name__ == "MLPFeatureVolume"
        assert model.cost_volume.backend == "fused_sweep"


@pytest.mark.parametrize("backend", ["pallas", "pallas_interpret", "xla",
                                     "xla_fused", "pallas_v1", "pallas_full"])
def test_dot_model_and_fused_pool_build_for_every_sweep_backend(backend):
    """The dot-product model with the fused stem pool (K3) builds on the
    CPU from every sweep backend, each of which selects its one sweep
    (K1-dot): the cost volume has no parameters and hands the CV encoder
    one channel per plane."""
    opts = tiny_opts(feature_volume_type="simple_cost_volume",
                     matching_pool_impl="pallas", cost_volume_backend=backend,
                     fast_cost_volume=True)
    model = build_depth_model(opts, device="cpu")
    assert type(model.cost_volume).__name__ == "DotProductCostVolume"
    assert model.matching_model.net[3].impl == "pallas"
    assert not list(model.cost_volume.parameters())
    assert (model.cost_volume_net.convs["ds_conv_0"].conv1.in_channels
            == opts.matching_num_depth_bins)
