"""The port's OnlineSession on the CPU, and the port's import boundary.

OnlineSession must make the same keyframe decisions as a bare
`KeyframeBuffer` fed the same poses, and each answer must equal a direct
DepthModel forward on the same (reference, padded sources) tuple.
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
    model = build_depth_model(opts, seed=3)
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


def test_port_imports_no_jax_flax_yaml_or_pil():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys, types
        import torch
        import simplerecon_tpu_torch as pkg
        for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(mod.name)
        from simplerecon_tpu_torch.models.depth_model import \\
            build_depth_model
        opts = types.SimpleNamespace(
            feature_volume_type="mlp_feature_volume",
            matching_encoder_type="resnet", matching_scale=1,
            matching_num_depth_bins=4, min_matching_depth=0.25,
            max_matching_depth=5.0, matching_feature_dims=16,
            model_num_views=2, precision="32")
        model = build_depth_model(opts)
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
        loaded = [m for m in ("jax", "flax", "yaml", "PIL")
                  if m in sys.modules]
        assert not loaded, loaded
        print("ok")
    """)
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("ok")


@pytest.mark.parametrize("override", [
    {"matching_pool_impl": "pallas"},
    {"matching_norm": "group"},
    {"cost_volume_backend": "pallas_full"},
    {"cost_volume_backend": "pallas_v1"},
    {"feature_volume_type": "simple_cost_volume"},
    {"matching_encoder_type": "unet_encoder"},
], ids=lambda o: "-".join(map(str, o.values())))
def test_unported_options_raise(override):
    with pytest.raises(NotImplementedError):
        build_depth_model(tiny_opts(**override))


def test_sweep_backends_select_the_one_path():
    for backend in ("pallas", "pallas_interpret", "xla", "xla_fused"):
        model = build_depth_model(tiny_opts(cost_volume_backend=backend,
                                            fast_cost_volume=True))
        assert type(model.cost_volume).__name__ == "MLPFeatureVolume"
