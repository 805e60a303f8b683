"""Seeded synthetic inputs and settings for checking the port: the fused
sweep's arguments, a posed frame stream, the hero model's options, and a
weight perturbation that gives random-init outputs some spread.

Used by `chip_smoke.py` and the tests; everything is drawn from numpy
with a seed, so two devices see the same values.
"""

from __future__ import annotations

import types

import numpy as np
import torch
import torch.nn as nn

from simplerecon_tpu_torch.ops import cost_volume as cv_ops
from simplerecon_tpu_torch.ops import geometry as geo
from simplerecon_tpu_torch.ops.cuda_cv import HIDDEN, mlp_in_channels

# configs/models/hero_model.yaml over the Options defaults, as far as the
# inference path reads them
HERO_OPTIONS = dict(
    feature_volume_type="mlp_feature_volume", matching_encoder_type="resnet",
    image_height=384, image_width=512, matching_scale=1,
    matching_num_depth_bins=64, min_matching_depth=0.25,
    max_matching_depth=5.0, matching_feature_dims=16,
    matching_pool_impl="reference", model_num_views=8, precision="16",
    cost_volume_backend="xla_fused", fast_cost_volume=False,
    test_keyframe_buffer_size=30)


def hero_options(**overrides) -> types.SimpleNamespace:
    """A plain namespace with the hero model's option values."""
    return types.SimpleNamespace(**{**HERO_OPTIONS, **overrides})


def _rot_y(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    m = np.eye(4)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    return m


def _rot_x(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    m = np.eye(4)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return m


def sweep_case(b: int, k: int, h: int, w: int, c: int, d: int,
               dtype: torch.dtype, device, seed: int = 0) -> list:
    """Arguments of `fused_sweep`, in order, on `device`.

    Source cameras are rotated by up to ~0.2 rad and moved by up to
    0.3 m, so taps fall off the image, and the last view is turned 100
    degrees, so some plane points lie behind it.
    """
    rng = np.random.RandomState(seed)
    extr = np.zeros((b, k, 4, 4))
    for bi in range(b):
        for vi in range(k):
            m = (_rot_x(rng.uniform(-0.2, 0.2))
                 @ _rot_y(rng.uniform(-0.2, 0.2)))
            if vi == k - 1:
                m = _rot_y(np.deg2rad(100.0)) @ m
            m[:3, 3] = rng.uniform(-0.3, 0.3, 3)
            extr[bi, vi] = m
    poses = np.linalg.inv(extr)
    K = np.eye(4)
    K[0, 0], K[1, 1] = 0.9 * w, 1.2 * h
    K[0, 2], K[1, 2] = w / 2 - 0.3, h / 2 + 0.2
    f32 = np.float32
    cin = mlp_in_channels(k, c)

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a, f32)).to(
            device=device, dtype=dt)

    poses_t = t(poses)
    penalty, r_meas, t_meas = geo.pose_distance(poses_t)
    return [
        t(rng.randn(b, k, h, w, c), dtype),
        t(rng.randn(b, h * w, c), dtype),
        t(extr), t(np.broadcast_to(K, (b, k, 4, 4))),
        t(np.broadcast_to(np.linalg.inv(K), (b, 4, 4))),
        cv_ops.generate_depth_planes(b, d, 0.25, 5.0, device).contiguous(),
        torch.stack([penalty, r_meas, t_meas], dim=-1),
        poses_t[..., :3, 3].contiguous(),
        t(rng.randn(cin, HIDDEN) / np.sqrt(cin), dtype),
        t(0.1 * rng.randn(HIDDEN)),
        t(rng.randn(HIDDEN, HIDDEN) / np.sqrt(HIDDEN), dtype),
        t(0.1 * rng.randn(HIDDEN)),
        t(rng.randn(HIDDEN, 1) / np.sqrt(HIDDEN), dtype),
        t(0.1 * rng.randn(1)),
    ]


def posed_stream(n: int, height: int, width: int, seed: int = 0,
                 step: float = 0.12) -> list:
    """`n` frames on a smooth trajectory (`step` metres a frame along x,
    a slow turn about y), as the dicts `OnlineSession.process_frame`
    takes; intrinsics are at matching scale 1 (a quarter of the image)."""
    rng = np.random.RandomState(seed)
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1] = 0.9 * width / 4, 1.2 * height / 4
    K[0, 2], K[1, 2] = width / 8, height / 8
    frames = []
    for i in range(n):
        world_T_cam = _rot_y(0.03 * i).astype(np.float32)
        world_T_cam[:3, 3] = (step * i, 0.01 * i, 0.02 * np.sin(i))
        frames.append({
            "image_b3hw": rng.randn(3, height, width).astype(np.float32),
            "world_T_cam_b44": world_T_cam,
            "cam_T_world_b44": np.linalg.inv(world_T_cam).astype(np.float32),
            "K_s1_b44": K,
            "invK_s1_b44": np.linalg.inv(K).astype(np.float32),
        })
    return frames


@torch.no_grad()
def spread_outputs_(model: nn.Module, seed: int = 0,
                    head_scale: float = 2.0) -> nn.Module:
    """Redraws every BatchNorm's affine and running statistics and scales
    the decoder's output heads, so a random-init model's log-depth maps
    are not near constant. In place; returns `model`."""
    rng = np.random.RandomState(seed)
    for mod in model.modules():
        if isinstance(mod, nn.BatchNorm2d):
            n = mod.num_features
            for buf, vals in ((mod.running_mean, rng.normal(0, 0.1, n)),
                              (mod.running_var, rng.uniform(0.5, 1.5, n)),
                              (mod.weight, rng.uniform(0.5, 1.5, n)),
                              (mod.bias, rng.normal(0, 0.1, n))):
                buf.copy_(torch.from_numpy(vals.astype(np.float32)))
    for i in range(4):
        head = model.depth_decoder.convs[f"output_{i}"][1]
        head.weight.mul_(head_scale)
        head.bias.mul_(head_scale)
    return model
