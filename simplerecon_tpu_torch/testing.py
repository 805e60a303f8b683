"""Seeded synthetic inputs and settings for checking the port: the
arguments of the fused and dot-product sweeps, of K5 and K4 and of the
stem pool, a
posed frame stream, a training batch, the hero and dot-product models'
options, a weight perturbation that gives random-init outputs some
spread, and a record of the convolutions' layouts.

Used by `chip_smoke.py` and the tests; everything is drawn from numpy
with a seed, so two devices see the same values.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn as nn
from torch.utils._python_dispatch import TorchDispatchMode

from simplerecon_tpu_torch.ops import cost_volume as cv_ops
from simplerecon_tpu_torch.ops import early_sweeps
from simplerecon_tpu_torch.ops import geometry as geo
from simplerecon_tpu_torch.ops.cuda_cv import HIDDEN, mlp_in_channels
from simplerecon_tpu_torch.parallel.train import make_example_batch

# the model configs, at the root of the checkout
CONFIGS = Path(__file__).resolve().parents[1] / "configs" / "models"


def model_options(config: str, **overrides):
    """`Options` from the model config `configs/models/<config>`, with
    `overrides` set after it."""
    # imported here: `scripts/in_turns.py` loads this module into older
    # checkouts, which have no options module
    from simplerecon_tpu_torch.options import Options, load_options_yaml
    opts = Options()
    opts.update_from(load_options_yaml(str(CONFIGS / config)))
    opts.update_from(overrides)
    return opts


def hero_options(**overrides):
    """The hero model's options: `configs/models/hero_model.yaml`."""
    return model_options("hero_model.yaml", **overrides)


def dot_options(**overrides):
    """The dot-product model's options:
    `configs/models/dot_product_model.yaml`, with the fused stem pool (K3,
    `matching_pool_impl="pallas"`)."""
    return model_options("dot_product_model.yaml",
                         **{"matching_pool_impl": "pallas", **overrides})


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


# the geometries of the sweep cases: "wide" turns and moves the source
# cameras far; "close" draws them as `train_batch` does
GEOMETRIES = ("wide", "close")


def sweep_case(b: int, k: int, h: int, w: int, c: int, d: int,
               dtype: torch.dtype, device, seed: int = 0,
               geometry: str = "wide") -> list:
    """Arguments of `fused_sweep`, in order, on `device`.

    "wide": source cameras are rotated by up to ~0.2 rad and moved by up
    to 0.3 m, so taps fall off the image, and the last view is turned 100
    degrees, so some plane points lie behind it. "close": as
    `train_batch` draws them, a few degrees and at most 15 cm from the
    reference camera on each axis, with `make_example_batch`'s
    intrinsics (focal length half the image width), so neighbouring
    pixels and consecutive planes sample the same taps.
    """
    if geometry not in GEOMETRIES:
        raise ValueError(f"geometry is one of {GEOMETRIES}, not {geometry}")
    rng = np.random.RandomState(seed)
    extr = np.zeros((b, k, 4, 4))
    for bi in range(b):
        for vi in range(k):
            if geometry == "close":
                rel = (_rot_x(rng.uniform(-0.05, 0.05))
                       @ _rot_y(rng.uniform(-0.08, 0.08)))
                rel[:3, 3] = rng.uniform(-0.15, 0.15, 3)
                extr[bi, vi] = np.linalg.inv(rel)
                continue
            m = (_rot_x(rng.uniform(-0.2, 0.2))
                 @ _rot_y(rng.uniform(-0.2, 0.2)))
            if vi == k - 1:
                m = _rot_y(np.deg2rad(100.0)) @ m
            m[:3, 3] = rng.uniform(-0.3, 0.3, 3)
            extr[bi, vi] = m
    poses = np.linalg.inv(extr)
    K = np.eye(4)
    if geometry == "close":
        K[0, 0] = K[0, 2] = w / 2.0
        K[1, 1] = K[1, 2] = h / 2.0
    else:
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


def dot_case(b: int, k: int, h: int, w: int, c: int, d: int,
             dtype: torch.dtype, device, seed: int = 0,
             geometry: str = "wide") -> list:
    """Arguments of `dot_sweep`, in order: `sweep_case`'s features and
    geometry."""
    return sweep_case(b, k, h, w, c, d, dtype, device, seed, geometry)[:6]


def stack_case(b: int, k: int, h: int, w: int, c: int, d: int,
               dtype: torch.dtype, device, seed: int = 0) -> list:
    """Arguments of `fused_feature_volume` (K5), in order: `sweep_case`'s
    features, geometry and MLP, with the stack, mask and depths warped by
    `early_sweeps.stack_inputs` (sampled in float32, the stack in
    `dtype`) and the reference pixels' rays."""
    src, cur, extr, Ks, invK, planes, *rest = sweep_case(
        b, k, h, w, c, d, dtype, device, seed)
    stack = early_sweeps.stack_inputs(src, extr, Ks, invK, planes, dtype)
    rays = cv_ops.pixel_rays(invK, h, w).contiguous()
    return [*stack, cur, rays, planes, *rest]


def warp_case(b: int, k: int, h: int, w: int, c: int, d: int,
              dtype: torch.dtype, device, seed: int = 0) -> list:
    """Arguments of `fused_warp_feature_volume` (K4), in order, from
    `sweep_case`'s: the c-major maps and projections of
    `early_sweeps.warp_inputs`, and the reference pixels' rays."""
    src, cur, extr, Ks, invK, planes, *rest = sweep_case(
        b, k, h, w, c, d, dtype, device, seed)
    img, proj = early_sweeps.warp_inputs(src, extr, Ks, dtype)
    rays = cv_ops.pixel_rays(invK, h, w).contiguous()
    return [img, cur, rays, planes, proj, *rest]


# the stem pool's test shapes, (b, c, h, w), and how many elements each
# map is shifted from a 16-byte boundary: an odd shape (bf16 rows of 44
# bytes), an odd H with 16-byte rows, a width that no column tile of the
# kernels divides, a misaligned map (staged element by element) and the
# matching encoder's stem at b=1 (8 views of 64 x 192 x 256)
POOL_CASES = {
    "odd": ((2, 3, 13, 22), 0),
    "odd_h": ((3, 5, 37, 72), 0),
    "column_tiles": ((2, 4, 41, 336), 0),
    "unaligned_base": ((2, 8, 64, 256), 1),
    "encoder_b1": ((8, 64, 192, 256), 0),
}


def shifted(t: torch.Tensor, offset: int) -> torch.Tensor:
    """t's values in a contiguous tensor whose data starts `offset`
    elements into a buffer (off a 16-byte boundary for offset 1)."""
    if offset == 0:
        return t
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    return buf[offset:].view(t.shape).copy_(t)


def pool_case(shape, dtype: torch.dtype, device, seed: int = 0
              ) -> torch.Tensor:
    """A ReLU'd NCHW input of the stem pool, on quarter steps, so exact
    zeros and ties inside 2x2 windows occur."""
    x = np.random.RandomState(seed).randn(*shape)
    x = np.maximum(np.round(4.0 * x) / 4.0, 0.0).astype(np.float32)
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def pool_cotangent(shape, dtype: torch.dtype, device, seed: int = 0,
                   positive: bool = False) -> torch.Tensor:
    """A cotangent of the stem pool's output (shape (b, c, Ho, Wo)).
    `positive` draws it from [0.5, 1.5]: then every blur-transposed
    window gradient is positive, and dx is nonzero exactly where an
    element is the first maximum of some window."""
    rng = np.random.RandomState(seed)
    g = rng.uniform(0.5, 1.5, shape) if positive else rng.randn(*shape)
    return torch.from_numpy(g.astype(np.float32)).to(device=device,
                                                     dtype=dtype)


def sweep_cotangent(b: int, d: int, n: int, device, seed: int = 0
                    ) -> torch.Tensor:
    """A float32 (b, d, N) cotangent of the sweep's scores, for the
    backward."""
    g = np.random.RandomState(seed).randn(b, d, n).astype(np.float32)
    return torch.from_numpy(g).to(device)


def scatter_case(b: int, k: int, h: int, w: int, c: int, d: int,
                 dtype: torch.dtype, device, seed: int = 0,
                 dot: bool = False, geometry: str = "wide") -> tuple:
    """`sweep_scatter`'s arguments at a sweep shape: (proj, invK, planes,
    max_abs, h, w) and its gradients as keywords, either seeded sample
    gradients d_s (b, k, d, N, c) in `dtype`, or (dot) a cotangent g
    (b, d, N) and the reference features cur (b, N, c) in `dtype`;
    max_abs bounds |d_s| (for the dot model, max |g| * max |cur|). The
    cameras are `sweep_case`'s of `geometry`."""
    _, cur, extr, Ks, invK, planes = dot_case(b, k, h, w, c, d, dtype,
                                              device, seed, geometry)
    proj = torch.matmul(Ks, extr).contiguous()
    if dot:
        g = sweep_cotangent(b, d, h * w, device, seed=seed + 1)
        bound = (g.abs().amax() * cur.float().abs().amax()).reshape(1)
        return (proj, invK, planes, bound, h, w), dict(g_bdN=g, cur_bNc=cur)
    d_s = np.random.RandomState(seed + 1).randn(b, k, d, h * w, c)
    d_s = torch.from_numpy(d_s.astype(np.float32)).to(device=device,
                                                      dtype=dtype)
    bound = d_s.float().abs().amax().reshape(1)
    return (proj, invK, planes, bound, h, w), dict(d_s_bkdNc=d_s)


SWEEP_GRAD_NAMES = ("d_src", "d_cur", "d_w0", "d_b0", "d_w1", "d_b1",
                    "d_w2", "d_b2")


def relative_errors(got, want) -> dict:
    """{name: (max |got - want| / max |want|, ||got - want|| / ||want||,
    max |got - want|)} over the sweep's gradients, in float32."""
    errs = {}
    for name, a, ref in zip(SWEEP_GRAD_NAMES, got, want):
        ref = ref.float()
        diff = a.float() - ref
        errs[name] = (diff.abs().max().item()
                      / max(ref.abs().max().item(), 1e-30),
                      diff.norm().item() / max(ref.norm().item(), 1e-30),
                      diff.abs().max().item())
    return errs


class ConvolutionLayouts(TorchDispatchMode):
    """While on, records each convolution dispatched, forward
    (`aten::convolution`: its input) and backward
    (`aten::convolution_backward`: its gradient and input), in `seen` as
    (op, depthwise, channels_last, nchw): whether it has a filter a
    channel, and whether those maps are laid out channels_last and NCHW
    (a map of one pixel is both). The autograd engine's threads see the
    mode too."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name
        if name in ("aten::convolution", "aten::convolution_backward"):
            backward = name == "aten::convolution_backward"
            maps = args[:2] if backward else args[:1]
            groups = args[9 if backward else 8]
            self.seen.append((
                name, groups > 1 and groups == maps[-1].shape[1],
                all(t.is_contiguous(memory_format=torch.channels_last)
                    for t in maps),
                all(t.is_contiguous() for t in maps)))
        return func(*args, **(kwargs or {}))


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


def train_batch(opts, batch_size: int, seed: int = 0) -> dict:
    """A numpy training batch with `make_example_batch`'s schema and
    shapes: random images; cameras a few centimetres and degrees apart,
    with intrinsics at s0 and at the matching scale; smooth GT depth in
    about [0.6, 3.4] m with NaN holes (mask off) in the reference view
    and in every source view."""
    rng = np.random.RandomState(seed)
    batch = make_example_batch(opts, batch_size)
    cur, src = batch["cur"], batch["src"]
    b, k = src["image_b3hw"].shape[:2]
    dh, dw = cur["depth_bhw"].shape[1:]
    f32 = np.float32
    cur["image_b3hw"] = rng.randn(*cur["image_b3hw"].shape).astype(f32)
    src["image_b3hw"] = rng.randn(*src["image_b3hw"].shape).astype(f32)

    def depth_maps(shape):
        yy, xx = np.meshgrid(np.linspace(0, 1, dh), np.linspace(0, 1, dw),
                             indexing="ij")
        maps = np.empty(shape + (dh, dw), f32)
        for idx in np.ndindex(*shape):
            tilt_x, tilt_y = rng.uniform(-1, 1, 2)
            amp, freq = rng.uniform(0.1, 0.4), rng.uniform(2, 6)
            maps[idx] = (2.0 + tilt_x * (xx - 0.5) + tilt_y * (yy - 0.5)
                         + amp * np.sin(freq * xx) * np.cos(freq * yy))
            y0, x0 = rng.randint(0, dh // 2), rng.randint(0, dw // 2)
            maps[idx][y0:y0 + dh // 4, x0:x0 + dw // 5] = np.nan
        return maps

    depth = depth_maps((b,))
    cur["depth_bhw"] = depth
    cur["mask_b_bhw"] = np.isfinite(depth)
    src["depth_bkhw"] = depth_maps((b, k))

    for bi in range(b):
        world_T_cur = _rot_y(rng.uniform(-0.3, 0.3))
        world_T_cur[:3, 3] = rng.uniform(-1, 1, 3)
        cur["world_T_cam_b44"][bi] = world_T_cur
        cur["cam_T_world_b44"][bi] = np.linalg.inv(world_T_cur)
        for vi in range(k):
            rel = (_rot_x(rng.uniform(-0.05, 0.05))
                   @ _rot_y(rng.uniform(-0.08, 0.08)))
            rel[:3, 3] = rng.uniform(-0.15, 0.15, 3)
            world_T_src = world_T_cur @ rel
            src["world_T_cam_b44"][bi, vi] = world_T_src
            src["cam_T_world_b44"][bi, vi] = np.linalg.inv(world_T_src)
    return batch


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


def synthetic_gt_frames(num_frames: int = 48, image_height: int = 384,
                        image_width: int = 512) -> list:
    """The synthetic scene's GT depth of every frame, at the model's output
    size (half the image: `depth_b1hw`, sampled from the render, 0 where
    nothing was hit), with its intrinsics `K` at that size, the poses,
    `invK` and the image: a list of numpy dicts, one a frame."""
    from simplerecon_tpu_torch.data.synthetic import SyntheticDataset
    dataset = SyntheticDataset(num_frames=num_frames,
                               image_height=image_height,
                               image_width=image_width, split="test")
    frames = []
    for i in range(num_frames):
        f = dataset.get_frame("scene", str(i), load_depth=True)
        frames.append(dict(depth_b1hw=np.nan_to_num(f["depth_b1hw"]),
                           K=f["K_s0_b44"], invK=f["invK_s0_b44"],
                           cam_T_world=f["cam_T_world_b44"],
                           world_T_cam=f["world_T_cam_b44"],
                           image_b3hw=f["image_b3hw"]))
    return frames


def synthetic_gt_bounds(num_frames: int = 48, image_height: int = 384,
                        image_width: int = 512) -> np.ndarray:
    """TSDF bounds from the frustums of all the scene's cameras at 3 m."""
    from simplerecon_tpu_torch.data.synthetic import camera_trajectory
    from simplerecon_tpu_torch.fusion.fusers import bounds_from_trajectory
    frame = synthetic_gt_frames(1, image_height, image_width)[0]
    poses = np.stack([p.astype(np.float32)
                      for p in camera_trajectory(num_frames)])
    return bounds_from_trajectory(poses, 3.0, invK_44=frame["invK"],
                                  image_hw=(image_height // 2,
                                            image_width // 2))


# The JAX package's fusion of `synthetic_gt_frames()` into a 4 cm TSDF
# within `synthetic_gt_bounds()` (3 m), on the CPU
# (tests/test_torch_port_fusion.py::test_full_width_gt_fusion_reference),
# and its mesh against `make_room_mesh()` by `evaluate_mesh(...,
# num_points=100_000)`
GT_FUSION = dict(dims=(136, 96, 176), vertices=9669, faces=18885,
                 precision=1.0, recall=0.38059, f1=0.551343990612709)


# Two runs of the eval CLI on the same weights and frames (the port
# against the JAX CLI on the CPU, or the port on the card against the
# CPU), float32: the cached s0 depths to rtol/atol (the same float32
# products summed in other orders through ~100 layers); the continuous
# metrics to `metric_rtol`; the inlier percentages within `a_pixels`
# pixels' worth of a frame's valid pixels (a depth within rounding of a
# threshold lands on either side); the meshes' vertex and face counts
# within `mesh_count_rtol` of the reference's (a voxel whose value
# changes sign remakes the triangles of its 8 cubes), and F1 >= `mesh_f1`
# between the two at one voxel (4 cm), from `mesh_samples_per_face`
# points a face of the reference (at 20,000 points in all a 65k-face
# mesh scored 0.945 against itself: the check measured the sampling).
# The card against the CPU only: the lowest-cost depth, an argmax over
# the planes, may sit on another plane in `card_plane_flips` of its
# pixels (where two planes, neighbours or not, score within float32
# rounding of each other, the scores summed in another order order them
# either way; on an NVIDIA H100 against the CPU, 1 pixel of a
# 3,072-pixel frame sat one plane away, in another run one 14 planes
# away, while the s0 depths agreed to rtol 1e-4).
EVAL_TOL = dict(depth_rtol=1e-4, depth_atol=1e-5, metric_rtol=1e-4,
                a_pixels=2, mesh_count_rtol=0.01, mesh_f1=0.99,
                mesh_samples_per_face=10, card_plane_flips=1e-3)
CONTINUOUS_METRICS = ("abs_diff", "abs_rel", "sq_rel", "rmse", "rmse_log")
RATIO_METRICS = ("a5", "a10", "a25", "a0", "a1", "a2", "a3")


def plane_ratio(opts) -> float:
    """The depth ratio of two neighbouring planes of the log-spaced
    sweep."""
    return (opts.max_matching_depth / opts.min_matching_depth) ** (
        1.0 / (opts.matching_num_depth_bins - 1))


def compare_cached_depths(got_dir: str, want_dir: str,
                          flip_ratio: float = 0.0) -> dict:
    """Asserts the `--cache_depths` pickles of two runs agree within
    `EVAL_TOL` (intrinsics, poses and frame ids exactly). With
    `flip_ratio`, the neighbouring planes' depth ratio (`plane_ratio`),
    up to `card_plane_flips` of the lowest-cost pixels may instead lie
    on another plane. Returns the number of frames, the largest relative
    depth difference and the number of such pixels."""
    import glob
    import os
    import pickle
    paths = sorted(glob.glob(os.path.join(want_dir, "*.pickle")))
    worst, flips, cost_pixels = 0.0, 0, 0
    for path in paths:
        with open(path, "rb") as f:
            want = pickle.load(f)
        with open(os.path.join(got_dir, os.path.basename(path)), "rb") as f:
            got = pickle.load(f)
        assert sorted(got) == sorted(want)
        assert got["frame_id"] == want["frame_id"]
        for key in ("K_full_depth_b44", "K_s0_b44", "world_T_cam_b44",
                    "cam_T_world_b44"):
            np.testing.assert_array_equal(got[key], want[key], key)
        gd, wd = got["depth_pred_s0_b1hw"], want["depth_pred_s0_b1hw"]
        assert gd.shape == wd.shape
        np.testing.assert_allclose(gd, wd, rtol=EVAL_TOL["depth_rtol"],
                                   atol=EVAL_TOL["depth_atol"])
        g, w = got["lowest_cost_bhw"], want["lowest_cost_bhw"]
        assert g.shape == w.shape
        off = ~np.isclose(g, w, rtol=EVAL_TOL["depth_rtol"],
                          atol=EVAL_TOL["depth_atol"])
        if flip_ratio:      # a whole number of planes up or down
            planes = np.log(np.maximum(g[off], w[off])
                            / np.minimum(g[off], w[off])) / np.log(flip_ratio)
            np.testing.assert_allclose(planes, np.round(planes), atol=1e-3)
        flips += int(off.sum())
        cost_pixels += off.size
        worst = max(worst, float(np.max(np.abs(gd - wd) / np.abs(wd))),
                    float(np.max(np.abs(g - w)[~off] / np.abs(w)[~off],
                                 initial=0.0)))
    assert flips <= (EVAL_TOL["card_plane_flips"] * cost_pixels
                     if flip_ratio else 0), (flips, cost_pixels)
    return dict(frames=len(paths), depth_rel=worst, plane_flips=flips)


def compare_metrics(got: dict, want: dict, valid_pixels: float) -> dict:
    """Asserts two metric dicts agree within `EVAL_TOL` (`model_time`
    aside); returns the largest relative difference of the continuous
    metrics and the largest difference of the percentages, in pixels."""
    keys = sorted(k for k in want if k != "model_time")
    assert sorted(k for k in got if k != "model_time") == keys
    rel = max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
              for k in CONTINUOUS_METRICS)
    pixels = max(abs(got[k] - want[k]) * valid_pixels / 100.0
                 for k in RATIO_METRICS)
    assert rel <= EVAL_TOL["metric_rtol"], (rel, got, want)
    assert pixels <= EVAL_TOL["a_pixels"], (pixels, got, want)
    return dict(metric_rel=rel, a_pixels=pixels)


def compare_meshes(got_ply: str, want_ply: str) -> dict:
    """Asserts two PLY meshes agree within `EVAL_TOL`; returns their
    counts and the F1 between them at one voxel."""
    from simplerecon_tpu_torch.fusion.mesh import read_ply
    from simplerecon_tpu_torch.utils.mesh_metrics import evaluate_mesh
    got_v, got_f = read_ply(got_ply)
    want_v, want_f = read_ply(want_ply)
    assert len(want_f) > 0, want_ply
    scores = evaluate_mesh(
        got_v, got_f, want_v, want_f, threshold=0.04,
        num_points=EVAL_TOL["mesh_samples_per_face"] * len(want_f))
    measured = dict(vertices=(len(got_v), len(want_v)),
                    faces=(len(got_f), len(want_f)), f1=scores["f1"])
    for got, want in (measured["vertices"], measured["faces"]):
        assert abs(got - want) <= EVAL_TOL["mesh_count_rtol"] * want, (
            measured)
    assert scores["f1"] >= EVAL_TOL["mesh_f1"], measured
    return measured


# The synthetic scene written to disk in ScanNet's layout
SCAN_ID = "scene0000_00"
# the tuple files' suffix that `Options` defaults to
TUPLE_SUFFIX = "_eight_view_deepvmvs.txt"


def synthetic_tuples(num_frames: int = 48, num_views: int = 8) -> list:
    """The synthetic dataset's tuples as frame indices: each frame from
    `num_views - 1` on, then the frames just before it."""
    return [[i] + list(range(i - num_views + 1, i))
            for i in range(num_views - 1, num_frames)]


def write_tuples(root: str, tuples: list, splits=("test",),
                 scan: str = SCAN_ID, suffix: str = TUPLE_SUFFIX) -> str:
    """Writes `tuples` (lists of frame indices) as ScanNet tuple lines,
    `<scan> 000007 000000 ...`, to `<root>/tuples/<split><suffix>` for
    each split. Returns the tuple directory."""
    import os
    tuple_dir = os.path.join(root, "tuples")
    os.makedirs(tuple_dir, exist_ok=True)
    lines = [" ".join([scan] + [f"{i:06d}" for i in t]) for t in tuples]
    for split in splits:
        with open(os.path.join(tuple_dir, f"{split}{suffix}"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return tuple_dir


def write_scannet_scan(root: str, num_frames: int = 48,
                       image_height: int = 384, image_width: int = 512,
                       scan: str = SCAN_ID) -> str:
    """Writes the synthetic scene (`data/synthetic.py`: the room, its
    trajectory and intrinsics) as a ScanNet scan under `<root>/scans/<scan>`
    (`<root>/scans_test` links to `scans`, so both splits read it):
    `sensor_data/frame-XXXXXX.color.<W>.png` (the 8-bit pixels the
    synthetic dataset feeds, at image_height x image_width),
    `frame-XXXXXX.depth.png` (millimetres, 0 where nothing was hit, at 5/4
    of the image size: 480x640 for 384x512), `frame-XXXXXX.pose.txt`,
    `intrinsic/intrinsic_{color,depth}.txt` and `<scan>.txt`. Returns the
    scan's directory."""
    import os
    from simplerecon_tpu_torch.data.synthetic import (camera_trajectory,
                                                      make_room_mesh)
    from simplerecon_tpu_torch.render.renderer import Renderer
    from simplerecon_tpu_torch.utils.visualization import encode_png
    scan_dir = os.path.join(root, "scans", scan)
    sensor = os.path.join(scan_dir, "sensor_data")
    intrinsic = os.path.join(scan_dir, "intrinsic")
    os.makedirs(sensor, exist_ok=True)
    os.makedirs(intrinsic, exist_ok=True)
    if not os.path.exists(os.path.join(root, "scans_test")):
        os.symlink("scans", os.path.join(root, "scans_test"))
    depth_h, depth_w = image_height * 5 // 4, image_width * 5 // 4
    # the synthetic dataset's intrinsics, and the same camera at the depth
    # image's size
    K = np.eye(4)
    K[0, 0] = K[1, 1] = 0.9 * image_width
    K[0, 2], K[1, 2] = image_width / 2, image_height / 2
    K_depth = K.copy()
    K_depth[:2] *= 1.25
    np.savetxt(os.path.join(intrinsic, "intrinsic_color.txt"), K)
    np.savetxt(os.path.join(intrinsic, "intrinsic_depth.txt"), K_depth)
    with open(os.path.join(scan_dir, f"{scan}.txt"), "w") as f:
        f.write(f"colorWidth = {image_width}\ncolorHeight = {image_height}\n"
                f"depthWidth = {depth_w}\ndepthHeight = {depth_h}\n"
                f"numColorFrames = {num_frames}\n"
                f"numDepthFrames = {num_frames}\n")
    v, faces, colors = make_room_mesh(seed=0)
    color_renderer = Renderer(image_height, image_width)
    depth_renderer = Renderer(depth_h, depth_w)
    for i, world_T_cam in enumerate(camera_trajectory(num_frames)):
        frame = os.path.join(sensor, f"frame-{i:06d}")
        rgb, _ = color_renderer.render_mesh(v, faces, world_T_cam, K,
                                            vert_colors=colors,
                                            background=(0.0, 0.0, 0.0))
        _, depth = depth_renderer.render_mesh(v, faces, world_T_cam, K_depth,
                                              vert_colors=colors,
                                              background=(0.0, 0.0, 0.0))
        depth_mm = np.clip(np.round(depth * 1000.0), 0, 65535)
        with open(f"{frame}.color.{image_width}.png", "wb") as f:
            f.write(encode_png(rgb))
        with open(f"{frame}.depth.png", "wb") as f:
            f.write(encode_png(depth_mm.astype(np.uint16)))
        np.savetxt(f"{frame}.pose.txt", world_T_cam)
    return scan_dir


def compare_scan_depths(scan_dir: str, synthetic_dir: str) -> dict:
    """Asserts the `--cache_depths` pickles of the eval CLI over the
    written ScanNet scan (frame ids `000007`) agree with those over the
    synthetic dataset (frame ids `7`) within `EVAL_TOL`, with the same
    intrinsics at s0 and poses. Returns the number of frames, the
    largest relative depth difference and whether every depth and
    lowest-cost map is the same bits."""
    import glob
    import os
    import pickle
    paths = sorted(glob.glob(os.path.join(synthetic_dir, "*.pickle")))
    worst, same = 0.0, True
    for path in paths:
        with open(path, "rb") as f:
            want = pickle.load(f)
        frame_id = f"{int(want['frame_id']):06d}"
        with open(os.path.join(scan_dir, f"{frame_id}.pickle"), "rb") as f:
            got = pickle.load(f)
        assert got["frame_id"] == frame_id
        for key in ("K_s0_b44", "world_T_cam_b44", "cam_T_world_b44"):
            np.testing.assert_array_equal(got[key], want[key], key)
        for key in ("depth_pred_s0_b1hw", "lowest_cost_bhw"):
            g, w = got[key], want[key]
            assert g.shape == w.shape, key
            np.testing.assert_allclose(g, w, rtol=EVAL_TOL["depth_rtol"],
                                       atol=EVAL_TOL["depth_atol"])
            worst = max(worst, float(np.max(np.abs(g - w) / np.abs(w))))
            same = same and g.tobytes() == w.tobytes()
    assert paths, synthetic_dir
    return dict(frames=len(paths), depth_rel=worst, same_bits=same)


def ddp_steps(rank: int, world: int, init_file: str, out_dir: str, opts,
              seed: int, batch: dict, flips, device_type: str = "cpu",
              backend=None, parity: bool = False,
              spread: bool = False) -> None:
    """Rank `rank` of a data-parallel run of `len(flips)` training steps
    (`parallel/train.py::ddp_train_step`) on its rows of the global numpy
    `batch`, from the model seeded with `seed` (and, with `spread`, put
    through `spread_outputs_` with that seed); a flip of None draws the
    coin from a generator seeded with 0. Writes to
    `<out_dir>/rank<rank>.pt`: each step's metrics, the ms of each step
    (host clock after a synchronize), the final state dict on the CPU,
    the kernels' launches in the steps and the card's peak memory
    (bytes). For `torch.multiprocessing.spawn`."""
    import time
    from simplerecon_tpu_torch.models.depth_model import build_depth_model
    from simplerecon_tpu_torch import tracing
    from simplerecon_tpu_torch.ops import launch_counts
    from simplerecon_tpu_torch.parallel import mesh
    from simplerecon_tpu_torch.parallel import train
    if device_type == "cpu":
        torch.set_num_threads(1)
    device = mesh.rank_device(rank, world, device_type, backend)
    mesh.init_process_group(rank, world, init_file, device, backend)
    try:
        model = build_depth_model(opts, device=device, seed=seed)
        if spread:
            spread_outputs_(model, seed=seed)
        optimizer = train.make_optimizer(opts, model)
        ddp = train.wrap_ddp(model)
        shard = train.batch_to_device(mesh.shard_batch(batch, rank, world),
                                      device)
        generator = torch.Generator().manual_seed(0)
        sync = torch.cuda.synchronize if device.type == "cuda" else (
            lambda: None)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        tracing.reset_counters()
        metrics, step_ms = [], []
        for flip in flips:
            sync()
            t0 = time.perf_counter()
            out = train.ddp_train_step(ddp, optimizer, shard, generator,
                                       flip=flip, parity=parity)
            sync()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            metrics.append({k: float(v) for k, v in out.items()})
        torch.save({"metrics": metrics, "step_ms": step_ms,
                    "launches": launch_counts(),
                    "peak_memory_bytes": (
                        torch.cuda.max_memory_allocated(device)
                        if device.type == "cuda" else 0),
                    "state_dict": {k: v.detach().cpu().clone()
                                   for k, v in model.state_dict().items()}},
                   f"{out_dir}/rank{rank}.pt")
    finally:
        mesh.destroy_process_group()


def run_ddp_steps(world: int, out_dir: str, opts, seed: int, batch: dict,
                  flips, device_type: str = "cpu", backend=None,
                  parity: bool = False, spread: bool = False,
                  meanwhile=None, timeout: float = 900.0):
    """`ddp_steps` on `world` ranks, one process each; returns what each
    rank wrote (and deletes its file), in rank order, or, with
    `meanwhile`, (that, the result of `meanwhile()`, which the calling
    process runs while the ranks do). A failed rank raises here, and
    ranks still running after `timeout` seconds are stopped and raise
    `TimeoutError`."""
    import os
    import time
    import torch.multiprocessing as mp
    os.makedirs(out_dir, exist_ok=True)
    init_file = os.path.join(out_dir, "rendezvous")
    if os.path.exists(init_file):
        os.remove(init_file)
    ranks = mp.spawn(ddp_steps, nprocs=world, join=False, args=(
        world, init_file, out_dir, opts, seed, batch, list(flips),
        device_type, backend, parity, spread))
    deadline = time.monotonic() + timeout
    try:
        extra = meanwhile() if meanwhile is not None else None
        while not ranks.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f"DDP ranks still running after {timeout} s")
    finally:
        for process in ranks.processes:
            if process.is_alive():
                process.terminate()
    results = []
    for rank in range(world):
        path = os.path.join(out_dir, f"rank{rank}.pt")
        results.append(torch.load(path))
        os.remove(path)         # a state dict of the whole model
    return results if meanwhile is None else (results, extra)



def shard_mean_steps(opts, batch: dict, world: int, steps: int, device,
                     seed: int = 0) -> tuple:
    """The single-process reference of `world` ranks' `ddp_steps` (coins
    drawn, not given): the model seeded with `seed`, each step's coin
    from one generator seeded with 0, each rank's rows of the numpy
    `batch` through forward and backward from the same state, the mean
    of their gradients (summed in rank order) through one optimizer
    update, and the mean of their running statistics. Returns (each
    step's mean losses and gradient norm, the final state dict)."""
    from simplerecon_tpu_torch.models.depth_model import build_depth_model
    from simplerecon_tpu_torch.parallel import mesh
    from simplerecon_tpu_torch.parallel import train

    def mean(values):
        total = values[0]
        for value in values[1:]:
            total = total + value
        return total / world

    model = build_depth_model(opts, device=device, seed=seed)
    optimizer = train.make_optimizer(opts, model)
    generator = torch.Generator().manual_seed(0)
    shards = [train.batch_to_device(mesh.shard_batch(batch, r, world),
                                    device) for r in range(world)]
    steps_out = []
    for _ in range(steps):
        flip = train.flip_coin(generator)
        model.train()
        before = {n: b.clone() for n, b in model.named_buffers()}
        grads, stats, losses = [], [], []
        for shard in shards:
            for n, b in model.named_buffers():
                b.copy_(before[n])
            optimizer.zero_grad()
            loss_dict = train.loss_and_backward(model, shard, flip)
            losses.append({k: float(v.detach()) for k, v in loss_dict.items()})
            grads.append([p.grad.detach().clone() for p in model.parameters()])
            stats.append([b.clone() for b in train.running_statistics(model)])
        for p, *shard_grads in zip(model.parameters(), *grads):
            p.grad = mean(shard_grads)
        norm = float(optimizer.step())
        with torch.no_grad():
            for b, *shard_stats in zip(train.running_statistics(model),
                                       *stats):
                b.copy_(mean(shard_stats))
        steps_out.append(dict({k: sum(l[k] for l in losses) / world
                               for k in losses[0]}, grad_norm=norm))
        del grads, stats
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return steps_out, state


def compare_ranks(ranks: list, want: list, ref: dict) -> dict:
    """What `run_ddp_steps` gave against `shard_mean_steps`: whether every
    rank holds rank 0's parameters, buffers and metrics bit for bit, the
    relative L2 of rank 0's parameters and of its running statistics
    from the reference's, the largest relative difference of a loss or
    gradient norm, and whether all are the same bits."""
    def rel_l2(keys):
        num = sum(float(((first[k].double() - ref[k].double().cpu())
                         ** 2).sum()) for k in keys)
        den = sum(float((ref[k].double().cpu() ** 2).sum()) for k in keys)
        return float(np.sqrt(num / max(den, 1e-30)))

    first = ranks[0]["state_dict"]
    ranks_equal = all(
        list(r["state_dict"]) == list(first)
        and all(torch.equal(r["state_dict"][k], first[k]) for k in first)
        and r["metrics"] == ranks[0]["metrics"] for r in ranks[1:])
    stat_keys = [k for k in ref if k.endswith(("running_mean",
                                               "running_var"))]
    params = [k for k, v in ref.items() if v.dtype.is_floating_point
              and k not in stat_keys]
    got = ranks[0]["metrics"]
    return dict(
        ranks_equal=ranks_equal, param_rel=rel_l2(params),
        stat_rel=rel_l2(stat_keys),
        loss_rel=max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-30)
                     for g, w in zip(got, want) for k in w),
        same_bits=all(torch.equal(first[k], ref[k].cpu()) for k in ref))

def compare_depth_maps(got_dir: str, want_dir: str) -> dict:
    """The cached depths of two eval runs: each depth map's relative L2,
    the share of lowest-cost pixels on the same plane, and whether all
    are the same bits."""
    import glob
    import os
    import pickle
    worst, agree, pixels, same = 0.0, 0, 0, True
    paths = sorted(glob.glob(f"{want_dir}/*.pickle"))
    for path in paths:
        with open(path, "rb") as f:
            want = pickle.load(f)
        with open(f"{got_dir}/{os.path.basename(path)}", "rb") as f:
            got = pickle.load(f)
        g, w = got["depth_pred_s0_b1hw"], want["depth_pred_s0_b1hw"]
        worst = max(worst, float(np.linalg.norm(g - w) / np.linalg.norm(w)))
        gl, wl = got["lowest_cost_bhw"], want["lowest_cost_bhw"]
        agree += int(np.isclose(gl, wl, rtol=1e-3).sum())
        pixels += wl.size
        same = same and g.tobytes() == w.tobytes() \
            and gl.tobytes() == wl.tobytes()
    if not paths:
        raise FileNotFoundError(f"no cached depths under {want_dir}")
    return dict(frames=len(paths), depth_l2=worst,
                lowest_agree=agree / pixels, same_bits=same)


def write_sens(path: str, colour_jpegs: list, depths: list,
               colour_hw: tuple, depth_hw: tuple) -> None:
    """Writes a ScanNet `.sens` file (version 4): identity calibration,
    JPEG colour (the files' bytes as given), zlib-compressed uint16 depth
    in millimetres (depth shift 1000), frame i posed at x = i metres."""
    import struct
    import zlib
    with open(path, "wb") as f:
        name = b"synthetic"
        f.write(struct.pack("I", 4) + struct.pack("Q", len(name)) + name)
        for _ in range(4):
            f.write(struct.pack("f" * 16,
                                *np.eye(4, dtype=np.float32).ravel()))
        f.write(struct.pack("ii", 2, 1))            # JPEG colour, zlib depth
        f.write(struct.pack("IIII", colour_hw[1], colour_hw[0], depth_hw[1],
                            depth_hw[0]))
        f.write(struct.pack("f", 1000.0) + struct.pack("Q", len(depths)))
        for i, (jpeg, depth) in enumerate(zip(colour_jpegs, depths)):
            pose = np.eye(4, dtype=np.float32)
            pose[0, 3] = i
            packed = zlib.compress(np.asarray(depth, np.uint16).tobytes())
            f.write(struct.pack("f" * 16, *pose.ravel())
                    + struct.pack("QQQQ", i, i, len(jpeg), len(packed)))
            f.write(jpeg + packed)


def write_ios_capture(scan_dir: str, frames_bgr: list, seed: int = 0
                      ) -> None:
    """Writes an ios-logger capture: `Frames.m4v` (mp4v through
    `cv2.VideoWriter`, 30 fps) of the given frames, `Frames.txt` (a
    comment line, then timestamp, frame, fx, fy, cx, cy a frame) and
    `ARposes.txt` (a comment line, then 2n + 1 seeded poses, timestamp,
    tx ty tz, qw qx qy qz, at other timestamps than the frames')."""
    import os
    import cv2
    os.makedirs(scan_dir, exist_ok=True)
    h, w = frames_bgr[0].shape[:2]
    writer = cv2.VideoWriter(os.path.join(scan_dir, "Frames.m4v"),
                             cv2.VideoWriter_fourcc(*"mp4v"), 30, (w, h))
    for frame in frames_bgr:
        writer.write(np.ascontiguousarray(frame, np.uint8))
    writer.release()
    n = len(frames_bgr)
    with open(os.path.join(scan_dir, "Frames.txt"), "w") as f:
        f.write("# timestamp, frame, fx, fy, cx, cy\n")
        for i in range(n):
            f.write(f"{0.1 * i + 0.013:.3f},{i},{500 + i}.5,{501 + i}.25,"
                    f"{w / 2 + 0.5},{h / 2 - 0.25}\n")
    rng = np.random.RandomState(seed)
    with open(os.path.join(scan_dir, "ARposes.txt"), "w") as f:
        f.write("# timestamp, tx, ty, tz, qw, qx, qy, qz\n")
        for j in range(2 * n + 1):
            q = rng.randn(4)
            q /= np.linalg.norm(q)
            t = rng.uniform(-1, 1, 3)
            f.write(f"{0.05 * j:.3f}," + ",".join(f"{v:.6f}" for v in t)
                    + "," + ",".join(f"{v:.6f}" for v in q) + "\n")
