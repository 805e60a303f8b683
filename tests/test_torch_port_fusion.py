"""The port's depth metrics, meshing and TSDF fusion against the JAX
package's, on the CPU.

- `compute_depth_metrics_batched` on seeded depths with NaNs, an empty
  frame and values below 0.5 m: rtol 1e-6 (both sum float32 values; the
  port in float64, XLA in float32 in its own order), NaN for the empty
  frame on both sides. `ResultsAverager.output_json` writes the same
  bytes.
- `marching_cubes` (the same C++ source) on a sphere and on a half-NaN
  volume: identical vertices and faces. `write_ply` writes the same
  bytes; `read_ply` reads back binary and ascii files.
- `OurFuser` on the rendered GT depths of 6 synthetic frames at 64x96
  (at 32x48, trajectory bounds, 4 cm, 3 m; some NaN holes), plain and
  with colour (the 64x96 image, which the fuser shrinks to the depth's
  size): values, weights and colours differ from JAX's by at most one
  bf16 ulp, in a share of voxels of at most 1e-3, with NaN in the same
  voxels (both write NaN where a NaN depth meets an observed voxel), and
  the meshes and their PLY files are identical. `bounds_from_trajectory` equal to rtol 1e-6.
- The colour resize at a shrinking shape (antialiased) and a growing one
  against `jax.image.resize(..., "bilinear")`: atol 1e-5.
- The GT-depth fusion of the whole synthetic scene at full width (48
  frames, `testing.synthetic_gt_frames`): the JAX package's grid, mesh
  and F1 against the room mesh are `testing.GT_FUSION`, the numbers the
  card's run of the port is held to in `chip_smoke.py`, and the port on
  the CPU gives the same grid and mesh.
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplerecon_tpu.data.synthetic import make_room_mesh
from simplerecon_tpu.fusion import fusers as jfusers
from simplerecon_tpu.fusion import mesh as jmesh
from simplerecon_tpu.utils import metrics as jmetrics
from simplerecon_tpu.utils.mesh_metrics import evaluate_mesh
from simplerecon_tpu_torch.fusion import fusers as tfusers
from simplerecon_tpu_torch.fusion import mesh as tmesh
from simplerecon_tpu_torch.testing import (GT_FUSION, synthetic_gt_bounds,
                                           synthetic_gt_frames)
from simplerecon_tpu_torch.utils import metrics as tmetrics
from test_torch_port_ops import few_torch_threads  # noqa: F401 (autouse)

METRICS_RTOL = 1e-6
BF16_ULP = 2.0 ** -8          # relative spacing of bf16 values
DIFFER_SHARE = 1e-3


def seeded_depths(seed=0, b=4, h=48, w=64):
    rng = np.random.RandomState(seed)
    gt = rng.uniform(0.2, 4.0, (b, h, w)).astype(np.float32)
    gt[rng.rand(b, h, w) < 0.1] = np.nan
    gt[2] = np.nan                                     # an empty frame
    pred = (gt * rng.uniform(0.8, 1.25, (b, h, w))).astype(np.float32)
    pred = np.nan_to_num(pred, nan=1.0)
    pred[0, :4] = 0.0                                  # under the 1e-6 floor
    valid = np.isfinite(gt) & (gt > 0.5)
    return gt, pred, valid


@pytest.mark.parametrize("mult_a", [False, True])
def test_depth_metrics_match_jax(mult_a):
    gt, pred, valid = seeded_depths()
    want = jmetrics.compute_depth_metrics_batched(
        jnp.asarray(gt), jnp.asarray(pred), jnp.asarray(valid),
        mult_a=mult_a)
    got = tmetrics.compute_depth_metrics_batched(
        torch.from_numpy(gt), torch.from_numpy(pred),
        torch.from_numpy(valid), mult_a=mult_a)
    assert list(got) == list(want)
    for key in want:
        w, g = np.asarray(want[key]), got[key].numpy()
        assert g.dtype == np.float32 and g.shape == (4,)
        assert np.isnan(w[2]) and np.isnan(g[2]), key
        np.testing.assert_allclose(g, w, rtol=METRICS_RTOL, err_msg=key)


def test_results_json_is_the_jax_json(tmp_path):
    gt, pred, valid = seeded_depths(seed=1)
    metrics = jmetrics.compute_depth_metrics_batched(
        jnp.asarray(gt), jnp.asarray(pred), jnp.asarray(valid), mult_a=True)
    paths = []
    for pkg in (jmetrics, tmetrics):
        avg = pkg.ResultsAverager("exp", "frame metrics")
        for i in range(4):
            avg.update_results({k: float(v[i]) for k, v in metrics.items()})
        avg.compute_final_average()
        paths.append(tmp_path / f"{pkg.__name__}.json")
        avg.output_json(str(paths[-1]))
    assert paths[0].read_bytes() == paths[1].read_bytes()
    assert json.loads(paths[1].read_text())["scores"]


def sphere_volume(n=24, r=7.5):
    g = np.arange(n, dtype=np.float32) - n / 2 + 0.3
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    return np.sqrt(x ** 2 + y ** 2 + z ** 2) - r


@pytest.mark.parametrize("half_nan", [False, True],
                         ids=["sphere", "half_nan"])
def test_marching_cubes_is_the_jax_kernel(half_nan):
    vol = sphere_volume()
    if half_nan:
        vol[:, :12] = np.nan
    jv, jf = jmesh.marching_cubes(vol)
    tv, tf = tmesh.marching_cubes(vol)
    assert len(tv) > 100 and len(tf) > 100
    assert tv.dtype == np.float32 and tf.dtype == np.int32
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)


def test_ply_write_and_read(tmp_path):
    verts, faces = tmesh.marching_cubes(sphere_volume())
    colors = np.random.RandomState(0).rand(len(verts), 3).astype(np.float32)
    for kw in ({}, {"colors": colors}):
        a, b = tmp_path / "port.ply", tmp_path / "jax.ply"
        tmesh.write_ply(str(a), verts, faces, **kw)
        jmesh.write_ply(str(b), verts, faces, **kw)
        assert a.read_bytes() == b.read_bytes()
        rv, rf = tmesh.read_ply(str(a))
        np.testing.assert_array_equal(rv, verts)
        np.testing.assert_array_equal(rf, faces)
    ascii_path = tmp_path / "ascii.ply"
    lines = ["ply", "format ascii 1.0", f"element vertex {len(verts)}",
             "property float x", "property float y", "property float z",
             f"element face {len(faces)}",
             "property list uchar int vertex_indices", "end_header"]
    lines += [" ".join(repr(float(x)) for x in v) for v in verts]
    lines += ["3 " + " ".join(str(int(i)) for i in f) for f in faces]
    ascii_path.write_text("\n".join(lines) + "\n")
    rv, rf = tmesh.read_ply(str(ascii_path))
    np.testing.assert_array_equal(rv, verts)
    np.testing.assert_array_equal(rf, faces)


def assert_within_one_ulp(got, want, name):
    """bf16 grids (as float32): NaN in the same voxels, elsewhere at most
    one bf16 ulp apart, in at most DIFFER_SHARE of the voxels."""
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), name)
    finite = ~np.isnan(want)
    diff = np.abs(got - want)[finite]
    ulp = BF16_ULP * np.maximum(np.abs(want[finite]), 2.0 ** -126)
    assert (diff <= ulp).all(), (name, diff.max())
    share = float((diff > 0).mean())
    assert share <= DIFFER_SHARE, (name, share)


@pytest.mark.parametrize("color", [False, True], ids=["depth", "color"])
def test_our_fuser_matches_jax(color, tmp_path):
    frames = synthetic_gt_frames(6, 64, 96)
    bounds = synthetic_gt_bounds(6, 64, 96)
    traj = np.stack([f["world_T_cam"] for f in frames])
    np.testing.assert_allclose(
        tfusers.bounds_from_trajectory(traj, 3.0, invK_44=frames[0]["invK"],
                                       image_hw=(32, 48)),
        jfusers.bounds_from_trajectory(traj, 3.0, invK_44=frames[0]["invK"],
                                       image_hw=(32, 48)), rtol=1e-6)
    kw = dict(fusion_resolution=0.04, max_fusion_depth=3.0,
              bounds_3x2=bounds, fuse_color=color)
    ref = jfusers.OurFuser(**kw)
    port = tfusers.OurFuser(**kw, device="cpu")
    depth = np.stack([f["depth_b1hw"] for f in frames])
    depth[3, :, ::7, ::5] = np.nan      # holes in observed voxels
    K = np.stack([f["K"] for f in frames])
    cam_T_world = np.stack([f["cam_T_world"] for f in frames])
    image = np.stack([f["image_b3hw"] for f in frames]) if color else None
    ref.fuse_frames(depth, K, cam_T_world, image)
    port.fuse_frames(depth, K, cam_T_world, image)
    want, got = ref.fuser.tsdf, port.fuser.tsdf
    assert got.dims == want.dims
    for name, g, w in (("values", got.values, want.values),
                       ("weights", got.weights, want.weights)) + (
            (("colors", got.colors, want.colors),) if color else ()):
        assert g.dtype == torch.bfloat16
        assert_within_one_ulp(g.float().numpy(), np.asarray(w, np.float32),
                              name)
    assert np.asarray(want.weights, np.float32).max() > 0
    got_mesh = port.get_mesh(include_colors=color)
    want_mesh = ref.get_mesh(include_colors=color)
    assert len(got_mesh[0]) > 100
    for g, w in zip(got_mesh, want_mesh):
        np.testing.assert_array_equal(g, w)
    paths = [str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")]
    port.export_mesh(paths[0])
    ref.export_mesh(paths[1])
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()


def test_fuser_asks_for_the_card_by_default():
    """Without `device` the fuser's grid goes to the card; with no card
    it raises rather than fuse on the CPU."""
    opts = types.SimpleNamespace(depth_fuser="ours", fusion_resolution=0.04,
                                 fusion_max_depth=3.0, fuse_color=False)
    bounds = np.array([[0.0, 1.0]] * 3)
    for make in (lambda: tfusers.get_fuser(opts, bounds_3x2=bounds),
                 lambda: tfusers.OurFuser(bounds_3x2=bounds)):
        if torch.cuda.is_available():
            assert make().fuser.tsdf.values.device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
    assert tfusers.get_fuser(opts, bounds_3x2=bounds, device="cpu"
                             ).fuser.tsdf.values.device.type == "cpu"


@pytest.mark.parametrize("shape", [(24, 40), (80, 120)],
                         ids=["shrink", "grow"])
def test_colour_resize_matches_jax_image_resize(shape):
    image = np.random.RandomState(3).randn(2, 3, 64, 96).astype(np.float32)
    want = jax.image.resize(jnp.asarray(image), (2, 3) + shape,
                            method="bilinear")
    got = tfusers.resize_bilinear(torch.from_numpy(image), *shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_full_width_gt_fusion_reference():
    frames = synthetic_gt_frames()
    bounds = synthetic_gt_bounds()
    room_v, room_f, _ = make_room_mesh()
    results = {}
    for name, pkg, kw in (("jax", jfusers, {}),
                          ("port", tfusers, dict(device="cpu"))):
        fuser = pkg.OurFuser(fusion_resolution=0.04, max_fusion_depth=3.0,
                             bounds_3x2=bounds, **kw)
        for f in frames:
            fuser.fuse_frames(f["depth_b1hw"][None], f["K"][None],
                              f["cam_T_world"][None])
        verts, faces = fuser.get_mesh()
        results[name] = (tuple(fuser.fuser.tsdf.dims), verts, faces)
    dims, verts, faces = results["jax"]
    assert dims == GT_FUSION["dims"]
    assert (len(verts), len(faces)) == (GT_FUSION["vertices"],
                                        GT_FUSION["faces"])
    scores = evaluate_mesh(verts, faces, room_v, room_f, num_points=100_000)
    for key in ("precision", "recall", "f1"):
        assert scores[key] == pytest.approx(GT_FUSION[key], abs=1e-9), key
    p_dims, p_verts, p_faces = results["port"]
    assert p_dims == dims
    np.testing.assert_array_equal(p_verts, verts)
    np.testing.assert_array_equal(p_faces, faces)
