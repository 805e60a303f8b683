"""The port's point-cloud fusion against the JAX package's, on the CPU:
`fusion/point_cloud.py` (the consistency pass, the voxel mean,
`process_scene`) and the `pc_fusion` CLI.

Scenes: the camera-and-wall scenes of `tests/test_point_cloud.py`
(rebuilt here: a consistent wall, a frame that disagrees, a noisy wall,
and the voxel mean of three points) and the synthetic room's GT depths
(12 frames at 64x96, depth 32x48). Tolerances: the keep mask of every
reference frame equal; the kept points within 1e-5 m (float32 sums of
the same products, which XLA may fuse into FMAs); the voxel output of
the same points equal; `process_scene`'s output of the same count, each
point within 1e-5 m of one of the other's (a point an ulp away may fall
in the next voxel, as at the noisy wall's 1e-6 m voxels, which moves
rows of the sorted output).

The CLIs: both run the 9-frame synthetic scene (6 tuples, batches of 2)
at 64x96, 4 views, 8 planes, float32, with the port's seeded weights
(written as a weights file for the port, carried into the JAX tree by
`convert_state_dict` for the JAX CLI), and fusion thresholds loosened
to 0.5 m and one agreeing frame, since random weights predict rough
depths. Their predicted depths agree to ~1e-5 (`test_torch_port_eval.py`),
so a point near the |z - sampled| edge may fall on either side: the
point counts within 1%, and 99% of each cloud's points within 1e-4 m of
the other's. Measured: 6,906 points in both, all within 5.4e-6 m.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.spatial import cKDTree

import simplerecon_tpu.data.synthetic as jsynthetic
import simplerecon_tpu.scripts.pc_fusion as jcli
import simplerecon_tpu_torch.data.synthetic as tsynthetic
import simplerecon_tpu_torch.scripts.pc_fusion as tcli
from simplerecon_tpu.fusion import point_cloud as jpc
from simplerecon_tpu.options import OptionsHandler as JaxHandler
from simplerecon_tpu.utils.convert_reference_checkpoint import \
    convert_state_dict
from simplerecon_tpu_torch.fusion import point_cloud as tpc
from simplerecon_tpu_torch.fusion.mesh import read_ply
from simplerecon_tpu_torch.models.depth_model import build_depth_model
from simplerecon_tpu_torch.options import OptionsHandler
from simplerecon_tpu_torch.testing import (spread_outputs_,
                                           synthetic_gt_frames)
from simplerecon_tpu_torch.utils.checkpoint import save_weights
from test_torch_port_ops import few_torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POINT_TOL = 1e-5


def _camera(tx=0.0):
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 50.0
    K[0, 2] = K[1, 2] = 25.0
    pose = np.eye(4, dtype=np.float32)  # world_T_cam
    pose[0, 3] = tx
    return K, pose


def wall_scene(name):
    """(depths, world_T_cam, K, invK, process_scene kwargs) of one of
    `tests/test_point_cloud.py`'s scenes."""
    rng = np.random.RandomState(0)
    if name == "consistent":
        size, txs, kw = 50, (0.0, 0.05, -0.05), dict(
            z_thresh=0.04, n_consistent=2, voxel_downsample_size=0.02)
        depths = [np.full((size, size), 2.0, np.float32) for _ in txs]
    elif name == "inconsistent":
        size, txs, kw = 40, (0.0, 0.05, -0.05), dict(
            z_thresh=0.04, n_consistent=2, voxel_downsample_size=0.005)
        depths = [np.full((size, size), 2.0 if i < 2 else 1.0, np.float32)
                  for i in range(3)]
    else:   # "noisy"
        size, txs, kw = 48, (0.0, 0.03, -0.03, 0.06), dict(
            z_thresh=0.08, n_consistent=3, voxel_downsample_size=1e-6)
        depths = [(2.0 + 0.01 * rng.randn(size, size)).astype(np.float32)
                  for _ in txs]
    Ks, poses = zip(*[_camera(tx) for tx in txs])
    return (np.stack(depths), np.stack(poses), np.stack(Ks),
            np.stack([np.linalg.inv(k) for k in Ks]), kw)


def room_scene():
    frames = synthetic_gt_frames(12, 64, 96)
    depths = np.stack([f["depth_b1hw"][0] for f in frames])
    # a few holes, which both sides must drop
    depths[:, ::7, ::5] = np.nan
    return (depths, np.stack([f["world_T_cam"] for f in frames]),
            np.stack([f["K"] for f in frames]),
            np.stack([f["invK"] for f in frames]),
            dict(z_thresh=0.04, n_consistent=3,
                 voxel_downsample_size=0.02))


def assert_passes_match(depths, poses, Ks, invKs, kw):
    """Every reference frame's keep mask and kept points, port against
    JAX; returns the kept points of the port."""
    passes = tpc.fuse_points(depths, poses, Ks, invKs,
                             z_thresh=kw["z_thresh"],
                             n_consistent=kw["n_consistent"], device="cpu")
    w2c = np.stack([np.linalg.inv(p) for p in poses])
    args = [jnp.asarray(a, jnp.float32) for a in
            (np.nan_to_num(depths, nan=0.0), poses, w2c, Ks, invKs)]
    kept = []
    for ref, (pts, keep) in enumerate(passes):
        want_pts, want_keep, _ = jpc._consistency_pass(
            *args, ref, z_thresh=kw["z_thresh"],
            n_consistent=kw["n_consistent"])
        want_keep = np.asarray(want_keep)
        np.testing.assert_array_equal(keep, want_keep, err_msg=str(ref))
        np.testing.assert_allclose(pts[keep], np.asarray(want_pts)[keep],
                                   rtol=0, atol=POINT_TOL)
        kept.append(pts[keep])
    return np.concatenate(kept, 0)


@pytest.mark.parametrize("name", ["consistent", "inconsistent", "noisy",
                                  "room"])
def test_process_scene_matches_jax(name):
    depths, poses, Ks, invKs, kw = (room_scene() if name == "room"
                                    else wall_scene(name))
    kept = assert_passes_match(depths, poses, Ks, invKs, kw)
    got, _ = tpc.process_scene(depths, poses, Ks, invKs, device="cpu", **kw)
    want, _ = jpc.process_scene(depths, poses, Ks, invKs, **kw)
    assert got.shape == want.shape
    if len(want):
        # a point one ulp away may fall in the next voxel, which moves its
        # row in the sorted output: compare the clouds as sets
        for a, b in ((got, want), (want, got)):
            assert cKDTree(b).query(a)[0].max() <= POINT_TOL
    if name == "inconsistent":
        assert len(got) == 0
    else:
        assert len(got) > 100
    # the voxel mean of the same points gives the same bits
    voxel = kw["voxel_downsample_size"]
    colors = np.random.RandomState(1).rand(len(kept), 3).astype(np.float32)
    for a, b in zip(tpc.voxel_downsample(kept, voxel, colors),
                    jpc.voxel_downsample(kept, voxel, colors)):
        np.testing.assert_array_equal(a, b)


def test_voxel_downsample_of_three_points():
    pts = np.array([[0.0, 0.0, 0.0], [0.001, 0.001, 0.001],
                    [1.0, 1.0, 1.0]], np.float32)
    got, _ = tpc.voxel_downsample(pts, 0.1)
    want, _ = jpc.voxel_downsample(pts, 0.1)
    assert len(got) == 2
    np.testing.assert_array_equal(got, want)


def test_process_scene_defaults_to_the_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    depths, poses, Ks, invKs, kw = wall_scene("consistent")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpc.process_scene(depths, poses, Ks, invKs, **kw)


def cl_args(out):
    return ["--config_file",
            os.path.join(REPO, "configs", "models", "hero_model.yaml"),
            "--dataset", "synthetic", "--single_debug_scan_id", "scene",
            "--split", "test", "--output_base_path", str(out),
            "--image_height", "64", "--image_width", "96",
            "--num_images_in_tuple", "4", "--model_num_views", "4",
            "--matching_num_depth_bins", "8", "--precision", "32",
            "--batch_size", "2", "--num_workers", "2",
            # random weights predict rough depths: loose thresholds leave
            # a cloud to compare
            "--pc_fusion_z_thresh", "0.5", "--n_consistent_thresh", "1"]


@pytest.fixture
def patched_frames(monkeypatch):
    for module in (jsynthetic, tsynthetic):
        monkeypatch.setattr(module, "DEFAULT_NUM_FRAMES", 9)


def test_pc_fusion_cli_matches_jax(tmp_path, monkeypatch, patched_frames):
    opts = OptionsHandler().parse_and_merge_options(
        cl_args_list=cl_args(tmp_path / "port"))
    model = spread_outputs_(build_depth_model(opts, device="cpu", seed=3),
                            seed=3)
    opts.load_weights_from_checkpoint = save_weights(
        str(tmp_path / "weights.pt"), model, opts)
    stats = tcli.main(opts, device="cpu")
    assert stats["frames"] == 6 and stats["batches"] == 3

    params, batch_stats, _ = convert_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()})
    monkeypatch.setattr(
        jcli, "_load_or_init_variables",
        lambda jmodel, jopts: {"params": params, "batch_stats": batch_stats})
    jcli.main(JaxHandler().parse_and_merge_options(
        cl_args_list=cl_args(tmp_path / "jax")))

    rel = os.path.join("hero_model", "synthetic", "default", "pc_fusion",
                       "scene.ply")
    got, got_faces = read_ply(str(tmp_path / "port" / rel))
    want, _ = read_ply(str(tmp_path / "jax" / rel))
    assert stats["plys"]["scene"] == str(tmp_path / "port" / rel)
    assert len(got_faces) == 0 and len(want) > 100
    assert abs(len(got) - len(want)) <= 0.01 * len(want), (len(got),
                                                            len(want))
    for a, b in ((got, want), (want, got)):
        dist, _ = cKDTree(b).query(a)
        assert np.mean(dist <= 1e-4) >= 0.99, np.quantile(dist, 0.99)
