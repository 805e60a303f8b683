"""The port's eval CLI against the JAX package's, end to end on the CPU:
`simplerecon_tpu_torch.scripts.test.main(opts, device="cpu")` against
`simplerecon_tpu.scripts.test.main(opts)`.

Setup: `dataset="synthetic"` with `DEFAULT_NUM_FRAMES` 9 in both packages
(6 tuples, 3 full batches of 2), 64x96, 4 views, 8 planes, float32,
`run_fusion` (4 cm, 3 m, trajectory bounds), `cache_depths` and
`dump_depth_visualization`. Weights: the port's seeded model with
`spread_outputs_`, written as a full training checkpoint whose directory
the port's CLI loads (`--load_weights_from_checkpoint`), and carried into
the JAX tree by the JAX package's own `convert_state_dict`, which this
test hands to the JAX CLI in place of its random init.

Tolerances (`testing.EVAL_TOL`, which `chip_smoke.py` holds the card to
against the CPU too):
- the cached depths (s0, one pickle a frame): rtol 1e-4, atol 1e-5 (the
  two forwards sum the same float32 products in other orders through
  ~100 layers); their intrinsics and poses exactly;
- the per-frame and per-scene metrics: abs_diff, abs_rel, sq_rel, rmse
  and rmse_log at rtol 1e-4; the inlier percentages within 2 pixels'
  worth of the frame's valid pixels (a depth within rounding of a
  threshold lands on either side);
- the meshes: vertex and face counts within 1%, or 16 (a voxel that
  changes sign remakes its 8 cubes' triangles), and `evaluate_mesh`
  between the two at one voxel (tau = 4 cm): F1 >= 0.99 (two samplings
  of one surface, 20,000 points each, leave some points farther than
  4 cm from the other's).
- the depth visualization PNGs: the same files, the colour images
  identical, the depth images within one 8-bit level at 1 pixel in 1,000
  (a depth that differs in its last bits may cross a level).
Measured: depths 8.1e-6 relative at most, metrics 7.0e-7, no percentage
moved by a pixel, meshes of equal counts (11,133 vertices, 14,224
faces) with F1 0.996.
"""

import os

import numpy as np
import pytest
import torch

import simplerecon_tpu.data.synthetic as jsynthetic
import simplerecon_tpu.scripts.test as jcli
import simplerecon_tpu_torch.data.synthetic as tsynthetic
import simplerecon_tpu_torch.scripts.test as tcli
from PIL import Image
from simplerecon_tpu.options import OptionsHandler as JaxHandler
from simplerecon_tpu.utils.convert_reference_checkpoint import \
    convert_state_dict
from simplerecon_tpu_torch.models.depth_model import build_depth_model
from simplerecon_tpu_torch.options import OptionsHandler
from simplerecon_tpu_torch.parallel import train as ttrain
from simplerecon_tpu_torch.testing import (compare_cached_depths,
                                           compare_meshes, compare_metrics,
                                           plane_ratio, spread_outputs_)
from simplerecon_tpu_torch.utils.checkpoint import save_checkpoint
from test_torch_port_ops import few_torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cl_args(out):
    return ["--config_file",
            os.path.join(REPO, "configs", "models", "hero_model.yaml"),
            "--dataset", "synthetic", "--single_debug_scan_id", "scene",
            "--split", "test", "--run_fusion", "--cache_depths",
            "--dump_depth_visualization",
            "--output_base_path", str(out), "--image_height", "64",
            "--image_width", "96", "--num_images_in_tuple", "4",
            "--model_num_views", "4", "--matching_num_depth_bins", "8",
            "--precision", "32", "--batch_size", "2", "--num_workers", "2"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, monkeypatch_module):
    tmp = tmp_path_factory.mktemp("eval")
    for module in (jsynthetic, tsynthetic):
        monkeypatch_module.setattr(module, "DEFAULT_NUM_FRAMES", 9)

    opts = OptionsHandler().parse_and_merge_options(
        cl_args_list=cl_args(tmp / "port"))
    model = spread_outputs_(build_depth_model(opts, device="cpu", seed=3),
                            seed=3)
    # a full training checkpoint, loaded through its directory
    state = ttrain.TrainState(model, ttrain.make_optimizer(opts, model),
                              torch.Generator().manual_seed(0), step=5)
    save_checkpoint(str(tmp / "ckpt"), state, opts)
    opts.load_weights_from_checkpoint = str(tmp / "ckpt")
    port = tcli.main(opts, device="cpu")

    params, stats, _ = convert_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()})
    monkeypatch_module.setattr(
        jcli, "_load_or_init_variables",
        lambda jmodel, jopts: {"params": params, "batch_stats": stats})
    ref = jcli.main(JaxHandler().parse_and_merge_options(
        cl_args_list=cl_args(tmp / "jax")))
    return tmp, port, ref, model


@pytest.fixture(scope="module")
def monkeypatch_module():
    patcher = pytest.MonkeyPatch()
    yield patcher
    patcher.undo()


def out_dir(tmp, pkg):
    return os.path.join(str(tmp / pkg), "hero_model", "synthetic",
                        "default")


def test_cached_depths_match(runs):
    tmp = runs[0]
    depths = os.path.join("depths", "scene")
    measured = compare_cached_depths(
        os.path.join(out_dir(tmp, "port"), depths),
        os.path.join(out_dir(tmp, "jax"), depths))
    assert measured["frames"] == 6


def test_frame_and_scene_metrics_match(runs):
    _, (port_frames, port_scenes), (ref_frames, ref_scenes), _ = runs
    assert len(port_frames.elem_metrics) == len(ref_frames.elem_metrics) == 6
    # at least half of a frame's full-resolution GT pixels are valid
    valid = 64 * 96 * 0.5
    for got, want in zip(port_frames.elem_metrics + [
            port_frames.final_metrics, port_scenes.final_metrics],
            ref_frames.elem_metrics + [ref_frames.final_metrics,
                                       ref_scenes.final_metrics]):
        compare_metrics(got, want, valid)
    assert np.isfinite(port_frames.final_metrics["abs_rel"])
    assert port_frames.run_stats["frames"] == 6


@pytest.mark.parametrize("planes_moved, flips_allowed",
                         [(1, False), (1, True), (5, True), (0.5, True)],
                         ids=["strict", "one_plane", "five_planes",
                              "between_planes"])
def test_cached_depth_plane_flips(tmp_path, planes_moved, flips_allowed):
    """`compare_cached_depths` takes a lowest-cost pixel on another plane
    only when asked to (the card against the CPU), and never a depth
    between planes."""
    import pickle
    opts = OptionsHandler().parse_and_merge_options(
        cl_args_list=cl_args(str(tmp_path)))
    ratio = plane_ratio(opts)
    n = opts.matching_num_depth_bins
    planes = opts.min_matching_depth * ratio ** np.arange(n)
    np.testing.assert_allclose(planes[-1], opts.max_matching_depth)
    rng = np.random.RandomState(0)
    want = dict(frame_id="scene_0", K_full_depth_b44=np.eye(4)[None],
                K_s0_b44=np.eye(4)[None], world_T_cam_b44=np.eye(4)[None],
                cam_T_world_b44=np.eye(4)[None],
                depth_pred_s0_b1hw=rng.uniform(0.5, 4.0, (1, 1, 48, 64)),
                lowest_cost_bhw=planes[rng.randint(0, n - 5, (1, 48, 64))])
    got = dict(want, lowest_cost_bhw=want["lowest_cost_bhw"].copy())
    got["lowest_cost_bhw"][0, 5, 7] *= ratio ** planes_moved
    for name, item in (("got", got), ("want", want)):
        os.makedirs(tmp_path / name)
        with open(tmp_path / name / "scene_0.pickle", "wb") as f:
            pickle.dump(item, f)
    check = lambda: compare_cached_depths(  # noqa: E731
        str(tmp_path / "got"), str(tmp_path / "want"),
        flip_ratio=ratio if flips_allowed else 0.0)
    if flips_allowed and planes_moved >= 1:
        assert check()["plane_flips"] == 1
    else:
        with pytest.raises(AssertionError):
            check()


def test_meshes_match(runs):
    tmp = runs[0]
    mesh = os.path.join("meshes", "4cm_3.0m", "scene.ply")
    measured = compare_meshes(os.path.join(out_dir(tmp, "port"), mesh),
                              os.path.join(out_dir(tmp, "jax"), mesh))
    assert measured["faces"][1] > 100, measured


def test_metrics_json_written(runs):
    tmp = runs[0]
    for name in ("all_frame_avg_metrics.json", "all_scene_avg_metrics.json",
                 "scene_avg_metrics.json"):
        assert os.path.exists(os.path.join(out_dir(tmp, "port"), "scores",
                                           name)), name


def test_checkpoint_round_trip(runs, tmp_path):
    from simplerecon_tpu_torch.utils import checkpoint as ckpt_lib
    from simplerecon_tpu_torch.utils.weights import init_random_
    tmp, model = runs[0], runs[3]
    opts = OptionsHandler().parse_and_merge_options(
        cl_args_list=cl_args(tmp / "port"))
    path = ckpt_lib.save_weights(str(tmp_path / "c.pt"), model, opts)
    stored = ckpt_lib.load_options_from_checkpoint(path)
    assert stored.to_dict() == opts.to_dict()
    # the checkpoint's options define the model, whatever the caller's say
    caller = OptionsHandler().parse_and_merge_options(
        cl_args_list=cl_args(tmp_path) + ["--matching_num_depth_bins", "4"])
    caller.load_weights_from_checkpoint = path
    loaded = tcli.load_model(caller, "cpu")
    assert loaded.cost_volume.num_depth_bins == 8
    for (name, a), b in zip(model.state_dict().items(),
                            loaded.state_dict().values()):
        assert torch.equal(a, b), name
    # a bare state_dict and a reference Lightning file's `state_dict`
    for seed, blob in enumerate((model.state_dict(),
                                 {"state_dict": model.state_dict(),
                                  "epoch": 3})):
        torch.save(blob, str(tmp_path / "bare.pt"))
        init_random_(loaded, torch.Generator().manual_seed(seed))
        ckpt_lib.load_weights(str(tmp_path / "bare.pt"), loaded)
        for (name, a), b in zip(model.state_dict().items(),
                                loaded.state_dict().values()):
            assert torch.equal(a, b), name
    assert ckpt_lib.load_options_from_checkpoint(
        str(tmp_path / "bare.pt")) is None


def test_depth_visualization_matches_jax(runs):
    """`--dump_depth_visualization` writes the JAX CLI's PNGs."""
    tmp = runs[0]
    viz = os.path.join("viz", "quick_viz", "scene")
    port_dir = os.path.join(out_dir(tmp, "port"), viz)
    jax_dir = os.path.join(out_dir(tmp, "jax"), viz)
    names = sorted(os.listdir(jax_dir))
    assert sorted(os.listdir(port_dir)) == names and len(names) == 8, names
    for name in names:
        got = np.asarray(Image.open(os.path.join(port_dir, name)))
        want = np.asarray(Image.open(os.path.join(jax_dir, name)))
        assert got.shape == want.shape and got.dtype == want.dtype, name
        diff = np.abs(got.astype(int) - want.astype(int))
        if name.endswith("color.png"):
            assert diff.max() == 0, name
        else:
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, name
