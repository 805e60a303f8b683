"""The port's training program and what it writes, against the JAX
package, on the CPU.

- The CLI as a whole: `simplerecon_tpu.scripts.train.main(opts)` once (a
  module fixture) and the port's `main(opts, device="cpu")` on the same
  options: the hero YAML with the synthetic scene (`DEFAULT_NUM_FRAMES` 9
  in both packages: 6 tuples), 64x96, 4 views, 8 planes, float32, batch
  2, 2 steps, a log every step and a validation at step 2 over 1 batch,
  `--matching_norm group` (so the group-norm hero model runs in train
  mode in the steps and in eval mode in the validation), one device.
  Weights: the port's seeded init (`random_seed`), which the port's CLI
  draws itself, carried into the JAX state by the JAX package's own
  `convert_state_dict` in place of the JAX CLI's init (a jitted init of
  the whole model costs over a minute of XLA compile on the CPU). The
  two packages draw the flip coin differently, so the port's
  `parallel.train.flip_coin` is patched to return the JAX CLI's coins.
  The port's loader gives each item a random state of its own, from
  (seed, epoch, index) (`data/loader.py::item_rng`), where the JAX
  dataset draws every item's augmentation from one state its loader's
  threads share; the JAX dataset is given the port's state for each
  item, one item at a time.
  Held equal: the training and validation batches (numpy), the JSONL
  keys, the checkpoint layout (`checkpoints/step_2`, `best/step_2`, a
  state and `options.yaml` in each) and the options snapshot. Held close:
  `train/loss` at steps 1 and 2 and `val/loss` at step 2 within
  LOSS_RTOL * 30^t relative, t the updates before the loss
  (`test_torch_port_train.py::test_consecutive_steps_follow_jax`'s
  tolerance: Adam's first updates move each weight by about lr * sign of
  its gradient, and a gradient near zero takes either sign).
- Checkpoints: the CLI's full state restored gives the same bits;
  rotation keeps the newest two; a resumed run goes on from the
  checkpoint's step and a finetune starts a fresh optimizer;
  `load_weights` takes a checkpoint directory, a step directory and a
  file; a stripped checkpoint loads into the eval CLI's `load_model`.
- Visualization: the colormap, colormapped depth with NaN and inf,
  normals from depth and the validation panels equal the JAX functions'
  arrays; the port's PNG decodes (Pillow) to the pixels of the JAX
  package's Pillow-written PNG.
- The group norm: `ResnetMatchingEncoder(norm="group")` against JAX's in
  train and in eval mode, max |torch - jax| <= 1e-4 * (1 + max |jax|),
  and the port's train-mode output equal to its eval-mode output.
- The grand loop: a 2-step run (9 frames, batch 2, 16 cm voxels, 2,000
  points a mesh for its metrics) trains,
  evaluates, fuses and scores a mesh, and its summary has the keys of the
  JAX loop's summary.
"""

import json
import os
import shutil
import threading

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import simplerecon_tpu.data.synthetic as jsynthetic
import simplerecon_tpu.scripts.train as jcli
import simplerecon_tpu.utils.cache as jcache
import simplerecon_tpu_torch.data.synthetic as tsynthetic
import simplerecon_tpu_torch.scripts.train as tcli
from simplerecon_tpu.models.matching_encoder import \
    ResnetMatchingEncoder as JaxMatchingEncoder
from simplerecon_tpu.options import OptionsHandler as JaxHandler
from simplerecon_tpu.parallel.mesh import make_mesh, replicated_sharding
from simplerecon_tpu.parallel.train import TrainState as JaxTrainState
from simplerecon_tpu.utils import visualization as jviz
from simplerecon_tpu.utils.convert_reference_checkpoint import \
    convert_state_dict
from simplerecon_tpu_torch.data.loader import item_rng
from simplerecon_tpu_torch.models.depth_model import build_depth_model
from simplerecon_tpu_torch.models.matching_encoder import \
    ResnetMatchingEncoder
from simplerecon_tpu_torch.options import OptionsHandler, load_options_yaml
from simplerecon_tpu_torch.parallel import train as ttrain
from simplerecon_tpu_torch.scripts import test as test_cli
from simplerecon_tpu_torch.utils import checkpoint as ckpt_lib
from simplerecon_tpu_torch.utils import visualization as tviz
from test_torch_port_modules import (assert_close, bridged, nchw,
                                     random_variables)
from test_torch_port_ops import few_torch_threads  # noqa: F401 (autouse)
from test_torch_port_train import LOSS_RTOL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_WIDENING = 30.0


def cl_args(log_dir):
    return ["--config_file",
            os.path.join(REPO, "configs", "models", "hero_model.yaml"),
            "--dataset", "synthetic", "--single_debug_scan_id", "scene",
            "--image_height", "64", "--image_width", "96",
            "--num_images_in_tuple", "4", "--model_num_views", "4",
            "--matching_num_depth_bins", "8", "--precision", "32",
            "--batch_size", "2", "--val_batch_size", "2",
            "--max_steps", "2", "--log_interval", "1",
            "--val_interval", "2", "--val_batches", "1",
            "--num_workers", "2", "--num_devices", "1",
            "--matching_norm", "group", "--log_dir", str(log_dir)]


@pytest.fixture(scope="module")
def monkeypatch_module():
    patcher = pytest.MonkeyPatch()
    yield patcher
    patcher.undo()


def _jax_variables(model):
    """The port model's weights as JAX variables, through the JAX
    package's `convert_state_dict`; its GroupNorms (which the converter
    reads as batch norms) get placeholder statistics that are dropped
    after."""
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    for name, module in model.named_modules():
        if isinstance(module, torch.nn.GroupNorm):
            sd[f"{name}.running_mean"] = np.zeros(module.num_channels,
                                                  np.float32)
            sd[f"{name}.running_var"] = np.ones(module.num_channels,
                                                np.float32)
    params, stats, _ = convert_state_dict(sd)
    stats.pop("matching_model")
    return params, stats


def _record(log, fn):
    """`fn` that first appends its batch argument, as numpy, to `log`."""
    def wrapped(*args):
        batch = next(a for a in args if isinstance(a, dict) and "cur" in a)
        log.append(jax.tree_util.tree_map(
            lambda x: np.array(x.cpu() if isinstance(x, torch.Tensor) else x),
            batch))
        return fn(*args)
    return wrapped


@pytest.fixture(scope="module")
def runs(tmp_path_factory, monkeypatch_module):
    mp = monkeypatch_module
    tmp = tmp_path_factory.mktemp("train_cli")
    for module in (jsynthetic, tsynthetic):
        mp.setattr(module, "DEFAULT_NUM_FRAMES", 9)
    opts = OptionsHandler().parse_and_merge_options(
        cl_args_list=cl_args(tmp / "port"))
    params, stats = _jax_variables(
        build_depth_model(opts, device="cpu", seed=opts.random_seed))

    def init_train_state(model, optimizer, rng, example_batch):
        state = JaxTrainState(step=jax.numpy.zeros((), jax.numpy.int32),
                              params=params, batch_stats=stats,
                              opt_state=optimizer.init(params))
        # placed as the jitted step returns it, so the step compiles once
        return jax.device_put(state, replicated_sharding(make_mesh(1)))

    jax_log = dict(train=[], val=[], flips=[])
    make_step = jcli.make_sharded_train_step

    def make_sharded_train_step(*args, **kw):
        step = make_step(*args, **kw)

        def recorded(state, batch, rng):
            jax_log["flips"].append(bool(jax.random.bernoulli(
                jax.random.fold_in(rng, state.step))))
            return _record(jax_log["train"], step)(state, batch, rng)
        return recorded

    build_loaders = jcli.build_dataloaders

    def build_dataloaders(jopts):
        # the JAX eval step is jitted: its batches are read off the loader
        train_loader, val_loader = build_loaders(jopts)

        class Recorded:
            def __iter__(self):
                for batch in val_loader:
                    jax_log["val"].append(batch)
                    yield batch
        return train_loader, Recorded()

    jax_getitem = jsynthetic.SyntheticDataset.__getitem__
    lock = threading.Lock()

    def getitem(self, idx):
        # both runs stay inside their first epoch
        with lock:
            self.rng = item_rng(opts.random_seed, 0, idx)
            return jax_getitem(self, idx)

    mp.setattr(jsynthetic.SyntheticDataset, "__getitem__", getitem)
    mp.setattr(jcli, "init_train_state", init_train_state)
    mp.setattr(jcli, "make_sharded_train_step", make_sharded_train_step)
    mp.setattr(jcli, "build_dataloaders", build_dataloaders)
    mp.setattr(jcache, "copy_code_state", lambda log_dir: log_dir)
    jcli.main(JaxHandler().parse_and_merge_options(
        cl_args_list=cl_args(tmp / "jax")))

    port_log = dict(train=[], val=[])
    flips = iter(jax_log["flips"])
    mp.setattr(ttrain, "flip_coin", lambda generator: next(flips))
    mp.setattr(ttrain, "train_step",
               _record(port_log["train"], ttrain.train_step))
    mp.setattr(ttrain, "eval_step",
               _record(port_log["val"], ttrain.eval_step))
    state = tcli.main(opts, device="cpu")
    mp.undo()
    runs = dict(tmp=tmp, opts=opts, state=state, jax=jax_log, port=port_log)
    layouts = {pkg: layout(log_root(runs, pkg)) for pkg in ("port", "jax")}
    # the states no later test reads (~0.6 GB each)
    for pkg, sub in (("jax", "checkpoints"), ("jax", "best"),
                     ("port", "best")):
        step_dir = os.path.join(log_root(runs, pkg), sub, "step_2")
        shutil.rmtree(os.path.join(step_dir, "state"), ignore_errors=True)
        if os.path.isfile(os.path.join(step_dir, "state.pt")):
            os.remove(os.path.join(step_dir, "state.pt"))
    return dict(runs, layouts=layouts)


def log_root(runs, pkg):
    return os.path.join(str(runs["tmp"] / pkg), "hero_model")


def layout(root):
    """{"checkpoints" and "best": {step directory: its entries without
    their extensions}}."""
    return {sub: {step: sorted(os.path.splitext(name)[0] for name in
                               os.listdir(os.path.join(root, sub, step)))
                  for step in os.listdir(os.path.join(root, sub))}
            for sub in ("checkpoints", "best")}


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_train_cli_batches_match_jax(runs):
    for part in ("train", "val"):
        got, want = runs["port"][part], runs["jax"][part]
        # the JAX validation reads one batch past the last it uses
        want = want[:len(got)]
        assert len(got) == len(want) == {"train": 2, "val": 1}[part]
        for g, w in zip(got, want):
            for side in ("cur", "src"):
                assert sorted(g[side]) == sorted(w[side]), side
                for key in w[side]:
                    np.testing.assert_array_equal(g[side][key], w[side][key],
                                                  err_msg=f"{side}/{key}")


def test_train_cli_losses_follow_jax(runs):
    got = read_jsonl(os.path.join(log_root(runs, "port"), "metrics.jsonl"))
    want = read_jsonl(os.path.join(log_root(runs, "jax"), "metrics.jsonl"))
    pairs = [(g["step"], key, g[key], w[key])
             for g, w in zip(got, want)
             for key in ("train/loss", "val/loss") if key in w]
    assert [(s, k) for s, k, _, _ in pairs] == [
        (1, "train/loss"), (2, "train/loss"), (2, "val/loss")], pairs
    for step, key, g, w in pairs:
        updates = step - 1 if key == "train/loss" else step
        tol = LOSS_RTOL * STEP_WIDENING ** updates
        assert abs(g - w) <= tol * abs(w), (step, key, g, w)


def test_train_cli_logs_checkpoints_and_options_match_jax(runs):
    port, ref = log_root(runs, "port"), log_root(runs, "jax")
    got = read_jsonl(os.path.join(port, "metrics.jsonl"))
    want = read_jsonl(os.path.join(ref, "metrics.jsonl"))
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert all(np.isfinite(v) for r in got for v in r.values())

    assert runs["layouts"]["port"] == runs["layouts"]["jax"] == {
        "checkpoints": {"step_2": ["options", "state"]},
        "best": {"step_2": ["options", "state"]}}
    snapshot = load_options_yaml(os.path.join(port, "options.yaml"))
    reference = load_options_yaml(os.path.join(ref, "options.yaml"))
    assert snapshot.pop("log_dir") != reference.pop("log_dir")
    assert snapshot == reference
    assert load_options_yaml(os.path.join(
        port, "checkpoints", "step_2", "options.yaml"))["matching_norm"] \
        == "group"
    panels = sorted(os.listdir(os.path.join(port, "panels")))
    assert panels == sorted(os.listdir(os.path.join(ref, "panels"))) == [
        "step00000002_0.png", "step00000002_1.png"]
    assert os.path.isfile(os.path.join(port, "code",
                                       "simplerecon_tpu_torch", "scripts",
                                       "train.py"))


def _fresh_state(opts, seed):
    model = build_depth_model(opts, device="cpu", seed=seed)
    return ttrain.TrainState(model, ttrain.make_optimizer(opts, model),
                             torch.Generator().manual_seed(seed))


def _assert_same_state(got, want):
    for (name, a), b in zip(want.model.state_dict().items(),
                            got.model.state_dict().values()):
        assert torch.equal(a, b), name
    a, b = want.optimizer.inner.state_dict(), got.optimizer.inner.state_dict()
    for i, moments in a["state"].items():
        for key, value in moments.items():
            assert torch.equal(value, b["state"][i][key]), (i, key)
    for key in ("count", "consecutive_errors", "total_errors"):
        assert getattr(got.optimizer, key) == getattr(want.optimizer, key)
    assert got.step == want.step
    assert torch.equal(got.generator.get_state(), want.generator.get_state())


def test_full_state_resume_finetune_and_rotation(runs, tmp_path):
    opts, trained = runs["opts"], runs["state"]
    ckpt_dir = os.path.join(log_root(runs, "port"), "checkpoints")
    restored = ckpt_lib.restore_checkpoint(ckpt_dir, _fresh_state(opts, 9))
    _assert_same_state(restored, trained)
    assert restored.optimizer.count == 2 and restored.step == 2

    # rotation, on a small state
    linear = torch.nn.Linear(3, 2)
    small = ttrain.TrainState(linear, ttrain.make_optimizer(opts, linear),
                              torch.Generator())
    for step in (3, 4, 5):
        small.step = step
        ckpt_lib.save_checkpoint(str(tmp_path / "rot"), small, opts)
    assert sorted(os.listdir(tmp_path / "rot")) == ["step_4", "step_5"]
    assert ckpt_lib.latest_step(str(tmp_path / "rot")) == 5

    resumed = OptionsHandler().parse_and_merge_options(
        cl_args_list=cl_args(tmp_path / "resumed")
        + ["--max_steps", "3", "--val_interval", "100"])
    resumed.resume = ckpt_dir
    state = tcli.main(resumed, device="cpu")
    assert (state.step, state.optimizer.count) == (3, 3)
    assert sorted(os.listdir(tmp_path / "resumed" / "hero_model" /
                             "checkpoints")) == ["step_3"]
    rows = read_jsonl(str(tmp_path / "resumed" / "hero_model" /
                          "metrics.jsonl"))
    assert [r["step"] for r in rows if "train/loss" in r] == [3]

    tuned = OptionsHandler().parse_and_merge_options(
        cl_args_list=cl_args(tmp_path / "tuned") + ["--max_steps", "0"])
    tuned.load_weights_from_checkpoint = ckpt_dir
    state = tcli.main(tuned, device="cpu")
    assert (state.step, state.optimizer.count) == (0, 0)
    assert state.optimizer.inner.state_dict()["state"] == {}
    for (name, a), b in zip(trained.model.state_dict().items(),
                            state.model.state_dict().values()):
        assert torch.equal(a, b), name
    shutil.rmtree(tmp_path)


@pytest.mark.parametrize("form", ["directory", "step", "file"])
def test_load_weights_takes_a_directory_a_step_or_a_file(runs, form):
    ckpt_dir = os.path.join(log_root(runs, "port"), "checkpoints")
    path = {"directory": ckpt_dir,
            "step": os.path.join(ckpt_dir, "step_2"),
            "file": os.path.join(ckpt_dir, "step_2", "state.pt")}[form]
    model = build_depth_model(runs["opts"], device="cpu", seed=5)
    ckpt_lib.load_weights(path, model)
    for (name, a), b in zip(runs["state"].model.state_dict().items(),
                            model.state_dict().values()):
        assert torch.equal(a, b), name
    stored = ckpt_lib.load_options_from_checkpoint(path)
    assert stored.matching_norm == "group"


def test_stripped_checkpoint_loads_into_the_eval_cli(runs, tmp_path):
    from simplerecon_tpu_torch.scripts import strip_checkpoint
    ckpt_dir = os.path.join(log_root(runs, "port"), "checkpoints")
    out = strip_checkpoint.main(["--src", ckpt_dir,
                                 "--dst", str(tmp_path / "stripped")])
    assert sorted(os.listdir(out)) == ["options.yaml", "weights.pt"]
    assert "optimizer" not in torch.load(os.path.join(out, "weights.pt"),
                                         weights_only=False)
    caller = OptionsHandler().parse_and_merge_options(cl_args_list=[
        "--matching_num_depth_bins", "4",
        "--load_weights_from_checkpoint", str(tmp_path / "stripped")])
    model = test_cli.load_model(caller, "cpu")
    assert model.cost_volume.num_depth_bins == 8
    for (name, a), b in zip(runs["state"].model.state_dict().items(),
                            model.state_dict().values()):
        assert torch.equal(a, b), name
    shutil.rmtree(tmp_path)


def viz_inputs():
    rng = np.random.RandomState(4)
    depth = rng.uniform(0.5, 4.0, (2, 24, 32)).astype(np.float32)
    depth[0, :3] = np.nan
    depth[1, 5, :4] = np.inf
    invK = np.linalg.inv(np.array([[30.0, 0, 16, 0], [0, 30.0, 12, 0],
                                   [0, 0, 1, 0], [0, 0, 0, 1]])
                         ).astype(np.float32)
    cur = {"image_b3hw": rng.randn(2, 3, 48, 64).astype(np.float32),
           "depth_bhw": depth}
    normals = rng.randn(2, 24, 32, 3).astype(np.float32)
    normals[1, 0, 0] = np.nan
    outputs = {"depth_pred_s0_bhw1": depth[..., None] * 1.1 + 0.1,
               "normals_pred_bhw3": normals,
               "lowest_cost_bhw": depth[:, ::2, ::2] * 0.9}
    return depth, invK, cur, outputs


def test_visualization_matches_jax():
    depth, invK, cur, outputs = viz_inputs()
    x = np.linspace(-0.2, 1.2, 101).astype(np.float32)
    np.testing.assert_array_equal(tviz.turbo_colormap(x),
                                  jviz.turbo_colormap(x))
    for vmin, vmax in ((None, None), (1.0, 3.0)):
        np.testing.assert_array_equal(
            tviz.colormap_image(depth[0], vmin, vmax),
            jviz.colormap_image(depth[0], vmin, vmax))
    np.testing.assert_array_equal(tviz.normals_from_depth_np(depth[0], invK),
                                  jviz.normals_from_depth_np(depth[0], invK))
    torch_outputs = {k: torch.from_numpy(v) for k, v in outputs.items()}
    for got in (tviz.build_image_panels(cur, outputs),
                tviz.build_image_panels(
                    {k: torch.from_numpy(v) for k, v in cur.items()},
                    torch_outputs)):
        np.testing.assert_array_equal(got,
                                      jviz.build_image_panels(cur, outputs))


def test_png_pixels_match_the_jax_writer(tmp_path):
    rng = np.random.RandomState(5)
    images = {"rgb": rng.uniform(-0.1, 1.1, (7, 9, 3)),
              "grey": rng.uniform(0, 1, (5, 4)),
              "rgba": rng.uniform(0, 1, (3, 6, 4)),
              "panel": tviz.build_image_panels(*viz_inputs()[2:])[1]}
    for name, image in images.items():
        got = tviz.save_image(str(tmp_path / f"{name}_port.png"), image)
        want = jviz.save_image(str(tmp_path / f"{name}_jax.png"), image)
        with open(got, "rb") as f:
            data = f.read()
        assert data[:8] == tviz.PNG_SIGNATURE and data[12:16] == b"IHDR"
        assert data.endswith(b"IEND\xaeB`\x82")
        a, b = Image.open(got), Image.open(want)
        assert a.mode == b.mode, name
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=name)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_group_norm_encoder_matches_jax(train):
    x = np.random.RandomState(6).randn(2, 64, 96, 3).astype(np.float32)
    jmodule = JaxMatchingEncoder(num_ch_out=16, norm="group")
    variables = random_variables(jmodule, (x,), 6)
    assert variables["batch_stats"] == {}
    rng = np.random.RandomState(7)
    jax.tree_util.tree_map_with_path(
        lambda path, leaf: leaf.__setitem__(
            ..., rng.uniform(0.5, 1.5, leaf.shape))
        if path[-1].key == "scale" else None, variables["params"])
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda v, x: jmodule.apply(v, x, train=train))(
            variables, x)
    port = bridged(ResnetMatchingEncoder(num_ch_out=16, norm="group"),
                   "matching_model", variables)
    assert isinstance(port.net[1], torch.nn.GroupNorm)
    with torch.no_grad():
        got = port.train(train)(nchw(x))
        other = port.train(not train)(nchw(x))
    assert_close(got, want)
    assert torch.equal(got, other)


def test_grand_loop_chains_its_stages(tmp_path, monkeypatch):
    from simplerecon_tpu_torch.scripts import grand_loop
    monkeypatch.setattr(tsynthetic, "DEFAULT_NUM_FRAMES", 9)
    summary = grand_loop.main(
        ["--steps", "2", "--batch", "2", "--fusion_resolution", "0.16",
         "--mesh_points", "2000", "--out", str(tmp_path)], device="cpu")
    with open(os.path.join(REPO, "experiments", "grand_loop_r5",
                           "grand_loop_summary.json")) as f:
        reference = json.load(f)
    assert sorted(summary) == sorted(reference)
    with open(tmp_path / "grand_loop_summary.json") as f:
        assert json.load(f) == summary
    assert all(np.isfinite(v) for v in summary.values()
               if not isinstance(v, str)), summary
    plys = [p for p in os.listdir(tmp_path / "eval" / "grand_loop" /
                                  "synthetic" / "default" / "meshes" /
                                  "16cm_8.0m")]
    assert plys == ["scene.ply"]
    shutil.rmtree(tmp_path)
