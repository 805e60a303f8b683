"""The port's data-parallel training and eval against the JAX package, on
the CPU.

- The DDP step (`parallel/train.py::ddp_train_step`): two gloo ranks, one
  process and one torch thread each, at `test_train_parallel.py`'s tiny
  size (64x96, 3 views, 8 planes, global batch 2, float32) take one step
  on their rows of a seeded batch, from the weights and batch of
  `test_torch_port_train.py::seeded_slice` (the port's seeded init with
  its batch norms redrawn), with the coin of `test_train_parallel.py`'s
  step (key 3, step 0).
  The reference is `test_train_parallel.py`'s manual DDP, which that file
  holds equal to the shard_map step: JAX's `_forward_and_losses` under
  one jitted gradient at batch 1 (the fused sweep differentiated by
  autodiff, `cost_volume_custom_vjp=False`, as there), compiled while the
  ranks run, run on each half, the gradients, the losses and the
  new batch statistics averaged, one optax AdamW update (on the
  parameters flattened into one vector, as
  `test_torch_port_train.py::test_adamw_update_matches_optax`). Held at
  `test_torch_port_train.py`'s tolerances for one port step against
  JAX: every loss term rtol LOSS_RTOL; the running statistics
  STATS_TOL x (1 + max |ref|); the parameters after AdamW to a relative
  L2 of PARAM_TOL, `test_train_parallel.py`'s (measured 7.36e-5: Adam's
  first update moves a weight by about lr x the sign of its gradient,
  and the few thousand weights whose gradient is at float32's noise take
  either sign; from the plain seeded init, whose deepest batch norms see
  a few pixels, the same comparison gives 1.26e-4). Both ranks' parameters
  and buffers are the same bits. The port alone: the ranks' parameters
  and running statistics are, bit for bit, the mean of the two halves'
  single-process gradients put through the port's AdamW and the mean of
  their statistics (one torch thread, as the ranks); the eval-mode
  self-check (`parity_metrics`) is the halves' and the whole batch's
  single-process eval losses within SAME_TOL.
- The training CLI with `num_devices=2` on the CPU: two ranks, one
  `metrics.jsonl` with every step, one checkpoint,
  which the single-device `restore_checkpoint` reads into the state the
  CLI returns, and the same steps on both ranks.
- More ranks than cards raise unless gloo is named.
- The data-parallel forward over ["cpu"] * 2 at batch 3 (padded to 4):
  the plain forward's keys and shapes, values within DP_TOL of it; the
  eval CLI with `--data_parallel_eval` over the same devices gives the
  plain run's cached depths within DP_TOL.
"""

import copy
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from simplerecon_tpu.models.depth_model import DepthModel as JaxDepthModel
from simplerecon_tpu.parallel import train as jtrain
from simplerecon_tpu_torch.models.depth_model import build_depth_model
from simplerecon_tpu_torch.parallel import mesh
from simplerecon_tpu_torch.parallel import train as ttrain
from simplerecon_tpu_torch.testing import (hero_options, run_ddp_steps,
                                           train_batch)
from test_torch_port_ops import few_torch_threads  # noqa: F401 (autouse)
from test_torch_port_train import (LOSS_RTOL, STATS_TOL, _flat,
                                   _state_dict_of, jax_grad_fn, seeded_slice)

OPTS = hero_options(image_height=64, image_width=96,
                    matching_num_depth_bins=8, model_num_views=3,
                    precision="32")
SEED = 20
PARAM_TOL = 1e-4
SAME_TOL = 1e-6
DP_TOL = 1e-5


def halves(batch):
    return [mesh.shard_batch(batch, rank, 2) for rank in range(2)]


@pytest.fixture(scope="module")
def ddp_run(tmp_path_factory):
    """The two ranks' results, the initial model, the batch, the flip and
    the JAX manual-DDP reference: (losses, new stats, parameters after
    AdamW as a state dict)."""
    base, params, stats, batch = seeded_slice(OPTS, SEED)
    flip = bool(jax.random.bernoulli(jax.random.fold_in(
        jax.random.PRNGKey(3), 0)))

    def jax_halves():
        jmodel = JaxDepthModel(
            image_height=OPTS.image_height, image_width=OPTS.image_width,
            matching_num_depth_bins=OPTS.matching_num_depth_bins,
            model_num_views=OPTS.model_num_views,
            cost_volume_backend="xla_fused",
            cost_volume_custom_vjp=False, dtype=jnp.float32)
        grad_fn = jax_grad_fn(jmodel)
        runs = []
        with jax.default_matmul_precision("highest"):
            for half in halves(batch):
                grads, (losses, new_stats) = grad_fn(
                    params, stats, jax.tree_util.tree_map(jnp.asarray, half),
                    jnp.asarray(flip))
                runs.append(jax.tree_util.tree_map(
                    np.asarray, (grads, losses, new_stats)))
        return runs

    # the ranks run in their own processes while JAX compiles here
    ranks, runs = run_ddp_steps(
        2, str(tmp_path_factory.mktemp("ddp")), OPTS, SEED, batch, [flip],
        parity=True, spread=True, meanwhile=jax_halves)
    mean = lambda *xs: sum(xs) / len(xs)  # noqa: E731
    grads, losses, new_stats = jax.tree_util.tree_map(mean, *runs)
    tx = jtrain.make_optimizer(OPTS)
    p_vec = _flat(params)
    updates, _ = tx.update(_flat(grads), tx.init(p_vec), p_vec)
    p_vec = np.asarray(optax.apply_updates(p_vec, updates))
    leaves, treedef = jax.tree_util.tree_flatten(params)
    parts = np.split(p_vec, np.cumsum([leaf.size for leaf in leaves])[:-1])
    new_params = jax.tree_util.tree_unflatten(
        treedef, [v.reshape(np.shape(leaf)) for v, leaf in zip(parts,
                                                                  leaves)])
    want = _state_dict_of(new_params, new_stats)
    return dict(ranks=ranks, base=base, batch=batch, flip=flip,
                losses=losses, state_dict=want)


def test_ddp_losses_are_the_mean_of_the_jax_halves(ddp_run):
    for rank in ddp_run["ranks"]:
        (metrics,) = rank["metrics"]
        assert np.isfinite(metrics["grad_norm"])
        assert len(ddp_run["losses"]) == 9
        for key, want in ddp_run["losses"].items():
            np.testing.assert_allclose(metrics[key], float(want),
                                       rtol=LOSS_RTOL, err_msg=key)


def test_ddp_parameters_and_statistics_follow_jax(ddp_run):
    got = ddp_run["ranks"][0]["state_dict"]
    want = ddp_run["state_dict"]
    names = [n for n, _ in ddp_run["base"].named_parameters()]
    num = sum(float(np.sum((got[n].numpy().astype(np.float64)
                            - want[n].astype(np.float64)) ** 2))
              for n in names)
    den = sum(float(np.sum(want[n].astype(np.float64) ** 2)) for n in names)
    rel = np.sqrt(num / den)
    assert rel <= PARAM_TOL, rel
    moved = sum(not torch.equal(got[n], p.detach())
                for n, p in ddp_run["base"].named_parameters())
    assert moved >= 0.95 * len(names), moved
    checked = 0
    for key, value in want.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(
                got[key].numpy(), value, rtol=0,
                atol=STATS_TOL * (1 + np.abs(value).max()), err_msg=key)
            checked += 1
    assert checked > 0


def test_ranks_hold_the_same_bits(ddp_run):
    first, second = (r["state_dict"] for r in ddp_run["ranks"])
    assert list(first) == list(second)
    differ = [k for k in first if not torch.equal(first[k], second[k])]
    assert not differ, differ
    assert ddp_run["ranks"][0]["metrics"] == ddp_run["ranks"][1]["metrics"]


def test_ddp_step_is_the_mean_of_single_process_halves(ddp_run):
    """The port alone, with the ranks' one thread: the mean of the halves'
    gradients and running statistics through the port's optimizer gives
    the ranks' parameters and statistics bit for bit; the eval-mode
    self-check."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model = copy.deepcopy(ddp_run["base"])
        optimizer = ttrain.make_optimizer(OPTS, model)
        grads, stats, evals = [], [], []
        for half in halves(ddp_run["batch"]):
            replica = copy.deepcopy(ddp_run["base"])
            tensors = ttrain.batch_to_device(half, "cpu")
            evals.append(float(ttrain.eval_step(replica, tensors)[0]["loss"]))
            replica.train()
            ttrain.loss_and_backward(replica, tensors, ddp_run["flip"])
            grads.append([p.grad for p in replica.parameters()])
            stats.append(ttrain.running_statistics(replica))
        for p, g0, g1 in zip(model.parameters(), *grads):
            p.grad = (g0 + g1) / 2
        optimizer.step()
        with torch.no_grad():
            for buf, s0, s1 in zip(ttrain.running_statistics(model), *stats):
                buf.copy_((s0 + s1) / 2)
        whole = ttrain.batch_to_device(ddp_run["batch"], "cpu")
        joint = float(ttrain.eval_step(copy.deepcopy(ddp_run["base"]),
                                       whole)[0]["loss"])
    finally:
        torch.set_num_threads(threads)
    got = ddp_run["ranks"][0]["state_dict"]
    differ = {key: float((got[key] - want).abs().max())
              for key, want in model.state_dict().items()
              if want.dtype.is_floating_point
              and not torch.equal(got[key], want)}
    assert not differ, differ
    (metrics,) = ddp_run["ranks"][0]["metrics"]
    np.testing.assert_allclose(metrics["parity_loss_sharded"],
                               np.mean(evals), rtol=SAME_TOL)
    np.testing.assert_allclose(metrics["parity_loss_global"], joint,
                               rtol=SAME_TOL)


def test_more_ranks_than_cards_raise_unless_gloo(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="gloo"):
        mesh.rank_device(1, 2, "cuda")
    with pytest.raises(RuntimeError, match="gloo"):
        mesh.rank_device(0, 2, "cuda", backend="nccl")
    assert mesh.rank_device(1, 2, "cuda", backend="gloo") == \
        torch.device("cuda", 0)
    assert mesh.rank_device(0, 1, "cuda") == torch.device("cuda", 0)
    assert mesh.rank_device(1, 2, "cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        mesh.rank_device(0, 2, "cpu", backend="nccl")


def cli_options(log_dir, *extra):
    from simplerecon_tpu_torch.options import OptionsHandler
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return OptionsHandler().parse_and_merge_options(cl_args_list=[
        "--config_file", os.path.join(repo, "configs", "models",
                                      "hero_model.yaml"),
        "--dataset", "synthetic", "--single_debug_scan_id", "scene",
        "--image_height", "64", "--image_width", "96",
        "--num_images_in_tuple", "3", "--model_num_views", "3",
        "--matching_num_depth_bins", "8", "--precision", "32",
        "--num_workers", "2", *extra, "--log_dir", str(log_dir)])


def test_train_cli_runs_two_ranks(tmp_path, monkeypatch):
    from simplerecon_tpu_torch.data import synthetic
    from simplerecon_tpu_torch.scripts import train as train_cli
    from simplerecon_tpu_torch.utils import checkpoint as ckpt_lib
    from simplerecon_tpu_torch.utils import cache
    monkeypatch.setattr(synthetic, "DEFAULT_NUM_FRAMES", 6)
    monkeypatch.setattr(cache, "copy_code_state", lambda log_dir: log_dir)
    # no validation: a hero-width full state is ~0.6 GB a write
    opts = cli_options(tmp_path, "--batch_size", "2", "--max_steps", "2",
                       "--log_interval", "1", "--val_interval", "3",
                       "--num_devices", "2")
    state = train_cli.main(opts, device="cpu")
    root = tmp_path / opts.name
    try:
        with open(root / "metrics.jsonl") as f:
            rows = [json.loads(line) for line in f]
        assert [r["step"] for r in rows] == [1, 2]
        assert "train/grad_norm" in rows[0]
        assert all(np.isfinite(v) for r in rows for v in r.values())
        assert sorted(os.listdir(root / "checkpoints")) == ["step_2"]
        assert not [n for n in os.listdir(root) if n.startswith(".ranks")]
        ranks = state.run_stats["ranks"]
        assert [r["steps"] for r in ranks] == [2, 2]
        assert state.step == state.optimizer.count == 2
        # the single-device restore reads the checkpoint the ranks wrote
        fresh = train_cli.new_state(opts, "cpu")
        ckpt_lib.restore_checkpoint(str(root / "checkpoints"), fresh)
        for (name, a), b in zip(fresh.model.state_dict().items(),
                                state.model.state_dict().values()):
            assert torch.equal(a, b), name
    finally:
        shutil.rmtree(root / "checkpoints", ignore_errors=True)
        shutil.rmtree(root / "best", ignore_errors=True)


def test_data_parallel_forward_pads_and_gathers():
    from simplerecon_tpu_torch.scripts.test import make_forward_fn
    model = build_depth_model(OPTS, device="cpu", seed=SEED)
    batch = ttrain.batch_to_device(train_batch(OPTS, 3, seed=SEED), "cpu")
    want = make_forward_fn(model)(batch["cur"], batch["src"])
    calls = []
    forward = model.forward

    def counted(cur, src, **kw):
        calls.append(cur["image_b3hw"].shape[0])
        return forward(cur, src, **kw)

    model.forward = counted
    got = make_forward_fn(model, ["cpu", "cpu"])(batch["cur"], batch["src"])
    assert calls == [2, 2]          # 3 frames padded to 4, a shard a device
    assert list(got) == list(want)
    for key, value in want.items():
        assert got[key].shape == value.shape and got[key].dtype == \
            value.dtype, key
        torch.testing.assert_close(got[key], value, rtol=DP_TOL,
                                   atol=DP_TOL, msg=key)


def test_eval_cli_honours_data_parallel_eval(tmp_path, monkeypatch):
    from simplerecon_tpu_torch.data import synthetic
    from simplerecon_tpu_torch.scripts import test as eval_cli
    from simplerecon_tpu_torch.testing import compare_cached_depths
    monkeypatch.setattr(synthetic, "DEFAULT_NUM_FRAMES", 8)
    outs = {}
    for tag, extra in (("plain", ()), ("dp", ("--data_parallel_eval",))):
        out = tmp_path / tag
        opts = cli_options(tmp_path, "--split", "test", "--batch_size", "3",
                           "--cache_depths", "--output_base_path", str(out),
                           *extra)
        assert opts.data_parallel_eval == (tag == "dp")
        frame_avg, _ = eval_cli.main(opts, device="cpu",
                                     devices=["cpu", "cpu"])
        assert frame_avg.run_stats["frames"] == 6
        outs[tag] = str(out / opts.name / opts.dataset /
                        opts.frame_tuple_type / "depths" / "scene")
    report = compare_cached_depths(outs["dp"], outs["plain"])
    assert report["frames"] == 6 and report["depth_rel"] <= DP_TOL, report
