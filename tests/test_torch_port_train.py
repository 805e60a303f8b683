"""The port's training step against the JAX package, on the CPU in
float32.

Train-mode BatchNorm: the matching encoder in train mode against flax's
(`mutable=["batch_stats"]`): output and the updated running statistics
at 1e-4 x (1 + max |ref|), float32 rounding of the same convolutions
summed in another order.

The whole slice: one training step at 64x96, k=2 source views, d=8
planes, batch 2, flip False and True, on the same weights (the port's
seeded init with its batch norms redrawn, carried into the JAX tree by
the JAX package's own `convert_state_dict`) and the same numpy batch
(`testing.train_batch`: smooth GT depth with NaN holes). The JAX side is
`parallel/train.py::_forward_and_losses` under `jax.grad`, with the
fused sweep's forward and backward Pallas kernels in interpret mode
(`cost_volume_custom_vjp="pallas_bwd"`). Tolerances:
- every loss term: rtol 1e-4 (float32 through ~100 layers, two orders);
- the gradients: over all parameters ||Δ|| <= 5e-3 ||ref|| (the JAX
  package's own aggregate check, tests/test_train_parallel.py, with its
  1e-3 widened), with ||ref|| > 0 asserted; and per parameter
  ||Δ|| <= 2e-2 ||ref leaf||, for every leaf above 1e-5 of the largest
  gradient (below that a leaf is zero up to rounding: a bias that feeds
  a train-mode batch norm, which removes it). Measured: 1.2e-3 and
  3.0e-4 in aggregate, 6.6e-3 and 2.5e-3 for the worst leaf (plain,
  flip). The widening is float32 itself: the port alone, in float32
  against float64 on these inputs, differs by 1.5e-3 in aggregate and
  3.6e-3 for its worst leaf, through train-mode batch norms over a few
  pixels at the deepest stages and leaky-ReLU slopes that flip on a
  last bit;
- the running statistics after the step: 1e-4 x (1 + max |ref|);
- AdamW: the port's optimizer and optax's `make_optimizer`, fed the same
  (JAX) gradients, give the same parameters to rtol 1e-6 (one update,
  the same formula in another order);
- a batch with a NaN image leaves parameters and optimizer state
  unchanged (optax's `apply_if_finite`);
- three consecutive steps at lr 1e-4 (AdamW from the same weights and
  batch, optax on the JAX side): the loss at step t within
  LOSS_RTOL * STEP_WIDENING**t of JAX's, a factor of 30 a step. Measured
  4.3e-7, 1.6e-4 and 2.2e-2 (steps 0-2; 1.9e-2 at step 3). That is the
  size of float32 itself: Adam's first update moves each weight by about
  lr * sign(grad), and a gradient near zero takes either sign, so
  scaling the input images by (1 + 2^-23) moves JAX's own loss by 1.2e-4
  and 1.3e-2 at steps 1 and 2, and the port's by 2.3e-4 and 1.5e-2.
  The same steps with `matching_norm="group"` (the same weights, the
  matching encoder's norms GroupNorm-8), at the same tolerance:
  measured 5.6e-7, 1.1e-4 and 9.9e-4.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from simplerecon_tpu.models.depth_model import DepthModel as JaxDepthModel
from simplerecon_tpu.models.matching_encoder import \
    ResnetMatchingEncoder as JaxMatchingEncoder
from simplerecon_tpu.parallel import train as jtrain
from simplerecon_tpu.utils.convert_reference_checkpoint import \
    convert_state_dict
from simplerecon_tpu_torch.models.depth_model import build_depth_model
from simplerecon_tpu_torch.models.matching_encoder import \
    ResnetMatchingEncoder
from simplerecon_tpu_torch.parallel import train as ttrain
from simplerecon_tpu_torch.testing import (hero_options, spread_outputs_,
                                           train_batch)
from simplerecon_tpu_torch.utils.weights import (jax_to_state_dict,
                                                 load_jax_variables)
from test_torch_port_modules import bridged, nchw, randomize_bn
from test_torch_port_ops import few_torch_threads  # noqa: F401 (autouse)

OPTS = hero_options(image_height=64, image_width=96,
                    matching_num_depth_bins=8, model_num_views=3,
                    precision="32")
BATCH = 2
LOSS_RTOL = 1e-4
GRAD_AGG_TOL = 5e-3
GRAD_LEAF_TOL = 2e-2
GRAD_FLOOR = 1e-5
STATS_TOL = 1e-4
STEP_WIDENING = 30


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _state_dict_of(params, stats):
    return {k: np.asarray(v) for k, v in jax_to_state_dict(
        _numpy_tree(params), _numpy_tree(stats)).items()}


# --------------------------------------------------------------------------
# train-mode BatchNorm
# --------------------------------------------------------------------------

def test_train_mode_batch_norm_matches_flax():
    x = np.random.RandomState(4).randn(3, 32, 48, 3).astype(np.float32)
    jmod = JaxMatchingEncoder(num_ch_out=16)
    with jax.default_matmul_precision("highest"):
        variables = randomize_bn(jax.jit(lambda v: jmod.init(
            jax.random.PRNGKey(4), v, train=False))(x), seed=4)
        want, mutated = jax.jit(lambda v, y: jmod.apply(
            v, y, train=True, mutable=["batch_stats"]))(variables, x)
    tmod = bridged(ResnetMatchingEncoder(num_ch_out=16), "matching_model",
                   variables).train()
    got = tmod(nchw(x))
    ref = np.asarray(want).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0,
                               atol=STATS_TOL * (1 + np.abs(ref).max()))

    new_sd = _state_dict_of({"matching_model": variables["params"]},
                            {"matching_model": mutated["batch_stats"]})
    old_sd = _state_dict_of({"matching_model": variables["params"]},
                            {"matching_model": variables["batch_stats"]})
    port_sd = tmod.state_dict()
    checked = 0
    for key, want_stat in new_sd.items():
        if not key.endswith(("running_mean", "running_var")):
            continue
        name = key.removeprefix("matching_model.")
        assert not np.allclose(want_stat, old_sd[key]), key  # it moved
        np.testing.assert_allclose(
            port_sd[name].numpy(), want_stat, rtol=0,
            atol=STATS_TOL * (1 + np.abs(want_stat).max()), err_msg=key)
        checked += 1
    assert checked == 2 * 5   # net.1 and the four bn of layer1


# --------------------------------------------------------------------------
# the whole slice
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def slice_run():
    """The port's initial model, the numpy batch, the JAX step's outputs
    for both flips, {flip: (losses, grads, new batch_stats)}, and its
    compiled gradient."""
    base, params, stats, batch = seeded_slice(OPTS, seed=20)
    jmodel = JaxDepthModel(
        image_height=OPTS.image_height, image_width=OPTS.image_width,
        matching_num_depth_bins=OPTS.matching_num_depth_bins,
        model_num_views=OPTS.model_num_views,
        cost_volume_backend="xla_fused",
        cost_volume_custom_vjp="pallas_bwd", dtype=jnp.float32)
    grad_fn = jax_grad_fn(jmodel)
    return base, params, stats, batch, jax_train_runs(
        jmodel, params, stats, batch, grad_fn=grad_fn), grad_fn


def seeded_slice(opts, seed: int) -> tuple:
    """The port's seeded model with its batch norms redrawn, the same
    weights as a JAX tree (the JAX package's own `convert_state_dict`),
    and a numpy batch: (base, params, batch_stats, batch)."""
    base = spread_outputs_(build_depth_model(opts, device="cpu", seed=seed),
                           seed=seed)
    params, stats, report = convert_state_dict(
        {k: v.numpy() for k, v in base.state_dict().items()})
    assert not [k for k in report["skipped"]
                if not k.endswith((".filt", "num_batches_tracked"))]
    return base, params, stats, train_batch(opts, BATCH, seed=seed + 1)


def jax_grad_fn(jmodel):
    """The JAX step's gradient, compiled: (params, batch_stats, batch,
    flip) -> (grads, (losses, new batch_stats))."""
    def loss_fn(p, s, b, flip):
        losses, _, new_stats = jtrain._forward_and_losses(
            jmodel, p, s, b, flip, train=True)
        return losses["loss"], (losses, new_stats)

    return jax.jit(jax.grad(loss_fn, has_aux=True))


def jax_train_runs(jmodel, params, stats, batch, flips=(False, True),
                   grad_fn=None) -> dict:
    """The JAX step's outputs for each of `flips`, as numpy: {flip:
    (losses, grads, new batch_stats)}. One compiled gradient (`grad_fn`,
    by default `jax_grad_fn(jmodel)`) serves both flips."""
    grad_fn = grad_fn or jax_grad_fn(jmodel)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    runs = {}
    with jax.default_matmul_precision("highest"):
        for flip in flips:
            grads, (losses, new_stats) = grad_fn(params, stats, jbatch,
                                                 jnp.asarray(flip))
            runs[flip] = (_numpy_tree(losses), _numpy_tree(grads),
                          _numpy_tree(new_stats))
    return runs


def assert_step_matches(base, params, stats, batch, run, flip):
    """One port training-mode forward and backward of `base` (a copy) on
    `batch` against the JAX step's `run` = (losses, grads, new stats)."""
    want_losses, want_grads, want_stats = run
    model = copy.deepcopy(base).train()
    losses, _ = ttrain.forward_and_losses(
        model, ttrain.batch_to_device(batch, "cpu"), flip)
    losses["loss"].backward()

    assert sorted(losses) == sorted(want_losses) and len(losses) == 9
    for key, want in want_losses.items():
        np.testing.assert_allclose(float(losses[key].detach()), float(want),
                                   rtol=LOSS_RTOL, err_msg=key)

    grad_sd = _state_dict_of(want_grads, stats)
    named = dict(model.named_parameters())
    assert len(named) == len(jax.tree_util.tree_leaves(want_grads))
    got = {n: p.grad.numpy().astype(np.float64) for n, p in named.items()}
    want = {n: grad_sd[n].astype(np.float64) for n in named}
    ref_norm = np.sqrt(sum(np.sum(w ** 2) for w in want.values()))
    assert ref_norm > 0
    dist = np.sqrt(sum(np.sum((got[n] - want[n]) ** 2) for n in named))
    assert dist <= GRAD_AGG_TOL * ref_norm, dist / ref_norm
    floor = GRAD_FLOOR * max(np.abs(w).max() for w in want.values())
    bad = []
    for name in named:
        if np.abs(want[name]).max() <= floor:
            continue
        rel = (np.linalg.norm(got[name] - want[name])
               / np.linalg.norm(want[name]))
        if rel > GRAD_LEAF_TOL:
            bad.append((name, rel))
    assert not bad, bad

    stats_sd = _state_dict_of(params, want_stats)
    port_sd = model.state_dict()
    for key, want in stats_sd.items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(
                port_sd[key].numpy(), want, rtol=0,
                atol=STATS_TOL * (1 + np.abs(want).max()), err_msg=key)


@pytest.mark.parametrize("flip", [False, True], ids=["plain", "flip"])
def test_train_step_matches_jax(slice_run, flip):
    base, params, stats, batch, runs, _ = slice_run
    assert_step_matches(base, params, stats, batch, runs[flip], flip)


def test_adamw_update_matches_optax(slice_run):
    """optax runs on the parameters and gradients flattened into one
    vector: AdamW, its schedule and the finite check are elementwise or
    global, so that is the same update as on the tree, in one array op
    (the tree form costs ~30 s of eager op dispatch on a CPU)."""
    base, _, stats, _, runs, _ = slice_run
    model = copy.deepcopy(base)
    grad_sd = _state_dict_of(runs[False][1], stats)
    names = [name for name, _ in model.named_parameters()]
    p_vec = np.concatenate([p.detach().numpy().ravel()
                            for p in model.parameters()])
    g_vec = np.concatenate([grad_sd[name].ravel() for name in names])
    tx = jtrain.make_optimizer(OPTS)
    updates, _ = tx.update(g_vec, tx.init(p_vec), p_vec)
    want = np.asarray(optax.apply_updates(p_vec, updates))

    optimizer = ttrain.make_optimizer(OPTS, model)
    for name, p in model.named_parameters():
        p.grad = torch.from_numpy(grad_sd[name].copy())
    optimizer.step()
    assert optimizer.count == 1
    got = np.concatenate([p.detach().numpy().ravel()
                          for p in model.parameters()])
    assert np.abs(got - p_vec).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(leaf).ravel()
                           for leaf in jax.tree_util.tree_leaves(tree)])


@pytest.fixture(scope="module")
def group_slice_run(slice_run):
    """`slice_run` with `matching_norm="group"`: its weights, the matching
    encoder's batch norms becoming GroupNorm-8 with their scale and bias
    (and no running statistics), its batch, and the JAX step (flip
    False) and compiled gradient of that model."""
    _, params, stats, batch, _, _ = slice_run
    stats = {k: v for k, v in stats.items() if k != "matching_model"}
    jmodel = JaxDepthModel(
        image_height=OPTS.image_height, image_width=OPTS.image_width,
        matching_num_depth_bins=OPTS.matching_num_depth_bins,
        model_num_views=OPTS.model_num_views, matching_norm="group",
        cost_volume_backend="xla_fused",
        cost_volume_custom_vjp="pallas_bwd", dtype=jnp.float32)
    grad_fn = jax_grad_fn(jmodel)
    runs = jax_train_runs(jmodel, params, stats, batch, flips=(False,),
                          grad_fn=grad_fn)
    opts = copy.copy(OPTS)
    opts.matching_norm = "group"
    base = load_jax_variables(build_depth_model(opts, device="cpu"),
                              {"params": _numpy_tree(params),
                               "batch_stats": _numpy_tree(stats)})
    assert isinstance(base.matching_model.net[1], torch.nn.GroupNorm)
    return base, params, stats, batch, runs, grad_fn


@pytest.mark.parametrize("norm", ["batch", "group"])
def test_consecutive_steps_follow_jax(norm, request):
    """The losses of three AdamW steps (flip False), with the matching
    encoder's batch norms and with its group norms (`matching_norm`),
    at the same tolerance. The JAX side starts from the fixture's first
    step and updates the parameters flattened into one vector with
    optax, as `test_adamw_update_matches_optax` does; the port runs
    `forward_and_losses` and its optimizer."""
    base, params, stats, batch, runs, grad_fn = request.getfixturevalue(
        "slice_run" if norm == "batch" else "group_slice_run")
    leaves, treedef = jax.tree_util.tree_flatten(params)
    shapes = [np.shape(leaf) for leaf in leaves]
    tx = jtrain.make_optimizer(OPTS)
    p_vec = _flat(params)
    state = tx.init(p_vec)
    losses, grads, new_stats = runs[False]
    want = [float(losses["loss"])]
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    with jax.default_matmul_precision("highest"):
        for _ in range(2):
            updates, state = tx.update(_flat(grads), state, p_vec)
            p_vec = np.asarray(optax.apply_updates(p_vec, updates))
            parts = np.split(p_vec, np.cumsum(
                [int(np.prod(shape)) for shape in shapes])[:-1])
            p_tree = jax.tree_util.tree_unflatten(
                treedef, [v.reshape(shape) for v, shape in zip(parts, shapes)])
            grads, (losses, new_stats) = grad_fn(p_tree, new_stats, jbatch,
                                                 jnp.asarray(False))
            want.append(float(losses["loss"]))

    model = copy.deepcopy(base).train()
    optimizer = ttrain.make_optimizer(OPTS, model)
    tbatch = ttrain.batch_to_device(batch, "cpu")
    got = []
    for step in range(3):
        optimizer.zero_grad()
        loss = ttrain.forward_and_losses(model, tbatch, False)[0]["loss"]
        got.append(float(loss.detach()))
        if step < 2:
            loss.backward()
            optimizer.step()
    assert optimizer.count == 2
    for step, (g, w) in enumerate(zip(got, want)):
        assert abs(g - w) <= LOSS_RTOL * STEP_WIDENING ** step * abs(w), (
            step, got, want)


def test_non_finite_batch_is_skipped(slice_run):
    base, _, _, batch, _, _ = slice_run
    bad = copy.deepcopy(batch)
    bad["cur"]["image_b3hw"][0, 0, 0, 0] = np.nan
    model = copy.deepcopy(base)
    optimizer = ttrain.make_optimizer(OPTS, model)
    before = {k: v.clone() for k, v in model.named_parameters()}
    metrics = ttrain.train_step(model, optimizer,
                                ttrain.batch_to_device(bad, "cpu"),
                                torch.Generator().manual_seed(0))
    assert not torch.isfinite(metrics["grad_norm"])
    assert optimizer.count == 0 and optimizer.total_errors == 1
    assert not optimizer.inner.state          # no moments were made
    for name, p in model.named_parameters():
        torch.testing.assert_close(p.detach(), before[name], rtol=0, atol=0)


def test_lr_schedule_counts_as_optax():
    sched = ttrain.make_lr_schedule(OPTS)
    jsched = jtrain.make_lr_schedule(OPTS)
    for count in (0, 1, 69999, 70000, 70001, 79999, 80000, 123456):
        assert np.isclose(sched(count), float(jsched(count)), rtol=1e-6)
