"""The port's dot-product model against the JAX package, on the CPU in
float32: the dot-product sweep (K1-dot's plain version), its gradient,
`DotProductCostVolume`, the whole model's forward and one training step,
and the weight bridge for a dot-model tree.

Tolerances:
- the volume: rtol/atol 2e-4 against the JAX Pallas kernel
  `banded_warp_dot_volume` in interpret mode and against the JAX XLA
  path (`DotProductCostVolume(backend="xla")`), the tolerance
  tests/test_pallas_cv.py holds the two JAX paths to; `lowest_cost`
  agrees to 1e-5 at 99% of pixels (an argmax: a near-tie may flip);
  the source mask exactly;
- the gradients of the source and reference features against `jax.vjp`
  of the XLA path, through `DotSweep` and, for the reference features,
  through the plain version of K1-dot's d_cur mode alone: rtol 2e-4, atol
  2e-4 x max |ref| (the same float32 sums in another order, over taps
  whose coordinates round differently);
- the model (64x96, k=2, d=8, flip off and on, the JAX sweep kernel in
  interpret mode): max |torch - jax| <= 2% of each map's std, with std
  >= 1e-2 asserted, as tests/test_torch_port_model.py holds the hero
  model;
- the training step: tests/test_torch_port_train.py's tolerances.
The model and the step share one set of weights: the port's seeded init
with its batch norms redrawn and its output heads scaled
(`spread_outputs_`), carried into the JAX tree by the JAX package's own
`convert_state_dict` (a JAX `init` of the whole model would cost ~45 s
of compile on a CPU).
Both sides run the stem pool as `matching_pool_impl="pallas"`: the JAX
package takes its XLA chain off the TPU, the port the plain versions of
K3.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplerecon_tpu.models.cost_volume import \
    DotProductCostVolume as JaxDotProductCostVolume
from simplerecon_tpu.models.depth_model import DepthModel as JaxDepthModel
from simplerecon_tpu.ops import cost_volume as jcv
from simplerecon_tpu.ops import pallas_cv
from simplerecon_tpu_torch.models.cost_volume import DotProductCostVolume
from simplerecon_tpu_torch.models.depth_model import DepthModel
from simplerecon_tpu_torch.ops import cuda_cv
from simplerecon_tpu_torch.ops import pool
from simplerecon_tpu_torch.ops import launch_counts
from simplerecon_tpu_torch.testing import dot_options
from simplerecon_tpu_torch.utils.weights import (jax_to_state_dict,
                                                 load_jax_variables)
from test_pallas_cv import make_inputs as pallas_cv_inputs
from test_torch_port_model import MIN_STD, SIGNAL_FRACTION, make_inputs
from test_torch_port_ops import _t, sweep_geometry
from test_torch_port_ops import few_torch_threads  # noqa: F401 (autouse)
from test_torch_port_train import (assert_step_matches, jax_train_runs,
                                   seeded_slice)

VOLUME_TOL = 2e-4
D, K_SRC = 8, 2
DOT_KW = dict(feature_volume_type="simple_cost_volume",
              matching_pool_impl="pallas")


def _volume_inputs(case):
    """(cur (b,h,w,c), src (b,k,h,w,c), extr, poses, Ks, invK) as numpy
    float32, and the plane count."""
    if case == "pallas_cv_shape":
        return [np.asarray(a) for a in pallas_cv_inputs()], 4
    b, k, h, w, c = 2, 3, 16, 32, 16
    rng = np.random.RandomState(13)
    feats = [rng.randn(b, h, w, c).astype(np.float32),
             rng.randn(b, k, h, w, c).astype(np.float32)]
    return feats + sweep_geometry(b, k, h, w, seed=13, wide=True), 6


def _jax_volume(inputs, d, return_mask=True):
    mod = JaxDotProductCostVolume(num_depth_bins=d, backend="xla",
                                  dtype=jnp.float32)
    with jax.default_matmul_precision("highest"):   # no parameters
        return jax.jit(lambda *a: mod.apply({}, *a,
                                            return_mask=return_mask))(*inputs)


@pytest.mark.parametrize("case", ["pallas_cv_shape", "wide"])
def test_dot_volume_matches_jax(case):
    inputs, d = _volume_inputs(case)
    cur, src, extr, poses, Ks, invK = inputs
    b, h, w, c = cur.shape
    planes = np.asarray(jcv.generate_depth_planes(b, d, 0.25, 5.0))
    with jax.default_matmul_precision("highest"):
        want_kernel = pallas_cv.banded_warp_dot_volume(
            src, cur.reshape(b, h * w, c), extr, Ks, invK, planes,
            compute_dtype=jnp.float32, interpret=True)
    got = cuda_cv.dot_sweep(_t(src), _t(cur.reshape(b, h * w, c)), _t(extr),
                            _t(Ks), _t(invK), _t(planes))
    assert got.shape == (b, d, h * w) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want_kernel),
                               rtol=VOLUME_TOL, atol=VOLUME_TOL)
    assert np.asarray(want_kernel).std() > 1e-2

    vol_j, low_j, planes_j, mask_j = _jax_volume(inputs, d)
    with torch.no_grad():
        vol_t, low_t, planes_t, mask_t = DotProductCostVolume(
            num_depth_bins=d)(*map(_t, inputs), return_mask=True)
    np.testing.assert_allclose(vol_t.numpy(), np.asarray(vol_j),
                               rtol=VOLUME_TOL, atol=VOLUME_TOL)
    lowest = np.abs(low_t.numpy() - np.asarray(low_j))
    assert (lowest <= 1e-5).mean() >= 0.99
    np.testing.assert_allclose(planes_t.numpy(), np.asarray(planes_j),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    if case == "wide":
        # taps fall off the image and one view lies behind some points
        warp = cuda_cv.cv_ops.sweep_warp(_t(src), _t(extr), _t(Ks),
                                         _t(invK), _t(planes))
        assert 0 < warp.mask_bkdN.mean() < 1
        assert 0 < mask_t.float().mean() < 1


@pytest.fixture(scope="module")
def jax_dot_vjp():
    """`jax.vjp` of the JAX XLA dot volume at the "wide" case: (inputs,
    plane count, cotangent g (b, h, w, d), (d_cur, d_src))."""
    inputs, d = _volume_inputs("wide")
    cur, src = inputs[:2]
    b, h, w, _ = cur.shape
    g = np.random.RandomState(14).randn(b, h, w, d).astype(np.float32)
    mod = JaxDotProductCostVolume(num_depth_bins=d, backend="xla",
                                  dtype=jnp.float32)

    def volume(cur_, src_):
        return mod.apply({}, cur_, src_, *inputs[2:])[0]

    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda c_, s_, g_: jax.vjp(volume, c_, s_)[1](g_))(
            cur, src, g)
    return inputs, d, g, [np.asarray(x) for x in want]


def test_dot_sweep_gradient_matches_jax(jax_dot_vjp):
    inputs, d, g, want = jax_dot_vjp
    cur, src = inputs[:2]
    cur_t, src_t = _t(cur).requires_grad_(), _t(src).requires_grad_()
    before = launch_counts()["dot_sweep"]
    vol = DotProductCostVolume(num_depth_bins=d)(cur_t, src_t,
                                                 *map(_t, inputs[2:]))[0]
    vol.backward(_t(g))
    assert launch_counts()["dot_sweep"] == before     # the plain version
    for got, ref in ((cur_t.grad, want[0]), (src_t.grad, want[1])):
        assert np.abs(ref).max() > 1e-2
        np.testing.assert_allclose(got.numpy(), ref, rtol=VOLUME_TOL,
                                   atol=VOLUME_TOL * np.abs(ref).max())


def test_dot_dcur_reference_matches_jax(jax_dot_vjp):
    """K1-dot's d_cur mode has its own plain version, which the CPU runs:
    the reference features' gradient alone, held to `jax.vjp`'s at the
    tolerance above (the same float32 sums in another order)."""
    inputs, d, g, want = jax_dot_vjp
    cur, src, extr, _, Ks, invK = inputs
    b, h, w, c = cur.shape
    planes = cuda_cv.cv_ops.generate_depth_planes(b, d, 0.25, 5.0, "cpu")
    g_bdN = _t(g.reshape(b, h * w, d).transpose(0, 2, 1))
    args = (_t(src), _t(extr), _t(Ks), _t(invK), planes, g_bdN)
    got = cuda_cv.dot_sweep_dcur_reference(*args)
    assert got.shape == (b, h * w, c) and got.dtype == torch.float32
    ref = want[0].reshape(b, h * w, c)
    assert np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(got.numpy(), ref, rtol=VOLUME_TOL,
                               atol=VOLUME_TOL * np.abs(ref).max())
    before = launch_counts()["dot_sweep_dcur"]
    assert torch.equal(cuda_cv.dot_sweep_dcur(*args), got)
    assert launch_counts()["dot_sweep_dcur"] == before   # the plain version


def test_dot_sweep_function_gives_geometry_no_gradient():
    inputs, d = _volume_inputs("pallas_cv_shape")
    cur, src, extr, _, Ks, invK = inputs
    b, h, w, c = cur.shape
    planes = np.asarray(jcv.generate_depth_planes(b, d, 0.25, 5.0))
    args = [_t(a).requires_grad_() for a in (
        src, cur.reshape(b, h * w, c), extr, Ks, invK, planes)]
    cuda_cv.DotSweep.apply(*args).square().sum().backward()
    assert args[0].grad is not None and args[1].grad is not None
    assert all(a.grad is None for a in args[2:])
    with pytest.raises(ValueError):
        cuda_cv.dot_sweep(*[a.detach().to("meta") for a in args])


# --------------------------------------------------------------------------
# the whole dot-product model
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dot_slice():
    """The port's seeded dot model (batch norms redrawn, heads scaled),
    its weights as a JAX tree, and a training batch."""
    opts = dot_options(image_height=64, image_width=96,
                       matching_num_depth_bins=D, model_num_views=K_SRC + 1,
                       precision="32")
    base, params, stats, batch = seeded_slice(opts, seed=30)
    assert type(base.cost_volume).__name__ == "DotProductCostVolume"
    assert base.matching_model.net[3].impl == "pallas"
    return base, params, stats, batch


def _jax_dot_model(backend):
    return JaxDepthModel(image_height=64, image_width=96,
                         matching_num_depth_bins=D, model_num_views=K_SRC + 1,
                         cost_volume_backend=backend, dtype=jnp.float32,
                         **DOT_KW)


@pytest.fixture(scope="module")
def jax_dot_outputs(dot_slice):
    """The JAX dot model's outputs for both flips, on the same weights,
    with its sweep kernel in interpret mode; one compiled forward serves
    both flips."""
    _, params, stats, _ = dot_slice
    cur, src = make_inputs()
    model = _jax_dot_model("pallas_interpret")
    variables = {"params": params, "batch_stats": stats}
    with jax.default_matmul_precision("highest"):
        forward = jax.jit(lambda v, c, s, flip: model.apply(
            v, c, s, flip=flip, train=False, return_mask=True,
            capture_intermediates=lambda mdl, _: mdl.name == "cost_volume",
            mutable=["intermediates"]))
        runs = {flip: forward(variables, cur, src, jnp.asarray(flip))
                for flip in (False, True)}
    outputs = {}
    for flip, (out, state) in runs.items():
        volume = state["intermediates"]["cost_volume"]["__call__"][0][0]
        outputs[flip] = {k: np.asarray(v) for k, v in out.items()
                         if v is not None}
        outputs[flip]["cost_volume_bhwd"] = np.asarray(volume)
    return cur, src, outputs


def test_dot_bridge_round_trips_through_convert_state_dict(dot_slice):
    """The port's state_dict -> the JAX package's `convert_state_dict` ->
    `jax_to_state_dict` gives it back, and loads strictly into a fresh
    dot model (test_torch_port_pool.py loads a tree into both pool
    forms)."""
    base, params, stats, _ = dot_slice
    assert "cost_volume" not in params
    sd = jax_to_state_dict(params, stats)
    want = base.state_dict()
    assert sorted(sd) == sorted(want)
    assert not [k for k in sd if k.startswith("cost_volume.")]
    for key, value in sd.items():
        np.testing.assert_array_equal(np.asarray(value), want[key].numpy(),
                                      err_msg=key)
    load_jax_variables(DepthModel(matching_num_depth_bins=D,
                                  model_num_views=K_SRC + 1, **DOT_KW),
                       {"params": params, "batch_stats": stats})


@pytest.mark.parametrize("flip", [False, True], ids=["plain", "flip"])
def test_dot_model_matches_jax(dot_slice, jax_dot_outputs, flip):
    cur, src, outputs = jax_dot_outputs
    want = outputs[flip]
    model = copy.deepcopy(dot_slice[0]).eval()
    captured = {}
    model.cost_volume.register_forward_hook(
        lambda mod, args, out: captured.update(volume=out[0]))
    to_t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    before = (launch_counts()["dot_sweep"], launch_counts()["max_blur_pool"])
    with torch.no_grad():
        got = model(to_t(cur), to_t(src), flip=flip, return_mask=True)
    assert (launch_counts()["dot_sweep"],
            launch_counts()["max_blur_pool"]) == before   # plain versions
    got = {k: v.numpy() for k, v in got.items()}
    got["cost_volume_bhwd"] = captured["volume"].numpy()

    assert sorted(got) == sorted(want)
    for key in ["cost_volume_bhwd"] + [f"log_depth_pred_s{i}_bhw1"
                                       for i in range(4)]:
        ref = want[key]
        assert got[key].shape == ref.shape, key
        std = ref.std()
        assert std >= MIN_STD, (key, std)
        err = np.abs(got[key] - ref).max()
        assert err <= SIGNAL_FRACTION * std, (key, err, std)
    np.testing.assert_array_equal(got["overall_mask_bhw"],
                                  want["overall_mask_bhw"])
    lowest = np.abs(got["lowest_cost_bhw"] - want["lowest_cost_bhw"])
    assert (lowest <= 1e-5).mean() >= 0.99


# --------------------------------------------------------------------------
# one training step
# --------------------------------------------------------------------------

def test_dot_train_step_matches_jax(dot_slice):
    """One training step with the flip (the flip path is the one with
    more to get wrong), against `jax.grad` of the JAX step through its
    XLA warp, the JAX package's training path for the dot model."""
    base, params, stats, batch = dot_slice
    runs = jax_train_runs(_jax_dot_model("xla_fused"), params, stats, batch,
                          flips=(True,))
    assert_step_matches(base, params, stats, batch, runs[True], True)
