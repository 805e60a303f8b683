"""The port's UNet matching encoder (`matching_encoder_type="unet_encoder"`:
mnasnet_100 and the top-down path of an FPN) against the JAX package's,
on the CPU in float32: the encoder alone in eval and train mode, the
running statistics a train-mode pass leaves, the whole hero model with
this encoder, and the weight bridge.

Variables are drawn with numpy at the JAX module's shapes, every batch
norm redrawn (`test_torch_port_modules.random_variables`), and bridged
into the port; inputs are numpy arrays from a seed. Sizes: 64x96, whose
FPN levels double exactly, and 80x112, whose stride-32 level (3x4) goes
to 5x7 through `jax.image.resize`'s nearest neighbour, which decides how
the port picks its source pixels.

Tolerances: the encoder's features and running statistics within
`REL_TOL` * (1 + max |jax|), as in `test_torch_port_modules.py`; the
hero model's cost volume and log-depth maps within 2% of the reference
map's standard deviation, as the ResNet model's in
`test_torch_port_model.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplerecon_tpu.models.depth_model import DepthModel as JaxDepthModel
from simplerecon_tpu.models.matching_encoder import \
    UNetMatchingEncoder as JaxUNetMatchingEncoder
from simplerecon_tpu.utils.convert_reference_checkpoint import \
    convert_state_dict
from simplerecon_tpu_torch.models.depth_model import (DepthModel,
                                                      build_depth_model)
from simplerecon_tpu_torch.models.matching_encoder import (
    UNetMatchingEncoder, upsample_nearest_to)
from simplerecon_tpu_torch.testing import hero_options, spread_outputs_
from simplerecon_tpu_torch.utils.weights import (jax_to_state_dict,
                                                 load_jax_variables)
from test_torch_port_model import make_inputs
from test_torch_port_modules import (REL_TOL, assert_close, bridged, nchw,
                                     random_variables)
from test_torch_port_ops import few_torch_threads  # noqa: F401 (autouse)

SIZES = [(64, 96), (80, 112)]
B, K_SRC, H, W, D = 1, 2, 64, 96, 8
SIGNAL_FRACTION = 0.02
MIN_STD = 1e-2


def encoder_case(size, train):
    """The JAX encoder's variables, input, output and (train mode) its
    updated batch statistics."""
    h, w = size
    x = np.random.RandomState(h).randn(2, h, w, 3).astype(np.float32)
    module = JaxUNetMatchingEncoder(num_ch_out=16)
    variables = random_variables(module, (x,), h)
    with jax.default_matmul_precision("highest"):
        if train:
            out, new = jax.jit(lambda v, x: module.apply(
                v, x, train=True, mutable=["batch_stats"]))(variables, x)
            stats = jax.tree_util.tree_map(np.asarray, new["batch_stats"])
        else:
            out = jax.jit(lambda v, x: module.apply(v, x, train=False))(
                variables, x)
            stats = None
    return variables, x, np.asarray(out), stats


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_unet_encoder_matches_jax_in_eval_mode(size):
    variables, x, want, _ = encoder_case(size, train=False)
    tm = bridged(UNetMatchingEncoder(num_ch_out=16), "matching_model",
                 variables)
    with torch.no_grad():
        assert_close(tm(nchw(x)), want)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_unet_encoder_train_mode_and_running_statistics(size):
    """A train-mode pass normalises with the batch's statistics and
    leaves the running statistics JAX's `mutable=["batch_stats"]`
    pass gives."""
    variables, x, want, new_stats = encoder_case(size, train=True)
    tm = bridged(UNetMatchingEncoder(num_ch_out=16), "matching_model",
                 variables).train()
    with torch.no_grad():
        assert_close(tm(nchw(x)), want)
    want_sd = jax_to_state_dict({"matching_model": variables["params"]},
                                {"matching_model": new_stats})
    got_sd = tm.state_dict()
    keys = [k for k in want_sd if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * sum(1 for k in got_sd
                                if k.endswith("running_mean"))
    moved = 0
    for key in keys:
        want_v = want_sd[key]
        got_v = got_sd[key.removeprefix("matching_model.")].numpy()
        np.testing.assert_allclose(got_v, want_v, rtol=0, err_msg=key,
                                   atol=REL_TOL * (1 + np.abs(want_v).max()))
        old = jax_to_state_dict(
            {"matching_model": variables["params"]},
            {"matching_model": variables["batch_stats"]})[key]
        moved += not np.array_equal(old, want_v)
    assert moved == len(keys)


def test_upsample_picks_jax_nearest_pixels():
    """`upsample_nearest_to` takes the source pixels
    `jax.image.resize(..., "nearest")` takes, at every FPN size pair
    (n = 2m - 1 or 2m) up to m = 12, at pairs where floor((i + 0.5) * m
    / n) rounded once picks others (m = 42, 80, 90, 96, 106, 150) and
    where torch's "nearest-exact" does (m = 50, 58, 92)."""
    pairs = [(m, n) for m in range(1, 13) for n in (2 * m - 1, 2 * m)
             ] + [(m, 2 * m - 1) for m in (42, 50, 58, 80, 90, 92, 96, 106,
                                           150)]
    for m, n in pairs:
        x = np.arange(m, dtype=np.float32)
        want = np.asarray(jax.image.resize(jnp.asarray(x)[:, None],
                                           (n, 1), "nearest"))[:, 0]
        got = upsample_nearest_to(torch.from_numpy(x)[None, None, :, None],
                                  (n, 1))[0, 0, :, 0].numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"{m} -> {n}")


OPTS = hero_options(image_height=H, image_width=W, matching_num_depth_bins=D,
                    model_num_views=K_SRC + 1, precision="32",
                    matching_encoder_type="unet_encoder")


@pytest.fixture(scope="module")
def jax_run():
    """JAX variables (numpy) of the UNet hero model and the outputs of one
    forward with and without flip, as `test_torch_port_model.jax_run`."""
    cur, src = make_inputs()
    base = spread_outputs_(build_depth_model(OPTS, device="cpu", seed=13),
                           seed=13)
    params, stats, _ = convert_state_dict(
        {k: v.numpy() for k, v in base.state_dict().items()})
    variables = {"params": params, "batch_stats": stats}
    model = JaxDepthModel(image_height=H, image_width=W,
                          matching_num_depth_bins=D, model_num_views=K_SRC + 1,
                          matching_encoder_type="unet_encoder",
                          cost_volume_backend="pallas_interpret",
                          dtype=jnp.float32)
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
    return base, variables, cur, src, outputs


def unet_model():
    return DepthModel(matching_num_depth_bins=D, model_num_views=K_SRC + 1,
                      matching_encoder_type="unet_encoder")


@pytest.mark.parametrize("flip", [False, True], ids=["plain", "flip"])
def test_unet_depth_model_matches_jax(jax_run, flip):
    _, variables, cur, src, outputs = jax_run
    want = outputs[flip]
    model = load_jax_variables(unet_model(), variables).eval()
    captured = {}
    model.cost_volume.register_forward_hook(
        lambda mod, args, out: captured.update(volume=out[0]))
    to_t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    with torch.no_grad():
        got = model(to_t(cur), to_t(src), flip=flip, return_mask=True)
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


def flat(tree):
    return {"/".join(str(p.key) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def test_unet_bridge_round_trips_through_convert_state_dict(jax_run):
    """The JAX tree -> the port's state dict -> `convert_state_dict` gives
    the tree back with no key left over, and the port loads it
    strictly."""
    base, variables = jax_run[:2]
    sd = jax_to_state_dict(variables["params"], variables["batch_stats"])
    assert sorted(sd) == sorted(base.state_dict())
    params, stats, report = convert_state_dict(sd)
    assert [k for k in report["skipped"]
            if not k.endswith("num_batches_tracked")] == []
    for got, want in ((params, variables["params"]),
                      (stats, variables["batch_stats"])):
        got, want = flat(got), flat(want)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    load_jax_variables(unet_model(), variables)


def test_reference_state_dict_with_unused_fpn_levels_loads(jax_run):
    """A reference-keyed state dict carries the FPN's unused levels
    (`inner_blocks.0`, `layer_blocks.{0,2,3,4}`): the port drops them on a
    strict load, as `convert_state_dict` skips them."""
    base = jax_run[0]
    sd = {k: v.clone() for k, v in base.state_dict().items()}
    dec = "matching_model.decoder"
    unused = {f"{dec}.inner_blocks.0.weight": torch.ones(32, 16, 1, 1),
              f"{dec}.inner_blocks.0.bias": torch.ones(32)}
    for i in (0, 2, 3, 4):
        unused[f"{dec}.layer_blocks.{i}.weight"] = torch.ones(32, 32, 3, 3)
        unused[f"{dec}.layer_blocks.{i}.bias"] = torch.ones(32)
    model = unet_model()
    model.load_state_dict({**sd, **unused}, strict=True)
    for key, value in model.state_dict().items():
        torch.testing.assert_close(value, sd[key], rtol=0, atol=0)
    _, _, report = convert_state_dict(
        {k: v.numpy() for k, v in {**sd, **unused}.items()})
    assert set(unused) <= set(report["skipped"])


def test_unknown_matching_encoder_type_raises():
    with pytest.raises(ValueError, match="matching_encoder_type"):
        build_depth_model(hero_options(image_height=H, image_width=W,
                                       matching_encoder_type="vgg"),
                          device="cpu")


def test_unet_train_step_updates_every_parameter():
    """One training step of the UNet hero model on the CPU: a finite loss,
    every parameter updated, every batch norm's running statistics
    moved."""
    from simplerecon_tpu_torch.parallel import train
    from simplerecon_tpu_torch.testing import train_batch
    model = build_depth_model(OPTS, device="cpu", seed=14)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    optimizer = train.make_optimizer(OPTS, model)
    metrics = train.train_step(
        model, optimizer, train.batch_to_device(train_batch(OPTS, 2, seed=15),
                                                "cpu"),
        torch.Generator().manual_seed(0))
    assert torch.isfinite(metrics["loss"]) and optimizer.count == 1
    after = model.state_dict()
    same = [k for k, v in after.items()
            if not k.endswith("num_batches_tracked")
            and torch.equal(v, before[k])]
    assert same == [], same
