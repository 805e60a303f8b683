"""The port's whole hero slice against the JAX DepthModel, and the weight
bridge round trip, on the CPU in float32.

Both packages run the forward, with and without flip, at 64x96 with
k=2 source views and d=8 planes, on the same numpy inputs and the same
weights: the port's seeded init with its batch norms redrawn and its
four output heads scaled by 2 (`testing.spread_outputs_`), carried into
the JAX tree by the JAX package's own `convert_state_dict` and bridged
back into the port. JAX uses its Pallas sweep kernel (K1's) in interpret
mode; the port uses the plain version of its sweep, for each of the hero
model's three backends: the fused sweep (K1), "pallas_v1" (warp, then
K5) and "pallas_full" (K4). `lowest_cost` is an argmax over planes, so
it must agree to 1e-5 at 99% of pixels (a near-tie may flip).

Tolerance: for the cost volume and each of the 4 log-depth maps,
max |torch - jax| <= 2% of the reference map's standard deviation. At
random init the log-depth maps are near constant (std ~2e-3), where an
absolute tolerance passes whatever the port computes, so the test also
asserts that each compared reference has std >= 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplerecon_tpu.models.depth_model import DepthModel as JaxDepthModel
from simplerecon_tpu.utils.convert_reference_checkpoint import \
    convert_state_dict
from simplerecon_tpu_torch.models.depth_model import (DepthModel,
                                                      build_depth_model)
from simplerecon_tpu_torch.testing import hero_options, spread_outputs_
from simplerecon_tpu_torch.utils.weights import (jax_to_state_dict,
                                                 load_jax_variables)
from test_torch_port_ops import few_torch_threads  # noqa: F401 (autouse)
from test_torch_port_ops import sweep_geometry

B, K_SRC, H, W, D = 1, 2, 64, 96, 8
OPTS = hero_options(image_height=H, image_width=W, matching_num_depth_bins=D,
                    model_num_views=K_SRC + 1, precision="32")
SIGNAL_FRACTION = 0.02
MIN_STD = 1e-2


def make_inputs():
    rng = np.random.RandomState(11)
    extr, poses, Ks, invK = sweep_geometry(B, K_SRC, H // 4, W // 4, seed=11)
    world_T_cur = np.eye(4, dtype=np.float32)[None]
    world_T_cur[0, :3, 3] = (0.1, -0.05, 0.2)
    # extr = src_cam_T_cur_cam, so world_T_src = world_T_cur @ inv(extr)
    world_T_src = (world_T_cur[:, None] @ poses).astype(np.float32)
    cur = {"image_b3hw": rng.randn(B, 3, H, W).astype(np.float32),
           "invK_s1_b44": invK,
           "cam_T_world_b44": np.linalg.inv(world_T_cur).astype(np.float32),
           "world_T_cam_b44": world_T_cur}
    src = {"image_b3hw": rng.randn(B, K_SRC, 3, H, W).astype(np.float32),
           "K_s1_b44": Ks,
           "cam_T_world_b44": np.linalg.inv(world_T_src).astype(np.float32),
           "world_T_cam_b44": world_T_src}
    return cur, src


@pytest.fixture(scope="module")
def jax_run():
    """JAX variables (numpy) and outputs of one forward."""
    cur, src = make_inputs()
    base = spread_outputs_(build_depth_model(OPTS, device="cpu", seed=12),
                           seed=12)
    params, stats, _ = convert_state_dict(
        {k: v.numpy() for k, v in base.state_dict().items()})
    variables = {"params": params, "batch_stats": stats}
    model = JaxDepthModel(image_height=H, image_width=W,
                          matching_num_depth_bins=D, model_num_views=K_SRC + 1,
                          cost_volume_backend="pallas_interpret",
                          dtype=jnp.float32)
    with jax.default_matmul_precision("highest"):
        # one compiled forward serves both flips (a traced bool); the cost
        # volume is captured as an intermediate
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
    return variables, cur, src, outputs


def test_bridge_round_trips_through_convert_state_dict(jax_run):
    variables = jax_run[0]
    sd = jax_to_state_dict(variables["params"], variables["batch_stats"])
    params, stats, report = convert_state_dict(sd)
    leftover = [k for k in report["skipped"]
                if not (k.endswith(".filt")
                        or k.endswith("num_batches_tracked"))]
    assert leftover == []

    def flat(tree):
        return {"/".join(str(p.key) for p in path): np.asarray(leaf)
                for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}

    for got, want in ((params, variables["params"]),
                      (stats, variables["batch_stats"])):
        got, want = flat(got), flat(want)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)

    # and the port loads it strictly
    load_jax_variables(DepthModel(matching_num_depth_bins=D,
                                  model_num_views=K_SRC + 1), variables)


@pytest.mark.parametrize("flip", [False, True], ids=["plain", "flip"])
def test_depth_model_matches_jax(jax_run, flip):
    assert_matches_jax(jax_run, flip, "fused_sweep")


@pytest.mark.parametrize("flip", [False, True], ids=["plain", "flip"])
@pytest.mark.parametrize("backend", ["pallas_v1", "pallas_full"])
def test_early_sweep_models_match_jax(jax_run, backend, flip):
    assert_matches_jax(jax_run, flip, backend)


def assert_matches_jax(jax_run, flip, backend):
    """The port's forward with the hero sweep `backend` against the JAX
    forward (K1 in interpret mode) on the same weights and inputs."""
    variables, cur, src, outputs = jax_run
    want = outputs[flip]
    model = load_jax_variables(
        DepthModel(matching_num_depth_bins=D, model_num_views=K_SRC + 1,
                   hero_sweep=backend), variables).eval()

    captured = {}
    model.cost_volume.register_forward_hook(
        lambda mod, args, out: captured.update(volume=out[0]))
    to_t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    with torch.no_grad():
        got = model(to_t(cur), to_t(src), flip=flip, return_mask=True)
    got = {k: v.numpy() for k, v in got.items()}
    got["cost_volume_bhwd"] = captured["volume"].numpy()

    assert sorted(got) == sorted(want)
    assert want["log_depth_pred_s0_bhw1"].shape == (B, H // 2, W // 2, 1)
    compared = ["cost_volume_bhwd"] + [f"log_depth_pred_s{i}_bhw1"
                                       for i in range(4)]
    for key in compared:
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
