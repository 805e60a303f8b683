"""The hero model's inference-only backends "pallas_v1" (warp, then K5)
and "pallas_full" (K4) against the JAX package, on the CPU.

Sizes follow tests/test_pallas_cv.py: b=1, k=3 source views, 16x32, c=8,
d=4 planes, with wide source poses (taps off the image, points behind a
camera). Inputs are made with numpy from a seed; both packages get the
same arrays. The JAX kernels run in interpret mode under
`default_matmul_precision("highest")`.

Tolerances:
- the plain versions against the JAX kernels in float32: atol and rtol
  2e-4, the tolerance tests/test_pallas_cv.py holds the JAX kernels to
  (the same MLP summed in another order);
- in bf16, mean |port - jax| <= BF16_MEAN_TOL = 1.5e-5 and
  max |port - jax| <= BF16_MAX_TOL = 5e-3, at outputs of magnitude ~1
  (max |ref| is asserted below 4). Both round at the same points, so
  they differ only where a float32 sum taken in another order crosses a
  bf16 rounding boundary of the MLP input or of a hidden activation: a
  few outputs move by up to ~2e-3, the rest by nothing. Measured on this
  file's inputs: K5 mean 1.2e-6 and max 1.1e-3, K4 4.6e-6 and 2.1e-3.
  The mean catches the rounding faults these kernels invite, which move
  every output a little: with the plain version taking K5's dot rows
  from unrounded samples (as K1 does) this test measured a mean of
  3.0e-4, and with K4's y-tap weights left unrounded 7.0e-4;
- `MLPFeatureVolume` against the JAX module in float32: 2e-4 on the
  volume, 1e-5 on the lowest-cost depth (a plane depth picked by argmax).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplerecon_tpu.models.cost_volume import \
    MLPFeatureVolume as JaxMLPFeatureVolume
from simplerecon_tpu.ops import pallas_cv
from simplerecon_tpu_torch.models.cost_volume import MLPFeatureVolume
from simplerecon_tpu_torch.ops import cost_volume as tcv
from simplerecon_tpu_torch.ops import early_sweeps
from simplerecon_tpu_torch.ops import launch_counts
from simplerecon_tpu_torch.utils.weights import jax_to_state_dict
from test_torch_port_ops import few_torch_threads  # noqa: F401 (autouse)
from test_torch_port_ops import ORDER, sweep_inputs

B, K, H, W, C, D = 1, 3, 16, 32, 8, 4
TOL = 2e-4
BF16_MEAN_TOL = 1.5e-5
BF16_MAX_TOL = 5e-3
TILE = H * W     # the JAX kernels' pixel tile: one tile of all N pixels
MLP = ("w0", "b0", "w1", "b1", "w2", "b2")


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


@pytest.fixture(scope="module")
def inputs():
    return sweep_inputs(B, K, H, W, C, D, seed=7, wide=True)


def _stack_args(inp, cdt):
    """K5's arguments: (torch, numpy) lists in its order, the stack and
    the weights in `cdt`."""
    t = {n: _t(inp[n]) for n in ORDER}
    stack = early_sweeps.stack_inputs(t["src"], t["extr"], t["Ks"],
                                      t["invK"], t["planes"], cdt)
    rays = tcv.pixel_rays(t["invK"], H, W)
    args = [*stack, t["cur"].to(cdt), rays, t["planes"], t["pose_meta"],
            t["src_loc"]] + [t[n].to(cdt) if n[0] == "w" else t[n]
                             for n in MLP]
    return args, _to_jax(args)


def _warp_args(inp, cdt):
    """K4's arguments, as `_stack_args` gives K5's."""
    t = {n: _t(inp[n]) for n in ORDER}
    img, proj = early_sweeps.warp_inputs(t["src"], t["extr"], t["Ks"], cdt)
    rays = tcv.pixel_rays(t["invK"], H, W)
    args = [img, t["cur"].to(cdt), rays, t["planes"], proj, t["pose_meta"],
            t["src_loc"]] + [t[n].to(cdt) if n[0] == "w" else t[n]
                             for n in MLP]
    return args, _to_jax(args)


def _to_jax(args):
    return [jnp.asarray(a.float().numpy(), jnp.bfloat16)
            if a.dtype == torch.bfloat16 else jnp.asarray(a.numpy())
            for a in args]


KERNELS = {
    "K5": (_stack_args, early_sweeps.fused_feature_volume,
           pallas_cv.fused_feature_volume),
    "K4": (_warp_args, early_sweeps.fused_warp_feature_volume,
           pallas_cv.fused_warp_feature_volume),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("kernel", ["K5", "K4"])
def test_plain_version_matches_jax_kernel(inputs, kernel, dtype):
    make_args, port_fn, jax_fn = KERNELS[kernel]
    args, jargs = make_args(inputs, dtype)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_fn(*jargs, tile=TILE, interpret=True))
    before = launch_counts()[port_fn.__name__]
    got = port_fn(*args).numpy()
    # the plain version, no kernel
    assert launch_counts()[port_fn.__name__] == before
    assert got.shape == (B, D, H * W) and got.dtype == np.float32
    assert 1e-2 < want.std() and np.abs(want).max() < 4
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    else:
        err = np.abs(got - want)
        assert err.mean() <= BF16_MEAN_TOL and err.max() <= BF16_MAX_TOL, (
            err.mean(), err.max())


def _jax_module_run(backend, cur, src, extr, poses, Ks, invK, params):
    mod = JaxMLPFeatureVolume(num_depth_bins=D, num_source_views=K,
                              matching_dim_size=C, backend=backend,
                              dtype=jnp.float32)
    with jax.default_matmul_precision("highest"):
        return jax.jit(lambda *a: mod.apply({"params": params}, *a))(
            cur, src, extr, poses, Ks, invK)


@pytest.mark.parametrize("backend", ["pallas_v1", "pallas_full"])
def test_mlp_feature_volume_matches_jax(backend):
    rng = np.random.RandomState(8)
    inp = sweep_inputs(B, K, H, W, C, D, seed=8, wide=True)
    cur = rng.randn(B, H, W, C).astype(np.float32)
    poses = np.linalg.inv(inp["extr"]).astype(np.float32)
    geometry = (cur, inp["src"], inp["extr"], poses, inp["Ks"], inp["invK"])
    # the JAX module's parameters, without an init: its MLP's three layers
    params = {"mlp": {f"dense{i}": {"kernel": inp[f"w{i}"],
                                    "bias": inp[f"b{i}"]} for i in range(3)}}
    want = _jax_module_run(f"{backend}_interpret", *geometry, params)

    tmod = MLPFeatureVolume(num_depth_bins=D, num_source_views=K,
                            matching_dim_size=C, backend=backend)
    sd = jax_to_state_dict({"cost_volume": params}, {})
    tmod.load_state_dict({key.removeprefix("cost_volume."): _t(v)
                          for key, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = tmod(*map(_t, geometry))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-5, atol=1e-5)
    assert np.asarray(want[0]).std() > 1e-2


@pytest.mark.parametrize("backend", ["pallas_v1", "pallas_full"])
def test_early_sweeps_are_inference_only(backend):
    """A backward through K5 or K4 raises (the JAX package has no VJP for
    them either): the features and the MLP weights never go without
    gradient unnoticed."""
    volume_fn = MLPFeatureVolume(num_depth_bins=2, num_source_views=1,
                                 backend=backend)
    b, k, h, w = 1, 1, 8, 8
    eye = torch.eye(4)
    src = torch.randn(b, k, h, w, 16, requires_grad=True)
    volume = volume_fn(torch.randn(b, h, w, 16), src,
                       eye.expand(b, k, 4, 4), eye.expand(b, k, 4, 4),
                       eye.expand(b, k, 4, 4), eye.expand(b, 4, 4))[0]
    assert volume.requires_grad
    with pytest.raises(RuntimeError, match="inference-only"):
        volume.sum().backward()
    assert src.grad is None and volume_fn.mlp.net[0].weight.grad is None


def test_stack_chunks_follow_the_jax_rule():
    """K5 launches once per chunk of planes: the largest divisor of d
    whose bf16 stack fits in 1 GiB (hero N = 12288, k = 7, c = 16)."""
    chunk = early_sweeps.stack_plane_chunk
    assert chunk(1, 7, 12288, 16, 64) == 64
    assert chunk(8, 7, 12288, 16, 64) == 32
    assert chunk(16, 7, 12288, 16, 64) == 16
    assert chunk(1, 3, 512, 8, 4) == 4
