"""The bf16 rounding points of the fused sweep (K1) and its backward (K2):
the plain versions `fused_sweep_reference` and
`fused_sweep_backward_reference` in bf16 against the JAX Pallas kernels
`banded_warp_feature_volume` and `banded_warp_feature_volume_bwd` in bf16,
in interpret mode, on the CPU. The card's kernels are held to these plain
versions (tests/test_torch_port_gpu.py, chip_smoke.py), so this pins the
rounding points they reproduce.

Both packages round the MLP input, h0 and h1, and in the backward d_h1p,
d_h0p and the sample gradients, to bf16 before the product that consumes
them, and sum in float32. So they differ only where a float32 sum taken
in another order crosses a bf16 rounding boundary: a few values move by a
rounding step, the rest by nothing, and the MEAN error stays near 1e-6 of
the mean magnitude. A wrong rounding point moves every value a little and
the mean by 1e-3 or more. The tests hold the mean:

- "exact_taps": source cameras that differ from the reference only by a
  2x zoom (principal point moved so taps land on whole pixels, many off
  the image), a 180-degree roll, and a 180-degree turn (every point
  behind the camera). Every tap weight is 0 or 1 up to float32 noise, so
  the JAX kernel's bf16 rounding of its x-tap weights (ROADMAP Queue 3, a
  reference-side difference) changes nothing. Tolerance: mean |port -
  jax| <= 1e-4 x mean |jax| for the scores and each gradient (measured
  at most 2e-6 on this file's inputs), except d_w2 at 5e-3: the JAX
  backward sums unrounded h1 into d_w2 where the port sums the rounded
  h1 its forward used (measured 1.3e-3). Mutation checks on the plain
  version: leaving h0 unrounded moved the scores' mean by 3.9e-3 and the
  gradients' by up to 2.6e-2; leaving r0 (d_h0p) unrounded moved d_src
  by 2.3e-3; r1 by 3.2e-3; the sample gradients by 1.6e-3; the MLP input
  by 3.4e-3: each fails here.
- "wide": sweep_inputs' wide geometry (large rotations, a camera turned
  around, taps off the image), where the x-tap weights are fractional.
  There the JAX kernel's extra rounding of each sample moves the scores'
  mean by 2.3e-3 and the gradients' by up to 2.8e-2 of their mean
  magnitude; it hides the rounding of r0 and of the sample gradients
  (they move the means by less than 1e-3), so the tolerance, 1e-2 for
  the scores and 6e-2 for the gradients, only catches gross faults.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplerecon_tpu.ops import geometry as jgeo
from simplerecon_tpu.ops import pallas_cv
from simplerecon_tpu_torch.ops import cuda_cv
from test_torch_port_ops import ORDER, sweep_inputs
from test_torch_port_ops import few_torch_threads  # noqa: F401 (autouse)

SHAPE = (1, 3, 16, 32, 8, 4)    # b, k, h, w, c, d
GRAD_NAMES = ("d_src", "d_cur", "d_w0", "d_b0", "d_w1", "d_b1", "d_w2",
              "d_b2")
MEAN_TOL = {"exact_taps": (1e-4, 1e-4), "wide": (1e-2, 6e-2)}
D_W2_TOL = 5e-3                 # "exact_taps": JAX's d_w2 sums unrounded h1
BF16 = ("src", "cur", "w0", "w1", "w2")


def exact_tap_inputs(seed: int) -> dict:
    """sweep_inputs' features and weights with the three exact-tap source
    cameras of the note above (k = 3)."""
    b, k, h, w, c, d = SHAPE
    inp = sweep_inputs(*SHAPE, seed=seed)
    K = np.eye(4)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 0.9 * w, 1.1 * h, w / 2, h / 2
    zoom = K.copy()            # index coords 2x, 2y: whole pixels
    zoom[0, 0], zoom[1, 1] = 2 * K[0, 0], 2 * K[1, 1]
    zoom[0, 2], zoom[1, 2] = 2 * K[0, 2] - 0.5, 2 * K[1, 2] - 0.5
    roll = np.diag([-1.0, -1.0, 1.0, 1.0])   # index coords w-1-x, h-1-y
    turn = np.diag([-1.0, 1.0, -1.0, 1.0])   # every point behind it
    extr = np.broadcast_to(np.stack([np.eye(4), roll, turn]), (b, k, 4, 4))
    poses = np.linalg.inv(extr).astype(np.float32)
    penalty, r, t = (np.asarray(x) for x in jgeo.pose_distance(poses))

    def f32(a):
        return np.ascontiguousarray(a, np.float32)

    inp.update(extr=f32(extr),
               Ks=f32(np.broadcast_to(np.stack([zoom, K, K]), (b, k, 4, 4))),
               invK=f32(np.broadcast_to(np.linalg.inv(K), (b, 4, 4))),
               pose_meta=f32(np.stack([penalty, r, t], -1)),
               src_loc=f32(poses[..., :3, 3]))
    return inp


@pytest.fixture(scope="module", params=["exact_taps", "wide"])
def case(request):
    """(geometry name, torch arguments in bf16 where the kernels take it,
    the same values for JAX, the cotangent as numpy)."""
    if request.param == "exact_taps":
        inp = exact_tap_inputs(seed=7)
    else:
        inp = sweep_inputs(*SHAPE, seed=7, wide=True)
    args = [torch.from_numpy(np.asarray(inp[n]).copy()) for n in ORDER]
    args = [a.to(torch.bfloat16) if n in BF16 else a
            for n, a in zip(ORDER, args)]
    jargs = [jnp.asarray(a.float().numpy(), jnp.bfloat16)
             if a.dtype == torch.bfloat16 else jnp.asarray(a.numpy())
             for a in args]
    b, k, h, w, c, d = SHAPE
    g = np.random.RandomState(8).randn(b, d, h * w).astype(np.float32)
    return request.param, args, jargs, g


def _mean_error(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).mean() / np.abs(want).mean()


def test_bf16_plain_forward_rounds_as_the_jax_kernel(case):
    geometry, args, jargs, _ = case
    with jax.default_matmul_precision("highest"):
        want = np.asarray(pallas_cv.banded_warp_feature_volume(
            *jargs, interpret=True))
    got = cuda_cv.fused_sweep_reference(*args)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert want.std() > 1e-2
    err = _mean_error(got.numpy(), want)
    assert err <= MEAN_TOL[geometry][0], (geometry, err)


def test_bf16_plain_backward_rounds_as_the_jax_kernel(case):
    geometry, args, jargs, g = case
    with jax.default_matmul_precision("highest"):
        want = pallas_cv.banded_warp_feature_volume_bwd(
            *jargs, jnp.asarray(g), interpret=True)
    got = cuda_cv.fused_sweep_backward_reference(*args, torch.from_numpy(g))
    errs = {}
    for name, a, ref in zip(GRAD_NAMES, got, want):
        ref = np.asarray(ref)
        assert a.dtype == torch.float32 and a.shape == ref.shape, name
        assert np.abs(ref).max() > 1e-3, name
        errs[name] = _mean_error(a.numpy(), ref)
    tol = MEAN_TOL[geometry][1]
    for name, err in errs.items():
        limit = D_W2_TOL if (name == "d_w2" and geometry == "exact_taps") \
            else tol
        assert err <= limit, (geometry, name, errs)
