"""The fused sweep's backward (K2's plain version and `FusedSweep`)
against the JAX package, on the CPU in float32.

`fused_sweep_backward_reference` is held against the JAX Pallas kernel
`banded_warp_feature_volume_bwd` in interpret mode, at the shape of
tests/test_warp_matmul.py's custom-VJP test (b2 k3 24x32 c8 d6, MLP
hidden 128), on a narrow-band case (the kernel's 16-row tier) and a
wide-baseline one (its full-height tier). Tolerance: rtol 2e-4 and atol
2e-4 x max |ref| per gradient, that test's tolerance: the same float32
sums in another order, over bilinear taps whose coordinates round
differently.

`FusedSweep` on the CPU must give the gradients that torch autograd
finds through the plain forward `fused_sweep_reference`: rtol 1e-5 and
atol 1e-5 x max |ref|, float32 rounding of one function differentiated
two ways (the autograd warp normalises its coordinates, the explicit
one does not).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplerecon_tpu.ops import pallas_cv
from simplerecon_tpu_torch.ops import cuda_cv
from simplerecon_tpu_torch.ops import launch_counts
from test_torch_port_ops import ORDER, _t, sweep_inputs
from test_torch_port_ops import few_torch_threads  # noqa: F401 (autouse)

SHAPE = (2, 3, 24, 32, 8, 6)    # b, k, h, w, c, d
GRAD_NAMES = ("d_src", "d_cur", "d_w0", "d_b0", "d_w1", "d_b1", "d_w2",
              "d_b2")
JAX_TOL = 2e-4
AUTOGRAD_TOL = 1e-5


def _cotangent(shape, seed):
    b, k, h, w, c, d = shape
    return np.random.RandomState(seed).randn(b, d, h * w).astype(np.float32)


def _assert_grads_close(got, want, tol):
    for name, g, ref in zip(GRAD_NAMES, got, want):
        ref = np.asarray(ref)
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        assert g.shape == ref.shape, (name, g.shape, ref.shape)
        scale = max(np.abs(ref).max(), 1e-3)
        np.testing.assert_allclose(g, ref, rtol=tol, atol=tol * scale,
                                   err_msg=name)


@pytest.mark.parametrize("wide", [False, True], ids=["banded", "full_height"])
def test_backward_reference_matches_jax_kernel(wide):
    inp = sweep_inputs(*SHAPE, seed=7, wide=wide)
    args = [inp[n] for n in ORDER]
    g = _cotangent(SHAPE, seed=8)

    # which tier of the JAX kernel these inputs take (default bands: 16)
    prep = pallas_cv._banded_prep(
        jnp.asarray(inp["src"]), jnp.asarray(inp["cur"]), inp["Ks"],
        inp["extr"], inp["invK"], inp["planes"], jnp.float32, 4, 128,
        (16, 32))
    fits = [bool(f) for f in prep["fits"]]
    assert fits == [not wide], fits

    with jax.default_matmul_precision("highest"):
        want = pallas_cv.banded_warp_feature_volume_bwd(
            *[jnp.asarray(a) for a in args], jnp.asarray(g), interpret=True)
    got = cuda_cv.fused_sweep_backward_reference(*[_t(a) for a in args],
                                                 _t(g))
    _assert_grads_close(got, want, JAX_TOL)
    assert np.abs(np.asarray(want[0])).max() > 1e-2


def test_fused_sweep_function_matches_autograd_of_plain_forward():
    shape = (1, 2, 8, 12, 4, 5)
    inp = sweep_inputs(*shape, seed=9, wide=True)
    g = _t(_cotangent(shape, seed=10))
    diff = ("src", "cur", "w0", "b0", "w1", "b1", "w2", "b2")

    def run(fn):
        args = [_t(inp[n]).requires_grad_(n in diff) for n in ORDER]
        out = fn(*args)
        grads = torch.autograd.grad(out, [a for n, a in zip(ORDER, args)
                                          if n in diff], g)
        return out, grads

    before = (launch_counts()["fused_sweep"],
              launch_counts()["fused_sweep_bwd"])
    out, got = run(cuda_cv.FusedSweep.apply)
    out_ref, want = run(cuda_cv.fused_sweep_reference)
    assert (launch_counts()["fused_sweep"],
            launch_counts()["fused_sweep_bwd"]) == before  # plain versions
    torch.testing.assert_close(out, out_ref, rtol=0, atol=0)
    _assert_grads_close(got, [w.numpy() for w in want], AUTOGRAD_TOL)


def test_fused_sweep_function_gives_geometry_no_gradient():
    inp = sweep_inputs(1, 2, 4, 8, 4, 3, seed=11)
    args = [_t(inp[n]).requires_grad_(True) for n in ORDER]
    cuda_cv.FusedSweep.apply(*args).sum().backward()
    for name, a in zip(ORDER, args):
        if name in ("extr", "Ks", "invK", "planes", "pose_meta", "src_loc"):
            assert a.grad is None, name
        else:
            assert a.grad is not None and torch.isfinite(a.grad).all(), name


def test_fused_sweep_function_returns_master_weight_gradients_in_fp32():
    """bf16 features with float32 MLP weights: the weights are cast to
    bf16 inside, and their gradients come back in float32."""
    inp = sweep_inputs(1, 2, 4, 8, 4, 3, seed=12)
    args = [_t(inp[n]) for n in ORDER]
    args[0] = args[0].to(torch.bfloat16).requires_grad_()
    args[1] = args[1].to(torch.bfloat16).requires_grad_()
    for i in (8, 10, 12):
        args[i].requires_grad_()
    out = cuda_cv.FusedSweep.apply(*args)
    assert out.dtype == torch.float32
    out.square().sum().backward()
    assert args[0].grad.dtype == torch.bfloat16
    assert args[8].grad.dtype == torch.float32
    assert torch.isfinite(args[8].grad).all()
