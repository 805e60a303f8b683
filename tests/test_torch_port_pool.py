"""The port's stem pool (`ops/pool.py`, the plain versions of K3-fwd and
K3-bwd) and the matching encoder with `pool_impl="pallas"` against the
JAX package, on the CPU in float32.

The JAX Pallas kernel `max_blur_pool_pallas` runs in interpret mode, on
a ReLU'd NHWC input on quarter steps, so 2x2 windows hold ties and exact
zeros. Its forward and its hand-written VJP are held to atol 1e-5 at
O(1) values (the same 16-term float32 blur, summed in another order).
The cotangent is positive, so dx is nonzero exactly where an element is
the first maximum of some window: the port must route to exactly the
same elements. A shape the JAX kernel does not tile (odd H) is held
against its XLA chain `max_blur_pool_xla` the same way.

The matching encoder with `pool_impl="pallas"` against JAX's (which
runs the XLA chain off the TPU): 1e-4 x (1 + max |jax|), the tolerance of
tests/test_torch_port_modules.py. The same state_dict, with its
`net.3.1.filt` buffer, loads into both pool forms of the port.
"""

import jax
import numpy as np
import pytest
import torch

from simplerecon_tpu.models.matching_encoder import \
    ResnetMatchingEncoder as JaxMatchingEncoder
from simplerecon_tpu.ops import pallas_pool
from simplerecon_tpu_torch.models.matching_encoder import \
    ResnetMatchingEncoder
from simplerecon_tpu_torch.ops import pool
from simplerecon_tpu_torch.ops import launch_counts
from simplerecon_tpu_torch.testing import pool_case, pool_cotangent
from test_torch_port_modules import apply_jax, assert_close, bridged, nchw
from test_torch_port_ops import few_torch_threads  # noqa: F401 (autouse)

POOL_ATOL = 1e-5


def _nhwc(t):
    return np.ascontiguousarray(t.numpy().transpose(0, 2, 3, 1))


def _check_pool(x, g, jax_fn):
    """The port's forward and dx against `jax_fn` and its VJP, on NCHW
    torch inputs x and (positive) g."""
    def fwd_and_vjp(x_, g_):
        out, vjp = jax.vjp(jax_fn, x_)
        return out, vjp(g_)[0]

    want, want_dx = jax.jit(fwd_and_vjp)(_nhwc(x), _nhwc(g))
    want_dx = np.asarray(want_dx)
    got = pool.max_blur_pool(x)
    got_dx = pool.max_blur_pool_bwd(x, g)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=0,
                               atol=POOL_ATOL)
    np.testing.assert_allclose(_nhwc(got_dx), want_dx, rtol=0,
                               atol=POOL_ATOL)
    routed = _nhwc(got_dx) != 0
    np.testing.assert_array_equal(routed, want_dx != 0)
    assert 0.2 < routed.mean() < 0.8


def test_pool_matches_jax_kernel():
    shape = (2, 16, 32, 48)                       # NHWC (2, 32, 48, 16)
    assert pallas_pool._supported((2, 32, 48, 16))
    x = pool_case(shape, torch.float32, "cpu", seed=1)
    assert (x == 0).float().mean() > 0.4
    g = pool_cotangent((2, 16) + pool.output_size(32, 48), torch.float32,
                       "cpu", seed=2, positive=True)
    _check_pool(x, g, lambda v: pallas_pool.max_blur_pool_pallas(v, True))


def test_pool_takes_a_shape_the_jax_kernel_does_not():
    shape = (2, 8, 13, 22)
    assert not pallas_pool._supported((2, 13, 22, 8))
    x = pool_case(shape, torch.float32, "cpu", seed=3)
    g = pool_cotangent((2, 8) + pool.output_size(13, 22), torch.float32,
                       "cpu", seed=4, positive=True)
    _check_pool(x, g, pallas_pool.max_blur_pool_xla)


def test_matching_encoder_with_the_fused_pool_matches_jax():
    x = np.random.RandomState(5).randn(2, 64, 96, 3).astype(np.float32)
    variables, want = apply_jax(
        JaxMatchingEncoder(num_ch_out=16, pool_impl="pallas"), (x,), 5)
    fused = bridged(ResnetMatchingEncoder(num_ch_out=16, pool_impl="pallas"),
                    "matching_model", variables)
    plain = bridged(ResnetMatchingEncoder(num_ch_out=16), "matching_model",
                    variables)
    assert "net.3.1.filt" in fused.state_dict()
    before = (launch_counts()["max_blur_pool"],
              launch_counts()["max_blur_pool_bwd"])
    with torch.no_grad():
        got = fused(nchw(x))
        assert_close(got, want)
        torch.testing.assert_close(got, plain(nchw(x)), rtol=0, atol=0)
    assert (launch_counts()["max_blur_pool"],
            launch_counts()["max_blur_pool_bwd"]) == before   # plain versions


def test_max_blur_pool_function_uses_plain_versions_only_on_cpu():
    x = pool_case((1, 3, 9, 10), torch.float32, "cpu", seed=6)
    g = pool_cotangent((1, 3) + pool.output_size(9, 10), torch.float32,
                       "cpu", seed=7)
    before = (launch_counts()["max_blur_pool"],
              launch_counts()["max_blur_pool_bwd"])
    xg = x.clone().requires_grad_()
    out = pool.MaxBlurPool.apply(xg)
    out.backward(g)
    torch.testing.assert_close(out, pool.max_blur_pool_reference(x),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        xg.grad, pool.max_blur_pool_backward_reference(x, g), rtol=0, atol=0)
    assert (launch_counts()["max_blur_pool"],
            launch_counts()["max_blur_pool_bwd"]) == before
    with pytest.raises(ValueError):
        pool.max_blur_pool(x.to("meta"))


@pytest.mark.parametrize("bad", ["small", "dtype", "strided", "rank"])
def test_pool_wrapper_rejects_what_the_kernels_do_not_take(bad):
    x = pool_case((1, 2, 8, 8), torch.float32, "cpu")
    arg = {"small": x[:, :, :3].contiguous(), "dtype": x.half(),
           "strided": x.transpose(2, 3), "rank": x[0]}[bad]
    with pytest.raises(TypeError if bad == "dtype" else ValueError):
        pool.check_args(arg)
