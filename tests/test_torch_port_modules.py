"""The port's network modules against their JAX counterparts, on the CPU
in float32, with weights bridged from the JAX init.

Each JAX module is initialised, its BatchNorm scales, biases and running
statistics are redrawn from a seed (so a wrong mean/var mapping shows),
and the same variables are bridged into the port module through
`utils/weights.py`. Inputs are numpy arrays from a seed.

Tolerance: max |torch - jax| <= 1e-4 * (1 + max |jax|) for every output,
i.e. float32 rounding accumulated over the module's convolutions, which
PyTorch and XLA sum in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from simplerecon_tpu.models.decoders import CVEncoder as JaxCVEncoder
from simplerecon_tpu.models.decoders import \
    DepthDecoderPP as JaxDepthDecoderPP
from simplerecon_tpu.models.efficientnet import \
    EfficientNetV2Features as JaxEfficientNet
from simplerecon_tpu.models.matching_encoder import \
    ResnetMatchingEncoder as JaxMatchingEncoder
from simplerecon_tpu_torch.models.decoders import CVEncoder, DepthDecoderPP
from simplerecon_tpu_torch.models.efficientnet import EfficientNetV2Features
from simplerecon_tpu_torch.models.matching_encoder import \
    ResnetMatchingEncoder
from simplerecon_tpu_torch.utils.weights import jax_to_state_dict
from test_torch_port_ops import few_torch_threads  # noqa: F401 (autouse)

REL_TOL = 1e-4


def randomize_bn(variables, seed):
    """numpy copies of `variables` with every BatchNorm's scale, bias,
    mean and var redrawn."""
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(np.array, variables["params"])
    stats = jax.tree_util.tree_map(np.array,
                                   variables.get("batch_stats", {}))

    def walk(p, s):
        for name, sub in s.items():
            if "mean" in sub:
                n = sub["mean"].shape
                sub["mean"] = rng.normal(0, 0.1, n).astype(np.float32)
                sub["var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
                p[name]["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
                p[name]["bias"] = rng.normal(0, 0.1, n).astype(np.float32)
            else:
                walk(p[name], sub)

    walk(params, stats)
    return {"params": params, "batch_stats": stats}


def bridged(module, top, variables):
    """Loads `variables` of the JAX module named `top` into `module`."""
    sd = jax_to_state_dict({top: variables["params"]},
                           {top: variables["batch_stats"]})
    module.load_state_dict(
        {k.removeprefix(top + "."): torch.from_numpy(np.array(v))
         for k, v in sd.items()}, strict=True)
    return module.eval()


def assert_close(got_nchw, want_nhwc):
    want = np.asarray(want_nhwc).transpose(0, 3, 1, 2)
    got = got_nchw.detach().numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL_TOL * (1 + np.abs(want).max()))


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def apply_jax(module, inputs, seed):
    with jax.default_matmul_precision("highest"):
        variables = jax.jit(lambda *x: module.init(
            jax.random.PRNGKey(seed), *x, train=False))(*inputs)
        variables = randomize_bn(variables, seed)
        out = jax.jit(lambda v, *x: module.apply(v, *x, train=False))(
            variables, *inputs)
    return variables, out


def test_matching_encoder_matches_jax():
    x = np.random.RandomState(0).randn(2, 64, 96, 3).astype(np.float32)
    variables, want = apply_jax(JaxMatchingEncoder(num_ch_out=16), (x,), 0)
    tm = bridged(ResnetMatchingEncoder(num_ch_out=16), "matching_model",
                 variables)
    with torch.no_grad():
        assert_close(tm(nchw(x)), want)


def test_efficientnet_matches_jax():
    x = np.random.RandomState(1).randn(1, 64, 96, 3).astype(np.float32)
    variables, want = apply_jax(JaxEfficientNet(dtype=jnp.float32), (x,), 1)
    tm = bridged(EfficientNetV2Features(), "encoder", variables)
    with torch.no_grad():
        got = tm(nchw(x))
    assert len(got) == len(want) == 5
    for g, wnt in zip(got, want):
        assert_close(g, wnt)


def test_cv_encoder_matches_jax():
    rng = np.random.RandomState(2)
    d, h, w = 8, 16, 24
    enc_ch = (48, 64, 160, 256)
    vol = rng.randn(1, h, w, d).astype(np.float32)
    feats = [rng.randn(1, h >> i, w >> i, ch).astype(np.float32)
             for i, ch in enumerate(enc_ch)]
    variables, want = apply_jax(JaxCVEncoder(), (vol, feats), 2)
    tm = bridged(CVEncoder(num_ch_cv=d, num_ch_enc=enc_ch),
                 "cost_volume_net", variables)
    with torch.no_grad():
        got = tm(nchw(vol), [nchw(f) for f in feats])
    assert len(got) == len(want) == 4
    for g, wnt in zip(got, want):
        assert_close(g, wnt)


def test_depth_decoder_matches_jax():
    rng = np.random.RandomState(3)
    enc_ch = (24, 64, 128, 256, 384)
    feats = [rng.randn(1, 32 >> i, 48 >> i, ch).astype(np.float32)
             for i, ch in enumerate(enc_ch)]
    variables, want = apply_jax(JaxDepthDecoderPP(), (feats,), 3)
    tm = bridged(DepthDecoderPP(num_ch_enc=enc_ch), "depth_decoder",
                 variables)
    with torch.no_grad():
        got = tm([nchw(f) for f in feats])
    assert sorted(got) == sorted(want) == [
        f"log_depth_pred_s{i}_b1hw" for i in range(4)]
    for key in want:
        assert_close(got[key], want[key])
