"""The convolution stacks' channels_last layout (`ops/layout.py`), on the
CPU: the layout the model takes on a CUDA device, set here with the same
helper, against the NCHW model.

Tolerances (float32, b2 at 64x96, 3 views, 8 planes): the same sums in
another memory order. Through the training-mode batch norms a last-bit
difference grows: the NCHW model run with 1 thread and with 4 differs by
a relative L2 of 3.3e-3 over all gradients (1e-2 on single
squeeze-excite leaves; leaves whose true gradient is nil, as a bias
before a norm, differ by their whole size), so the gradients are held
to 1e-2 in relative L2 over all leaves, and the depth maps to 1e-4.
"""

import collections
import copy

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from simplerecon_tpu_torch import tracing
from simplerecon_tpu_torch.models.depth_model import build_depth_model
from simplerecon_tpu_torch.models.matching_encoder import upsample_nearest_to
from simplerecon_tpu_torch.ops import layout, pool
from simplerecon_tpu_torch.ops.image import pad_edges
from simplerecon_tpu_torch.parallel import train
from simplerecon_tpu_torch.testing import (ConvolutionLayouts, dot_options,
                                           hero_options, train_batch)
from test_torch_port_ops import few_torch_threads  # noqa: F401 (autouse)

CL = torch.channels_last
OUTPUT_TOL = 1e-4
GRAD_TOL = 1e-2
# copies for the layout alone in one float32 training step, besides the 4
# of each depthwise convolution (`layout.on_nchw`): the volume into and
# out of the CV encoder (its cast shares the copy in bf16), and the dot
# model's stem pool K3 in and out, forward and backward
LAYOUT_COPIES = {"hero": 2, "dot": 6}
# convolutions besides the Conv2d modules', forward and backward: the
# hero's stem BlurPool (a dense F.conv2d on a channels_last map); the dot
# model's stem pool runs K3's plain NCHW twin on the CPU, whose depthwise
# blur runs forward, again in its backward, and backward
EXTRA_CONVOLUTIONS = {"hero": (1, 1), "dot": (2, 1)}


def depthwise_modules(model) -> int:
    return sum(isinstance(m, nn.Conv2d) and m.groups == m.in_channels > 1
               for m in model.modules())


def _forward_backward(model, batch):
    model.zero_grad(set_to_none=True)
    loss_dict, outputs = train.forward_and_losses(model, batch, flip=True)
    loss_dict["loss"].backward()
    grads = torch.cat([p.grad.flatten() for p in model.parameters()])
    return outputs, grads


@pytest.mark.parametrize("name", ["hero", "dot"])
def test_channels_last_model_matches_nchw(name):
    """One training-mode forward and backward, with flip, of the model
    laid out channels_last against the NCHW model: the depth maps and
    gradients within the tolerances, every convolution's input (and in
    the backward its gradient) in channels_last but the depthwise ones'
    (NCHW), the layout copies counted; a move to the CPU lays the
    weights out NCHW again."""
    options = {"hero": hero_options, "dot": dot_options}[name]
    opts = options(image_height=64, image_width=96, model_num_views=3,
                   matching_num_depth_bins=8, precision="32")
    nchw = build_depth_model(opts, device="cpu", seed=0).train()
    assert nchw.memory_format == torch.contiguous_format
    cl = copy.deepcopy(nchw)
    layout.use_format_(cl, CL)
    assert cl.memory_format == CL
    batch = train.batch_to_device(train_batch(opts, 2, seed=7), "cpu")

    want, want_grads = _forward_backward(nchw, batch)
    before = tracing.counters().get("layout_copies", 0)
    with ConvolutionLayouts() as convs:
        got, got_grads = _forward_backward(cl, batch)
    copies = tracing.counters().get("layout_copies", 0) - before

    ops = collections.Counter(op for op, *_ in convs.seen)
    modules = sum(isinstance(m, nn.Conv2d) for m in cl.modules())
    forward, backward = EXTRA_CONVOLUTIONS[name]
    assert ops["aten::convolution"] == modules + forward
    assert ops["aten::convolution_backward"] == modules + backward
    # depthwise convolutions on NCHW maps, every other on channels_last
    assert all(nchw if depthwise else cl_
               for _, depthwise, cl_, nchw in convs.seen)
    for i in range(4):
        key = f"depth_pred_s{i}_bhw1"
        err = (got[key] - want[key]).abs().max() / want[key].abs().max()
        assert err <= OUTPUT_TOL, (key, err.item())
    err = (got_grads - want_grads).norm() / want_grads.norm()
    assert err <= GRAD_TOL, err.item()
    assert copies == LAYOUT_COPIES[name] + 4 * depthwise_modules(cl)
    cl.to("cpu")
    assert cl.memory_format == torch.contiguous_format


@pytest.mark.parametrize("size", [(12, 20), (11, 19)], ids=["2x", "odd"])
def test_nearest_upsample_keeps_the_layout(size):
    """The UNet encoder's nearest upsample of a channels_last map: the
    NCHW map's values, laid out channels_last, at an exact 2x (a pixel
    repeat) and at another size (a gather)."""
    x = torch.randn(2, 5, 6, 10)
    want = upsample_nearest_to(x, size)
    got = upsample_nearest_to(x.contiguous(memory_format=CL), size)
    assert got.is_contiguous(memory_format=CL)
    assert torch.equal(got, want)


@pytest.mark.parametrize("mode,pads", [("reflect", (1, 2, 1, 2)),
                                       ("replicate", (1, 1, 1, 1))])
def test_edge_pads_keep_the_layout(mode, pads):
    """`pad_edges` of a channels_last map (copied into a channels_last map
    border by border): F.pad's values, and the NCHW map's gradient, both
    laid out channels_last."""
    x = torch.randn(2, 5, 6, 7, dtype=torch.float64)
    g = torch.randn(2, 5, 6 + pads[2] + pads[3], 7 + pads[0] + pads[1],
                    dtype=torch.float64)
    want = F.pad(x, pads, mode=mode)
    want_dx, = torch.autograd.grad(pad_edges(x.requires_grad_(), pads, mode),
                                   x, g)
    x_cl = x.detach().contiguous(memory_format=CL).requires_grad_()
    got = pad_edges(x_cl, pads, mode)
    got_dx, = torch.autograd.grad(got, x_cl, g.contiguous(memory_format=CL))
    assert got.is_contiguous(memory_format=CL)
    assert got_dx.is_contiguous(memory_format=CL)
    assert torch.equal(got, want)
    torch.testing.assert_close(got_dx, want_dx, rtol=1e-12, atol=1e-12)


def test_blur_pool_of_a_channels_last_map():
    """The stem's BlurPool on a channels_last map (a dense convolution
    with the filter on its diagonal) against the depthwise one: the same
    sums, in float64 equal to 1e-12."""
    x = torch.randn(2, 6, 9, 11, dtype=torch.float64)
    filt = pool.blur_filter(6).double()
    want = pool.blur_pool_reference(x, filt)
    got = pool.blur_pool_reference(x.contiguous(memory_format=CL), filt)
    assert got.is_contiguous(memory_format=CL)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
