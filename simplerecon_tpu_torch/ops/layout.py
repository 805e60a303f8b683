"""The memory layout of the convolution stacks.

On a CUDA device the convolution stacks keep their weights and
activations in `torch.channels_last`: cuDNN's tensor-core convolutions
take NHWC, and it would transpose an NCHW input into NHWC before each
call and the output back after it. Tensors keep their logical NCHW
shapes; only their strides change. On the CPU the stacks stay NCHW
(`conv_format`).

`relayout` is where a tensor changes layout on its way into or out of a
kernel that takes another one, and `on_nchw` runs such a kernel between
two: the stem pool K3 takes NCHW maps, and so do PyTorch's depthwise
convolution kernels. cuDNN's channels_last depthwise engines are
compiled at run time, per shape and direction, on their first use in a
process: on an H100 0.5-1.3 s each and ~4 s more for the compiler's
first start, ~7 s over the prior's first training step, where the NCHW
kernels compile nothing. A copy made for the layout alone, forward or
backward, adds 1 to the recorder's counter `layout_copies`.
"""

from __future__ import annotations

import itertools

import torch
import torch.nn as nn

from simplerecon_tpu_torch import tracing


def conv_format(device) -> torch.memory_format:
    """The convolution stacks' layout on `device`: channels_last on a
    CUDA device, contiguous (NCHW) elsewhere."""
    if torch.device(device).type == "cuda":
        return torch.channels_last
    return torch.contiguous_format


def format_of(x: torch.Tensor) -> torch.memory_format:
    """channels_last for a 4-D tensor laid out so (and not also NCHW, as
    a map of one channel or one pixel is), else contiguous_format."""
    if (x.dim() == 4 and not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last)):
        return torch.channels_last
    return torch.contiguous_format


def use_format_(module: nn.Module, memory_format: torch.memory_format
                ) -> None:
    """Lays out every 4-D parameter and buffer of `module` in
    `memory_format`, in place: the same Parameter objects, so an
    optimizer made before keeps them."""
    for t in itertools.chain(module.parameters(), module.buffers()):
        if t.dim() == 4 and not t.is_contiguous(memory_format=memory_format):
            t.data = t.data.contiguous(memory_format=memory_format)


def _copy(x: torch.Tensor, memory_format, dtype) -> torch.Tensor:
    if x.is_contiguous(memory_format=memory_format):
        return x.to(dtype)
    if dtype == x.dtype:
        tracing.count("layout_copies")
    return x.to(dtype, memory_format=memory_format)


class _Relayout(torch.autograd.Function):
    """`_copy` forward; its gradient goes back to the input's layout and
    dtype in one copy."""

    @staticmethod
    def forward(ctx, x, memory_format, dtype):
        ctx.back = (format_of(x), x.dtype)
        return _copy(x, memory_format, dtype)

    @staticmethod
    def backward(ctx, g):
        return _copy(g, *ctx.back), None, None


def relayout(x: torch.Tensor, memory_format: torch.memory_format,
             dtype: torch.dtype = None) -> torch.Tensor:
    """`x` laid out in `memory_format`, in `dtype` (default x's): one
    copy at most, none where x already is so. A cast and a change of
    layout share their copy; a copy for the layout alone counts in
    `layout_copies`. The gradient comes back in x's layout and dtype, by
    the same rule."""
    dtype = x.dtype if dtype is None else dtype
    if x.is_contiguous(memory_format=memory_format) and dtype == x.dtype:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _Relayout.apply(x, memory_format, dtype)
    return _copy(x, memory_format, dtype)


def on_nchw(fn, x: torch.Tensor) -> torch.Tensor:
    """`fn(x)` computed on x laid out NCHW, its output laid out as x is
    (`relayout` both ways)."""
    return relayout(fn(relayout(x, torch.contiguous_format)), format_of(x))
