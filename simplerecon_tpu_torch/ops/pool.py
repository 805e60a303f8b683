"""Fused anti-aliased max-blur-pool (counterpart of
`simplerecon_tpu/ops/pallas_pool.py`): the matching encoder's stem pool,
a 2x2 stride-1 VALID max-pool, then BlurPool(4) (reflect pad
(1, 2, 1, 2) and the depthwise [1,3,3,1] x [1,3,3,1] / 64 filter at
stride 2), on NCHW maps.

`max_blur_pool` replaces the TPU kernel `max_blur_pool_pallas` (K3-fwd,
body `_fwd_kernel`) and `max_blur_pool_bwd` its hand-written backward
`_bwd_pallas` (K3-bwd, body `_bwd_kernel`), which sends the
blur-transposed gradient to the first maximum of each 2x2 window in
row-major order. Both CUDA kernels are in `csrc/max_blur_pool.cu`; see
the note there for what bounds them on an H100. They stage rows with
16-byte copies and write with 16-byte stores where the rows allow it
(`rows_by_16_bytes`), element by element where they do not. For CPU
tensors the wrappers run the plain chain (`max_blur_pool_reference`) and
its autograd (`max_blur_pool_backward_reference`); for CUDA tensors they
launch the kernels, or raise. The kernels take every shape the plain
chain takes (H, W >= 4, odd ones included), where the JAX kernel falls
back to XLA on shapes it does not tile. `MaxBlurPool` joins the two as
a `torch.autograd.Function`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from simplerecon_tpu_torch import tracing
from simplerecon_tpu_torch.ops import _build, layout
from simplerecon_tpu_torch.ops.image import pad_edges

_TAPS = (1.0, 3.0, 3.0, 1.0)


def blur_filter(channels: int, device=None) -> torch.Tensor:
    """The depthwise [1,3,3,1] x [1,3,3,1] / 64 filter, (C, 1, 4, 4)
    float32."""
    a = torch.tensor(_TAPS, device=device)
    filt = a[:, None] * a[None, :]
    return (filt / filt.sum())[None, None].repeat(channels, 1, 1, 1)


def blur_pool_reference(x_bchw: torch.Tensor, filt: torch.Tensor
                        ) -> torch.Tensor:
    """antialiased_cnns.BlurPool(filt_size=4, stride=2): reflect pad
    (1, 2, 1, 2), then the depthwise `filt` (C, 1, 4, 4) at stride 2.

    On a channels_last map the filter runs as a dense convolution whose
    weight holds each channel's filter on its diagonal and zeros
    elsewhere: each output is the same sum plus exact zeros. At the
    hero's b16 stem on an H100, in deterministic mode, cuDNN's
    channels_last depthwise kernels took 11.9 ms forward and 10.6 ms
    backward, the dense convolution about 0.5 and 0.6; the NCHW kernel
    between `layout.on_nchw`'s copies of these, the encoder's largest
    maps, 22.8 ms with the pad."""
    x = pad_edges(x_bchw, (1, 2, 1, 2), "reflect")
    filt = filt.to(x.dtype)
    if layout.format_of(x) == torch.channels_last:
        dense = torch.diag_embed(filt[:, 0].permute(1, 2, 0))  # (4, 4, C, C)
        return F.conv2d(x, dense.permute(2, 3, 0, 1).contiguous(
            memory_format=torch.channels_last), stride=2)
    return F.conv2d(x, filt, stride=2, groups=x.shape[1])


def max_blur_pool_reference(x_bchw: torch.Tensor, filt=None
                            ) -> torch.Tensor:
    """The plain chain: `F.max_pool2d(2, stride 1)`, then
    `blur_pool_reference` with `filt` (default `blur_filter`)."""
    if filt is None:
        filt = blur_filter(x_bchw.shape[1], device=x_bchw.device)
    return blur_pool_reference(F.max_pool2d(x_bchw, 2, stride=1), filt)


def max_blur_pool_backward_reference(x_bchw: torch.Tensor,
                                     g_bchw: torch.Tensor) -> torch.Tensor:
    """dx of the plain chain by autograd, given the cotangent g of its
    output: max_pool2d sends each window's gradient to its first maximum
    in row-major order."""
    with torch.enable_grad():
        x = x_bchw.detach().requires_grad_()
        out = max_blur_pool_reference(x)
        return torch.autograd.grad(out, x, g_bchw)[0]


def output_size(h: int, w: int) -> tuple:
    """(Ho, Wo) of the pool over an h x w map."""
    return (h - 2) // 2 + 1, (w - 2) // 2 + 1


def check_args(x_bchw: torch.Tensor) -> tuple:
    """Raises on any input the kernels do not take; returns (b, c, h, w)."""
    if x_bchw.dim() != 4:
        raise ValueError(f"x must be (b, c, h, w), got {tuple(x_bchw.shape)}")
    if x_bchw.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"x has dtype {x_bchw.dtype}, not float32 or "
                        "bfloat16")
    b, c, h, w = x_bchw.shape
    if h < 4 or w < 4:
        raise ValueError(f"the reflect pad needs h, w >= 4, got {h}x{w}")
    _build.check("x", x_bchw, x_bchw.dtype, (b, c, h, w), x_bchw.device)
    return b, c, h, w


def rows_by_16_bytes(t: torch.Tensor, width: int) -> bool:
    """Whether the rows of `t`, a contiguous map `width` elements wide,
    all start on a 16-byte boundary: the kernels then copy and store
    them 16 bytes at a time, else one element at a time."""
    return t.data_ptr() % 16 == 0 and width * t.element_size() % 16 == 0


def max_blur_pool(x_bchw: torch.Tensor) -> torch.Tensor:
    """Max-pool 2x2/1 then BlurPool(4)/2 (K3-fwd). (b, c, h, w) ->
    (b, c, Ho, Wo) in x's dtype, summed in float32 and rounded once. No
    autograd: `MaxBlurPool` is the differentiable form."""
    device = _build.kernel_device(x_bchw, "max_blur_pool")
    if device is None:
        return max_blur_pool_reference(x_bchw)
    b, c, h, w = check_args(x_bchw)
    lib = _build.load_library()
    with torch.cuda.device(device):
        out = torch.empty((b, c) + output_size(h, w), dtype=x_bchw.dtype,
                          device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.max_blur_pool_fwd(_build.DTYPE_CODES[x_bchw.dtype],
                                   x_bchw.data_ptr(), out.data_ptr(),
                                   b * c, h, w, rows_by_16_bytes(x_bchw, w),
                                   rows_by_16_bytes(out, out.shape[-1]),
                                   stream)
    _build.raise_on_error(lib, "max_blur_pool_fwd", rc)
    tracing.count("launch.max_blur_pool")
    return out


def max_blur_pool_bwd(x_bchw: torch.Tensor, g_bchw: torch.Tensor
                      ) -> torch.Tensor:
    """dx of `max_blur_pool` (K3-bwd), given the cotangent g (b, c, Ho,
    Wo) in x's dtype: the blur transpose of g, routed to the first
    maximum of each 2x2 window, summed in float32 and rounded once.
    Deterministic. CPU tensors go to `max_blur_pool_backward_reference`;
    CUDA tensors launch the kernel, or raise."""
    device = _build.kernel_device(x_bchw, "max_blur_pool_bwd")
    if device is None:
        return max_blur_pool_backward_reference(x_bchw, g_bchw)
    b, c, h, w = check_args(x_bchw)
    _build.check("g", g_bchw, x_bchw.dtype, (b, c) + output_size(h, w),
                 device)
    lib = _build.load_library()
    with torch.cuda.device(device):
        dx = torch.empty_like(x_bchw)
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.max_blur_pool_bwd(
            _build.DTYPE_CODES[x_bchw.dtype], x_bchw.data_ptr(),
            g_bchw.data_ptr(), dx.data_ptr(), b * c, h, w,
            rows_by_16_bytes(x_bchw, w) and rows_by_16_bytes(dx, w),
            rows_by_16_bytes(g_bchw, g_bchw.shape[-1]), stream)
    _build.raise_on_error(lib, "max_blur_pool_bwd", rc)
    tracing.count("launch.max_blur_pool_bwd")
    return dx


class MaxBlurPool(torch.autograd.Function):
    """The differentiable stem pool: forward `max_blur_pool` (K3-fwd),
    backward `max_blur_pool_bwd` (K3-bwd); on the CPU their plain
    versions. Saves only the input."""

    @staticmethod
    def forward(ctx, x_bchw):
        x = x_bchw.contiguous()
        ctx.save_for_backward(x)
        return max_blur_pool(x)

    @staticmethod
    def backward(ctx, g_bchw):
        (x,) = ctx.saved_tensors
        return max_blur_pool_bwd(x, g_bchw.to(x.dtype).contiguous())
