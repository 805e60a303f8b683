"""Device ms a step or request of the kernels launched under the aten
convolution operators, forward and backward: cuDNN's kernels with its
layout transposes."""

CONV_OPS = ("aten::convolution", "aten::_convolution",
            "aten::cudnn_convolution", "aten::convolution_backward",
            "aten::cudnn_convolution_transpose", "aten::conv2d")


def read(ctx, variant):
    if ctx.trace is None or ctx.variant != variant:
        return None
    ms = ctx.trace.device_ms(lambda k: any(op in CONV_OPS for op in k.ops))
    return ms if ms > 0 else None
