"""Device ms a step or request of the kernels launched in the span
`sr.prior` or `sr.prior.backward` of the port: the image prior
(EfficientNetV2-S), forward and backward."""

from benchmark.metrics import program_spans


def read(ctx, variant):
    return program_spans.stage_device_ms(ctx, variant, "prior")
