"""Device ms a step or request of the kernels launched in the span
`sr.cv_encoder` or `sr.cv_encoder.backward` of the port: the cost-volume
encoder with the volume's permute and flip, forward and backward."""

from benchmark.metrics import program_spans


def read(ctx, variant):
    return program_spans.stage_device_ms(ctx, variant, "cv_encoder")
