"""Device ms a step or request of the kernels launched in the span
`sr.matching` or `sr.matching.backward` of the port: the matching
encoder with the reshape and flip of its output, forward and backward."""

from benchmark.metrics import program_spans


def read(ctx, variant):
    return program_spans.stage_device_ms(ctx, variant, "matching")
