"""Device ms a step or request of the kernels launched in the span
`sr.decoder` or `sr.decoder.backward` of the port: the depth decoder
with the outputs' exp and flip, forward and backward."""

from benchmark.metrics import program_spans


def read(ctx, variant):
    return program_spans.stage_device_ms(ctx, variant, "decoder")
