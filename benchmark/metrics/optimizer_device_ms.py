"""Device ms a step or request of the kernels launched in the span
`sr.optimizer` or `sr.optimizer.backward` of the port: the optimizer's
step: the global norm, its finite check and AdamW."""

from benchmark.metrics import program_spans


def read(ctx, variant):
    return program_spans.stage_device_ms(ctx, variant, "optimizer")
