"""Device ms a step or request of the kernels launched in the span
`sr.cost_volume` or `sr.cost_volume.backward` of the port: the cost
volume (K1, K2 and the scatter on the hero, K1-dot, its d_cur mode and
the scatter's dot mode on the dot model, the metadata and the mask),
forward and backward."""

from benchmark.metrics import program_spans


def read(ctx, variant):
    return program_spans.stage_device_ms(ctx, variant, "cost_volume")
