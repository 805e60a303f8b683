"""The share of the traced window that no kernel covers, over the union
of kernel intervals on all streams."""


def read(ctx, variant):
    if ctx.trace is None or ctx.variant != variant or ctx.trace.window_us <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_us / ctx.trace.window_us)
