"""`torch.cuda.max_memory_allocated` over set-up and the window, GiB."""


def read(ctx, variant):
    if ctx.variant != variant or not ctx.peak_bytes:
        return None
    return ctx.peak_bytes / 2 ** 30
