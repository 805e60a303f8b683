"""The whole step's (or forward's) share of the card's bf16 dense peak:
the model's operations a sample at the cell's shapes, counted once on the
plain reference (`torch.utils.flop_counter`, forward, and backward when
training), times the samples a second of the untraced window, over
989 TFLOP/s a card used."""

from benchmark import work


def read(ctx, variant):
    if ctx.variant != variant or not ctx.samples_per_s:
        return None
    flops = ctx.model_flops(backward=variant == "train")
    if not flops:
        return None
    return 100.0 * flops * ctx.samples_per_s / (work.PEAK_FLOPS["bf16"]
                                                 * ctx.chips)
