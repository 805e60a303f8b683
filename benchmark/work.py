"""The operations and bytes that the algorithm needs, reckoned from
shapes, and the published peaks of one NVIDIA H100 SXM (dense, without
sparsity, at its 700 W limit): the yardstick of the roofline and
utilisation metrics.

Shapes of the sweep are (b, k, h, w, c, d): batch, source views, the
matching feature map's height and width, its channels, depth planes. The
hero MLP is C_in -> 128 -> 128 -> 1 with C_in = c (k + 1) + 10 k + 4.
An element is `esize` bytes (2 for bf16, 4 for float32).
"""

from __future__ import annotations

PEAK_FLOPS = {"bf16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
HIDDEN = 128


def mlp_in_channels(k: int, c: int) -> int:
    return c * (k + 1) + 10 * k + 4


def sweep_work(shape, esize: int, backward: bool) -> tuple:
    """(operations, bytes) of the hero sweep's forward (K1) or backward
    (K2): the MLP products per (pixel, plane) (the backward: the
    recomputed forward, then d_w2, d_w1, d_h0, d_w0, and d_x over the
    sampled, reference and dot rows), each input read and each output
    written once."""
    b, k, h, w, c, d = shape
    n, hid = h * w, HIDDEN
    cin = mlp_in_channels(k, c)
    fwd = 2 * (cin * hid + hid * hid + hid)
    cells = b * d * n
    feats = (b * k * n * c + b * n * c) * esize
    weights = (cin * hid + hid * hid + hid) * esize
    if not backward:
        return fwd * cells, feats + weights + cells * 4
    bwd = fwd + 2 * hid + 2 * (hid * hid) * 2 + 2 * cin * hid \
        + 2 * ((k + 1) * c + k) * hid
    grads = (b * k * n * c + b * n * c) * 4 + (cin * hid + hid * hid
                                               + 3 * hid + 1) * 4
    return bwd * cells, feats + 2 * weights + cells * 4 + grads


def dot_sweep_work(shape, esize: int) -> tuple:
    """(operations, bytes) of the dot-product sweep's forward: per (view,
    plane, pixel) the projection (9 FMAs), c FMAs for each of the four
    taps, 4 to weight them and about 16 more (divide, tap weights, mask);
    each input read and the float32 volume written once."""
    b, k, h, w, c, d = shape
    n = h * w
    samples = b * d * n * k
    nbytes = ((b * k * n * c + b * n * c) * esize + b * d * n * 4
              + (2 * b * k * 16 + b * 16 + b * d) * 4)
    return samples * (2 * (9 + 4 * c + 4) + 16), nbytes


def dcur_work(shape, esize: int) -> tuple:
    """(operations, bytes) of the dot sweep's gradient for the reference
    features: per (view, plane, pixel) the projection, 5 products of the
    mask, g and the tap weights, c FMAs a tap and about 16 more; the
    source maps and g read and d_cur (b, N, c) float32 written once."""
    b, k, h, w, c, d = shape
    n = h * w
    samples = b * d * n * k
    nbytes = (b * k * n * c * esize + b * d * n * 4 + b * n * c * 4
              + (2 * b * k * 16 + b * 16 + b * d) * 4)
    return samples * (2 * (9 + 4 * c) + 5 + 16), nbytes


def scatter_work(shape, esize: int, dot: bool) -> tuple:
    """(operations, bytes) of the sum of each sample's gradient into the
    source features: per (sample, tap, channel) two products, a
    conversion and an add (the dot mode one product more a sample and
    channel); its inputs (the samples' gradients, or the dot model's g
    and reference features) read and d_src written once."""
    b, k, h, w, c, d = shape
    n = h * w
    samples = b * k * d * n
    ops = samples * c * (4 * 4 + (1 if dot else 0))
    inputs = (b * d * n * 4 + b * n * c * esize if dot
              else samples * c * esize)
    geometry = (b * k * 16 + b * 16 + b * d + 1) * 4
    return ops, inputs + geometry + b * k * n * c * 4


def pool_work(shape, esize: int, backward: bool) -> tuple:
    """(operations, bytes) of the stem's max-blur-pool on NCHW `shape`:
    three compares a 2x2 window and the 16-tap blur (or its transpose and
    one add a routed window) an output; the forward reads x and writes
    the output, the backward reads x and g and writes dx."""
    b, c, h, w = shape
    ho, wo = (h - 2) // 2 + 1, (w - 2) // 2 + 1
    planes = b * c
    windows, outs, ins = (planes * (h - 1) * (w - 1), planes * ho * wo,
                          planes * h * w)
    if not backward:
        return windows * 3 + outs * 32, (ins + outs) * esize
    return windows * 4 + outs * 32, (2 * ins + outs) * esize


def bound_ms(ops: float, nbytes: float, peak_flops: float) -> float:
    """The least time the card could take: the larger of the operations
    over `peak_flops` and the bytes over the memory bandwidth, in ms."""
    return max(ops / peak_flops, nbytes / PEAK_BYTES) * 1e3


def sweep_bound_ms(shape, esize: int, dot: bool, training: bool) -> float:
    """The sweep's bound for one step (`training`) or one forward: the
    hero's K1 (and K2 and the scatter) with its MLP on the bf16 tensor
    cores where `esize` is 2; the dot model's sweep (and its d_cur mode
    and the scatter's dot mode) on the float32 CUDA cores."""
    if dot:
        peak = PEAK_FLOPS["float32"]
        parts = [dot_sweep_work(shape, esize)]
        if training:
            parts += [dcur_work(shape, esize),
                      scatter_work(shape, esize, dot=True)]
    else:
        peak = PEAK_FLOPS["bf16" if esize == 2 else "float32"]
        parts = [sweep_work(shape, esize, backward=False)]
        if training:
            parts += [sweep_work(shape, esize, backward=True)]
    total = sum(bound_ms(ops, nbytes, peak) for ops, nbytes in parts)
    if training and not dot:
        # the scatter adds, on the float32 CUDA cores
        total += bound_ms(*scatter_work(shape, esize, dot=False),
                          PEAK_FLOPS["float32"])
    return total
