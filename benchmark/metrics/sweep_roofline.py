"""The plane sweep's share of its roofline: the least time the card could
take for the sweep's work at the cell's shapes (`work.sweep_bound_ms`:
the hero's K1 forward, K2 backward and the scatter; the dot model's
sweep, its d_cur mode and the scatter's dot mode; the forward alone when
serving) over the device time of the sweep's kernels a step or request.

The kernels are known by these names. A program whose sweep kernels are
renamed leaves the metric unread until a benchmark change names them."""

from benchmark import work

SWEEP_KERNELS = ("fused_sweep_mma_kernel", "fused_sweep_mlp_kernel",
                 "fused_sweep_bwd", "sum_partials_kernel",
                 "fused_sweep_dot_kernel", "sweep_scatter_kernel",
                 "fixed_to_float_kernel")


def sweep_shape(config, mix) -> tuple:
    """(batch a card, views, height, width, channels, planes) of the
    sweep at the matching scale."""
    f = 2 ** (config["matching_scale"] + 1)
    return (mix["batch_size"] // mix.get("ranks", 1),
            config["model_num_views"] - 1,
            config["image_height"] // f, config["image_width"] // f,
            config["matching_feature_dims"], config["matching_num_depth_bins"])


def read(ctx, variant):
    if ctx.trace is None or ctx.variant != variant:
        return None
    ms = ctx.trace.device_ms(lambda k: any(s in k.name
                                           for s in SWEEP_KERNELS))
    if ms <= 0:
        return None
    esize = 2 if str(ctx.config["precision"]) in ("16", "bf16") else 4
    dot = ctx.config["feature_volume_type"] == "simple_cost_volume"
    bound = work.sweep_bound_ms(sweep_shape(ctx.config, ctx.mix), esize,
                                dot=dot, training=variant == "train")
    return 100.0 * bound / ms
