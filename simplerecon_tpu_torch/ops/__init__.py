"""The port's operations: geometry, sampling, image filters, and the
wrappers of the hand-written CUDA kernels, each counting its launches
in the recorder's counter `launch.<wrapper>` (`tracing.py`)."""


def kernel_wrappers() -> tuple:
    """Every wrapper that launches a kernel of `csrc/`."""
    from simplerecon_tpu_torch.ops import cuda_cv, early_sweeps, pool
    return (cuda_cv.fused_sweep, cuda_cv.fused_sweep_bwd,
            cuda_cv.sweep_scatter, cuda_cv.dot_sweep, cuda_cv.dot_sweep_dcur,
            pool.max_blur_pool, pool.max_blur_pool_bwd,
            early_sweeps.fused_feature_volume,
            early_sweeps.fused_warp_feature_volume)


def launch_counts() -> dict:
    """The launches each wrapper has counted in this process since the
    recorder's counters were last reset, by the wrapper's name."""
    from simplerecon_tpu_torch import tracing
    counts = tracing.counters()
    return {fn.__name__: counts.get("launch." + fn.__name__, 0)
            for fn in kernel_wrappers()}
