"""The port's operations: geometry, sampling, image filters, and the
wrappers of the hand-written CUDA kernels, each counting its launches
in its `launches` attribute."""


def kernel_wrappers() -> tuple:
    """Every wrapper that launches a kernel of `csrc/`."""
    from simplerecon_tpu_torch.ops import cuda_cv, early_sweeps, pool
    return (cuda_cv.fused_sweep, cuda_cv.fused_sweep_bwd,
            cuda_cv.sweep_scatter, cuda_cv.dot_sweep, cuda_cv.dot_sweep_dcur,
            pool.max_blur_pool, pool.max_blur_pool_bwd,
            early_sweeps.fused_feature_volume,
            early_sweeps.fused_warp_feature_volume)


def launch_counts() -> dict:
    """The launches each wrapper has counted in this process, by the
    wrapper's name."""
    return {fn.__name__: fn.launches for fn in kernel_wrappers()}
