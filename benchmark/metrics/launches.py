"""Host launch calls a training step (`launches.train`) or a served
request (`launches.eval`): the CUDA runtime's and driver's kernel
launches the profiler records, the port's hand-written kernels launched
through ctypes among them, and a kernel that no recorded call launched
counted once; over the traced steps or requests."""


def read(ctx, variant):
    if ctx.trace is None or ctx.variant != variant or ctx.trace.launches == 0:
        return None
    return ctx.trace.launches / ctx.trace.units
