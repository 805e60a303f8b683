"""Host seconds of the process's first training step (`.train`, its span
`sr.train_step`) or first forward (`.eval`, `sr.forward`: the device
work still queued when it returns is not counted), from the port's
recorder, which keeps each span's first occurrence. Finding or building
the kernels' library (`sr.kernel_build`) is left out where the first
call holds it: a checkout's first run compiles there, a later one only
loads."""

from benchmark.metrics import program_spans

UNIT_SPANS = {"train": "sr.train_step", "eval": "sr.forward"}


def read(ctx, variant):
    tracing = program_spans.recorder()
    if tracing is None or ctx.variant != variant:
        return None
    first = tracing.first(UNIT_SPANS.get(variant, ""))
    if first is None:
        return None
    build = tracing.first("sr.kernel_build")
    inside = (build is not None and first.start_ns <= build.start_ns
              and build.end_ns <= first.end_ns)
    return first.seconds - (build.seconds if inside else 0.0)
