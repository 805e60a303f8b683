"""Blocking host syncs a training step: the port's counter `host_syncs`
(counted at each `sr.sync.<site>` where the host waits for the card)
over its counter `train_steps` (one at each `sr.train_step`), over every
step of the run. The port's card tests hold the counter to the CUDA
runtime's synchronizing calls in a profiled step."""

from benchmark.metrics import program_spans


def read(ctx, variant):
    tracing = program_spans.recorder()
    if tracing is None or ctx.variant != variant:
        return None
    counts = tracing.counters()
    steps = counts.get("train_steps", 0)
    return counts.get("host_syncs", 0) / steps if steps else None
