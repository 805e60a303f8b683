"""Idle device ms a step charged to the port's blocking host syncs: the
stretches of the traced window that no kernel covers and that began
while a span `sr.sync.<site>` was the latest-started span running."""

from benchmark.metrics import program_spans


def read(ctx, variant):
    return program_spans.idle_ms(ctx, variant, sync=True)
