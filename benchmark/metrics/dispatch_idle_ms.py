"""Idle device ms a step or request charged to the port's host work: the
stretches of the traced window that no kernel covers, each charged to
the latest-started `sr.` span running when it began, summed over the
spans that are not host syncs (`sr.sync.*`)."""

from benchmark.metrics import program_spans


def read(ctx, variant):
    return program_spans.idle_ms(ctx, variant, sync=False)
