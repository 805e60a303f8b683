"""What the readers of the port's own spans share (`*_device_ms`,
`dispatch_idle_ms`, `sync_wait_ms`, `host_syncs`, `first_call_s`): the
recorder of the process that ran the loop
(`simplerecon_tpu_torch.tracing`, read only where the port has already
loaded it: a program without it leaves these metrics unread), the
stage of each traced kernel, and the traced window's idle stretches,
each charged to the span running when it began.

A kernel's stage is the innermost stage span among the host operations
around its launch (`Kernel.ops`, innermost first): `sr.<stage>` in the
forward, `sr.<stage>.backward` on the autograd engine's thread. Taking
the innermost matters there: a backward span ends inside the engine's
call of the next stage's marker, so the trace nests the next stage's
operations under both.
"""

from __future__ import annotations

import bisect
import sys
from typing import Dict, List, Optional, Tuple

STAGES = ("prior", "matching", "cost_volume", "cv_encoder", "decoder",
          "losses", "optimizer")


def recorder():
    """The port's recorder module, or None where the process holds
    none."""
    return sys.modules.get("simplerecon_tpu_torch.tracing")


def stage_of(kernel) -> Optional[str]:
    for op in kernel.ops:
        if op.startswith("sr."):
            name = op[3:]
            if name.endswith(".backward"):
                name = name[:-len(".backward")]
            if name in STAGES:
                return name
    return None


def stage_device_ms(ctx, variant: str, stage: str) -> Optional[float]:
    """Device ms a step or request of the kernels of `stage`, forward
    and backward."""
    if ctx.trace is None or ctx.variant != variant:
        return None
    ms = ctx.trace.device_ms(lambda k: stage_of(k) == stage)
    return ms if ms > 0 else None


def window_edges(trace) -> Tuple[float, float]:
    """(start, end) of the traced window in microseconds: the first
    kernel's start less the idle stretch before it, which `trace.gaps`
    lists first when there is one."""
    edges = sorted((k.start_us, k.end_us) for k in trace.kernels)
    inner, cursor = [], edges[0][0]
    for s, e in edges:
        if s > cursor:
            inner.append(s - cursor)
        cursor = max(cursor, e)
    lengths = [length for _, length in trace.gaps]
    extra = len(lengths) - len(inner)
    lead = extra == 2 or (extra == 1 and lengths[:len(inner)] != inner)
    w0 = edges[0][0] - (lengths[0] if lead else 0.0)
    return w0, w0 + trace.window_us


def idle_stretches(trace) -> List[Tuple[float, float]]:
    """(start, end) in microseconds of each stretch of the traced window
    that no kernel covers."""
    if not trace.kernels:
        return []
    w0, w1 = window_edges(trace)
    out, cursor = [], w0
    for s, e in sorted((k.start_us, k.end_us) for k in trace.kernels):
        if s > cursor:
            out.append((cursor, s))
        cursor = max(cursor, e)
    if cursor < w1:
        out.append((cursor, w1))
    return out


def charged_idle(trace, spans) -> Dict[str, float]:
    """Idle microseconds of the window by the `sr.` span charged with
    them: the latest-started one, on any thread, running when a stretch
    began (stretches that begin outside every span are left out)."""
    timed = sorted((s.start_ns / 1e3, s.end_ns / 1e3, s.name) for s in spans
                   if s.name.startswith("sr."))
    starts = [t[0] for t in timed]
    out: Dict[str, float] = {}
    for begin, end in idle_stretches(trace):
        for start, stop, name in reversed(
                timed[:bisect.bisect_right(starts, begin)]):
            if stop >= begin:
                out[name] = out.get(name, 0.0) + (end - begin)
                break
    return out


def idle_ms(ctx, variant: str, sync: bool) -> Optional[float]:
    """Idle ms a step or request charged to `sr.sync.*` spans (`sync`)
    or to the other `sr.` spans."""
    tracing = recorder()
    if ctx.trace is None or ctx.variant != variant or tracing is None:
        return None
    spans = tracing.recorded()
    if not spans:
        return None
    charged = charged_idle(ctx.trace, spans)
    us = sum(t for name, t in charged.items()
             if name.startswith("sr.sync.") == sync)
    return us / 1e3 / ctx.trace.units
