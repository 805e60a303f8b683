"""The device trace of a `--trace 1` run: `torch.profiler` over a fixed
number of steps or requests after the window, reduced to what the metric
readers (`metrics/<family>.py`) and the result's `breakdown` read.

- kernels: every device kernel with its interval and the names of the
  host operations it was launched under, innermost first;
- launches: the host's launch calls (CUDA runtime and driver), and a
  kernel that no recorded call launched counted once;
- busy: the union of the kernel intervals over all streams, clipped to
  the traced window; the window is the host range `benchmark.window`;
- idle gaps: the stretches of the window no kernel covers, each named by
  the innermost host operation running when it began.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

WINDOW = "benchmark.window"
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
                "cudaGraphLaunch", "cuGraphLaunch")
TOP = 10


@dataclass
class Kernel:
    name: str
    start_us: float
    end_us: float
    ops: Tuple[str, ...]        # host operations around its launch


@dataclass
class Trace:
    """What one traced window holds; `units` steps or requests ran."""
    units: int
    window_us: float
    kernels: List[Kernel] = field(default_factory=list)
    launches: int = 0
    busy_us: float = 0.0
    gaps: List[Tuple[str, float]] = field(default_factory=list)

    def device_ms(self, pick) -> float:
        """Device ms per unit of the kernels for which `pick(kernel)`."""
        return sum(k.end_us - k.start_us for k in self.kernels
                   if pick(k)) / 1e3 / self.units

    def breakdown(self) -> Dict:
        by_name = defaultdict(float)
        for k in self.kernels:
            by_name[k.name] += (k.end_us - k.start_us) / 1e6
        by_host = defaultdict(float)
        for name, us in self.gaps:
            by_host[name] += us / 1e6
        top = lambda d: [[n, s] for n, s in sorted(  # noqa: E731
            d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(by_name), "idle_gaps": top(by_host)}


def profiler():
    """A profiler of the host and the card, without shapes or stacks."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


@contextlib.contextmanager
def window():
    """The traced window's host range; the device is idle at both ends."""
    torch.cuda.synchronize()
    with torch.profiler.record_function(WINDOW):
        yield
        torch.cuda.synchronize()


def _span(e) -> Tuple[float, float]:
    """An event's (start, end) in microseconds."""
    if hasattr(e, "start_ns"):
        return e.start_ns() / 1e3, e.end_ns() / 1e3
    return e.start_us(), e.start_us() + e.duration_us()


def _host_tree(cpu: list) -> Dict[int, Tuple[str, ...]]:
    """For each host operation's correlation id, its name and those of
    the operations around it on its thread, innermost first."""
    by_thread = defaultdict(list)
    for e in cpu:
        if e.linked_correlation_id() == 0 and not e.is_async():
            s, t = _span(e)
            by_thread[e.start_thread_id()].append((s, -t, e.name(),
                                                   e.correlation_id()))
    names = {}
    for ops in by_thread.values():
        ops.sort()
        stack = []                      # (end, ancestry)
        for s, neg_end, name, cid in ops:
            while stack and stack[-1][0] < s:
                stack.pop()
            ancestry = (name,) + (stack[-1][1] if stack else ())
            stack.append((-neg_end, ancestry))
            names[cid] = ancestry
    return names


def reduce(prof, units: int) -> Trace:
    """The `Trace` of a finished profiler whose steps ran inside
    `window()`, read from its raw events."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    cpu = [e for e in events if e.device_type() == DeviceType.CPU]
    spans = [_span(e) for e in cpu if e.name() == WINDOW]
    if not spans:
        raise RuntimeError("the trace holds no benchmark.window range")
    w0, w1 = spans[0]
    tree = _host_tree(cpu)
    launch_ids = {e.correlation_id() for e in cpu if e.name() in LAUNCH_CALLS}
    trace = Trace(units=units, window_us=w1 - w0)
    unlaunched = 0
    for e in events:
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation() \
                or e.name() == WINDOW:
            continue
        start, end = _span(e)
        name = e.name()
        if end <= w0 or start >= w1 or name.startswith(("Memcpy", "Memset")):
            continue
        trace.kernels.append(Kernel(name, max(start, w0), min(end, w1),
                                    tree.get(e.linked_correlation_id(), ())))
        unlaunched += e.correlation_id() not in launch_ids
    trace.launches = unlaunched + sum(
        1 for e in cpu if e.name() in LAUNCH_CALLS
        and w0 <= _span(e)[0] <= w1)
    # the union of kernel intervals and the gaps between them
    edges = sorted((k.start_us, k.end_us) for k in trace.kernels)
    busy, cursor, gaps = 0.0, w0, []
    for s, e in edges:
        if s > cursor:
            gaps.append((cursor, s))
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    if cursor < w1:
        gaps.append((cursor, w1))
    trace.busy_us = busy
    host = sorted(_span(e) + (e.name(),) for e in cpu
                  if e.name() != WINDOW and not e.is_async()
                  and w0 <= _span(e)[0] <= w1)
    trace.gaps = [(_running_at(host, s), e - s) for s, e in gaps]
    return trace


def _running_at(host: list, t: float) -> str:
    """The innermost (latest-started) host operation running at `t`."""
    import bisect
    i = bisect.bisect_right(host, (t, float("inf"), ""))
    for start, end, name in reversed(host[max(0, i - 4000):i]):
        if start <= t <= end:
            return name
    return "host outside any recorded operation"
