"""The port's one recorder of spans and counters.

`span(name)` times a stretch of host work on the calling thread: its
name, start and end, the index of the span around it on the same thread
(`parent`), and the ordinal of the step or request it belongs to
(`unit`: a span named in UNITS opens a new one, and every span opened
until the next, on any thread, shares it). `count(name, n)` adds to a
counter; `counters()` reads them and `reset_counters()` zeroes them.
Span names start with "sr.".

Times are Unix nanoseconds (`time.time_ns`), the clock of the torch
profiler's events (`prof.profiler.kineto_results.events()`), so spans
and the device's kernels lie on one timeline.

While the torch profiler records, each span also opens a profiler range
of its name, and the recorder keeps every span (`recorded()`). The range
is a function-scope one (`_RecordFunctionFast`), not a user annotation
(`record_function`): the kernels of the hand-written wrappers are
launched through ctypes under no operator, and the profiler links a
kernel to the innermost function-scope range around its launch, never
to a user annotation. While the profiler does not record, a span costs a
flag check and two clock reads, and the recorder keeps only the first
(`first(name)`) and the latest (`last(name)`) occurrence of each name,
so its memory does not grow with the steps.

Backward: the autograd engine runs a CUDA backward on its own device
thread, which no range of the calling thread encloses. While the
profiler records, `mark(stage, tensors)` puts an identity autograd node
on a stage's outputs; when the engine reaches it, the stage's gradients
are about to be taken, so it closes the thread's open backward span and
opens `sr.<stage>.backward`; a callback of the engine closes the last
when the backward ends. With the profiler off no node enters the graph.

The profiler is the exporter: there is no other.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional, Sequence

import torch
from torch.autograd import profiler as _profiler

# the spans that open a step or a request
UNITS = ("sr.train_step", "sr.forward")


def _profiling() -> bool:
    return _profiler._is_profiler_enabled


class Span:
    """One span: a context manager that enters it in its recorder. After
    exit, `seconds` is its host time."""

    __slots__ = ("recorder", "name", "start_ns", "end_ns", "parent", "unit",
                 "index", "_range")

    def __init__(self, recorder: "Recorder", name: str):
        self.recorder = recorder
        self.name = name
        self.start_ns = self.end_ns = 0
        self._range = None

    def __enter__(self) -> "Span":
        self.recorder.enter(self)
        return self

    def __exit__(self, *exc) -> None:
        self.recorder.exit(self)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class Recorder:
    """Spans and counters of one process (see the module's docstring)."""

    def __init__(self):
        self._spans: List[Span] = []        # while the profiler records
        self._first: Dict[str, Span] = {}
        self._last: Dict[str, Span] = {}
        self._counters: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._local = threading.local()     # each thread's open spans
        self._backward: Dict[int, Span] = {}    # open, by thread
        self._index = itertools.count()
        self.unit = -1

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def span(self, name: str) -> Span:
        return Span(self, name)

    def enter(self, s: Span) -> None:
        stack = self._stack()
        s.parent = stack[-1].index if stack else -1
        s.index = next(self._index)
        if s.name in UNITS:
            self.unit += 1
        s.unit = self.unit
        if _profiling():
            s._range = torch._C._profiler._RecordFunctionFast(s.name)
            s._range.__enter__()
        stack.append(s)
        s.start_ns = time.time_ns()

    def exit(self, s: Span) -> None:
        s.end_ns = time.time_ns()
        stack = self._stack()
        if stack and stack[-1] is s:
            stack.pop()
        elif s in stack:
            stack.remove(s)
        if s._range is not None:
            s._range.__exit__(None, None, None)
            s._range = None
            self._spans.append(s)
        self._first.setdefault(s.name, s)
        self._last[s.name] = s

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def reset_counters(self) -> None:
        with self._lock:
            self._counters.clear()

    def first(self, name: str) -> Optional[Span]:
        return self._first.get(name)

    def last(self, name: str) -> Optional[Span]:
        return self._last.get(name)

    def recorded(self) -> List[Span]:
        """Every span closed while the profiler recorded."""
        return list(self._spans)

    # ---------------------------------------------------------------- backward

    def backward_stage(self, stage: str) -> None:
        """Called on the engine's thread as it reaches `stage`'s marker:
        the thread's open backward span ends, `sr.<stage>.backward`
        begins; the first of a backward queues the engine callback that
        ends the last."""
        tid = threading.get_ident()
        done = self._backward.pop(tid, None)
        if done is not None:
            self.exit(done)
        elif not self._backward:
            torch.autograd.Variable._execution_engine.queue_callback(
                self._end_backward)
        s = Span(self, f"sr.{stage}.backward")
        self.enter(s)
        self._backward[tid] = s

    def _end_backward(self) -> None:
        done = self._backward.pop(threading.get_ident(), None)
        if done is not None:
            self.exit(done)
        # a span left open on another thread ends here too
        for tid in list(self._backward):
            self.exit(self._backward.pop(tid))


RECORDER = Recorder()


def span(name: str) -> Span:
    """A span of the process's recorder: `with span("sr.prior"): ...`."""
    return Span(RECORDER, name)


def sync(site: str, device, syncs: int = 1) -> Span:
    """The span `sr.sync.<site>` around `syncs` blocking host syncs with
    `device`, counted in `host_syncs` where the host waits: on a CUDA
    device (`tests/test_torch_port_gpu.py` holds the count to the CUDA
    runtime's synchronizing calls in a profiled step)."""
    if device is not None and torch.device(device).type == "cuda":
        RECORDER.count("host_syncs", syncs)
    return Span(RECORDER, "sr.sync." + site)


def count(name: str, n: int = 1) -> None:
    RECORDER.count(name, n)


def counters() -> Dict[str, int]:
    return RECORDER.counters()


def reset_counters() -> None:
    RECORDER.reset_counters()


def first(name: str) -> Optional[Span]:
    """The process's first span named `name`, or None."""
    return RECORDER.first(name)


def last(name: str) -> Optional[Span]:
    """The latest span named `name` closed, or None."""
    return RECORDER.last(name)


def recorded() -> List[Span]:
    return RECORDER.recorded()


class _Marker(torch.autograd.Function):
    """Identity on a stage's outputs; its backward opens the stage's
    backward span on the engine's thread."""

    @staticmethod
    def forward(ctx, stage, *tensors):
        ctx.stage = stage
        ctx.set_materialize_grads(False)
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        RECORDER.backward_stage(ctx.stage)
        return (None,) + grads


def mark(stage: str, tensors: Sequence[Optional[torch.Tensor]]) -> list:
    """`tensors` (a sequence; None entries pass), those that take a
    gradient passed through one marker of `stage` while the profiler
    records and gradients are on; otherwise the same tensors."""
    tensors = list(tensors)
    if not _profiling() or not torch.is_grad_enabled():
        return tensors
    at = [i for i, t in enumerate(tensors)
          if t is not None and t.requires_grad]
    if at:
        marked = _Marker.apply(stage, *[tensors[i] for i in at])
        for i, t in zip(at, marked):
            tensors[i] = t
    return tensors
