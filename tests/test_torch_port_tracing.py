"""The port's recorder (`simplerecon_tpu_torch/tracing.py`): the span
tree, ordinals, first occurrences and counters; bounded memory, no
profiler range and no autograd marker while the profiler is off; the
clock shared with the profiler's events; and one profiled training step
of the tiny hero model, whose forward stages, backward stages and host
syncs the spans must cover. CPU only, a few seconds."""

import threading
from collections import defaultdict

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from simplerecon_tpu_torch import tracing
from simplerecon_tpu_torch.models.depth_model import build_depth_model
from simplerecon_tpu_torch.parallel import train
from simplerecon_tpu_torch.testing import hero_options, train_batch
from test_torch_port_ops import few_torch_threads  # noqa: F401 (autouse)

OPTS = hero_options(image_height=64, image_width=96,
                    matching_num_depth_bins=8, model_num_views=3,
                    precision="32")
FORWARD = ("prior", "matching", "cost_volume", "cv_encoder", "decoder",
           "losses")
# the engine takes the stages back in the reverse order of the forward
BACKWARD = tuple(f"sr.{s}.backward" for s in reversed(FORWARD))
# the host-sync spans of one step of the tiny model on the CPU: the
# card's sites (PERF.md) and the plain sweep's warp, forward and backward
SYNC_SPANS = {"depth_planes": 1, "loss_scale": 1, "grad_finite": 1,
              "warp_scale": 2}


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_span_tree_ordinals_first_occurrences_and_counters():
    rec = tracing.Recorder()
    for step in range(2):
        with rec.span("sr.train_step") as outer:
            with rec.span("sr.prior") as inner:
                rec.count("launch.k")
            rec.count("launch.k", 2)
        assert inner.parent == outer.index and outer.parent == -1
        assert inner.unit == outer.unit == step
        assert outer.start_ns <= inner.start_ns <= inner.end_ns \
            <= outer.end_ns
    with rec.span("sr.loader.wait") as after:
        pass
    assert after.unit == 1      # the latest step's ordinal
    first = rec.first("sr.prior")
    assert first.unit == 0 and rec.last("sr.prior").unit == 1
    assert rec.first("sr.none") is None
    assert rec.counters() == {"launch.k": 6}
    rec.reset_counters()
    assert rec.counters() == {}
    # spans of another thread have their own parents
    seen = {}

    def other():
        with rec.span("sr.forward") as s:
            seen["s"] = s
    with rec.span("sr.train_step"):
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=10)
    assert not t.is_alive() and seen["s"].parent == -1


def test_profiler_off_keeps_memory_bounded_and_opens_no_range(monkeypatch):
    calls = []
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        lambda name: calls.append(name))
    rec = tracing.Recorder()
    for i in range(1000):
        with rec.span("sr.train_step"):
            with rec.span(f"sr.stage{i % 3}"):
                pass
    assert calls == [] and rec.recorded() == []
    assert len(rec._first) == 4 and len(rec._last) == 4
    assert rec.first("sr.train_step").unit == 0
    assert rec.last("sr.train_step").unit == 999


def test_spans_share_the_profiler_clock():
    rec = tracing.Recorder()
    with cpu_profile() as prof:
        with rec.span("sr.clock") as s:
            torch.ones(1000).sum()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "sr.clock"]
    assert len(events) == 1 and rec.recorded() == [s]
    assert abs(events[0].start_ns() - s.start_ns) < 1e6
    assert abs(events[0].end_ns() - s.end_ns) < 1e6


@pytest.fixture(scope="module")
def tiny_step():
    """The tiny hero model after one unprofiled step, then one profiled
    step: (its profiler events, the recorder's spans and counter
    increments of the profiled step)."""
    model = build_depth_model(OPTS, device="cpu", seed=0)
    optimizer = train.make_optimizer(OPTS, model)
    batch = train.batch_to_device(train_batch(OPTS, 2, seed=1), "cpu")
    generator = torch.Generator().manual_seed(0)
    train.train_step(model, optimizer, batch, generator)
    before = tracing.counters()
    known = len(tracing.recorded())
    with cpu_profile() as prof:
        train.train_step(model, optimizer, batch, generator)
    after = tracing.counters()
    counted = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    spans = tracing.recorded()[known:]
    return prof.profiler.kineto_results.events(), spans, counted


def _ranges(events, prefix):
    """(start, end, thread) of the events whose names start `prefix`,
    by name."""
    out = defaultdict(list)
    for e in events:
        if e.name().startswith(prefix):
            out[e.name()].append((e.start_ns(), e.end_ns(),
                                  e.start_thread_id()))
    return out


def _inside(event, ranges):
    return any(s <= event.start_ns() and event.end_ns() <= e
               and t == event.start_thread_id() for s, e, t in ranges)


def test_profiled_step_puts_each_forward_stage_under_its_span(tiny_step):
    events, spans, _ = tiny_step
    ranges = _ranges(events, "sr.")
    aten = [e for e in events if e.name().startswith("aten::")]
    units = {s.unit for s in spans}
    assert len(units) == 1
    for stage in FORWARD:
        (span,) = ranges[f"sr.{stage}"]
        assert any(_inside(e, [span]) for e in aten), stage
    stage_ranges = [r for s in ("prior", "matching", "cv_encoder",
                                "decoder") for r in ranges[f"sr.{s}"]]
    forward = [e for e in aten if e.name() == "aten::convolution"
               and not _inside(e, ranges["sr.backward"])]
    assert forward and all(_inside(e, stage_ranges) for e in forward)
    # the forward stages follow one another on the step's thread
    order = sorted((ranges[f"sr.{s}"][0][0], s) for s in FORWARD)
    assert [s for _, s in order] == list(FORWARD)


def test_profiled_step_puts_every_backward_operator_under_a_stage(
        tiny_step):
    events, spans, _ = tiny_step
    ranges = _ranges(events, "sr.")
    backward = [s.name for s in spans if s.name.endswith(".backward")
                and s.name != "sr.backward"]
    assert tuple(backward) == BACKWARD
    stage_ranges = [r for name in BACKWARD for r in ranges[name]]
    nodes = [e for e in events
             if e.name().startswith("autograd::engine::evaluate_function")
             and "_MarkerBackward" not in e.name()]
    assert nodes and all(_inside(e, stage_ranges) for e in nodes), [
        e.name() for e in nodes if not _inside(e, stage_ranges)][:5]
    # the plain sweep's backward runs in the cost volume's stage
    sweep = [e for e in nodes if "FusedSweepBackward" in e.name()]
    assert sweep and all(_inside(e, ranges["sr.cost_volume.backward"])
                         for e in sweep)


def test_profiled_step_counts_its_host_syncs(tiny_step, monkeypatch):
    _, spans, counted = tiny_step
    assert counted["train_steps"] == 1
    sites = defaultdict(int)
    for span in spans:
        if span.name.startswith("sr.sync."):
            sites[span.name[len("sr.sync."):]] += 1
    assert dict(sites) == SYNC_SPANS
    # a host tensor waits for nothing: no sync is counted on the CPU
    assert counted.get("host_syncs", 0) == 0
    rec = tracing.Recorder()
    monkeypatch.setattr(tracing, "RECORDER", rec)
    with tracing.sync("site", torch.device("cuda", 0), 2):
        pass
    with tracing.sync("site", "cpu"), tracing.sync("site", None):
        pass
    assert rec.counters() == {"host_syncs": 2}


def test_profiler_off_step_adds_no_marker(monkeypatch):
    model = build_depth_model(OPTS, device="cpu", seed=0).train()
    batch = train.batch_to_device(train_batch(OPTS, 2, seed=1), "cpu")
    applied = []
    monkeypatch.setattr(tracing._Marker, "apply",
                        lambda *a: applied.append(a[0]))
    loss_dict, _ = train.forward_and_losses(model, batch, flip=True)
    assert applied == []
    seen, todo = set(), [loss_dict["loss"].grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        assert "Marker" not in node.name()
        todo.extend(fn for fn, _ in node.next_functions)
    assert len(seen) > 100
