"""The readers of the port's own spans and counters
(`metrics/program_spans.py` and the metrics that use it) on a synthetic
trace and recorder, and a traced tiny training run on the CPU."""

from __future__ import annotations

import math
import sys
import types

import pytest
import torch

from benchmark import harness
from benchmark.metrics import program_spans
from benchmark.trace import Kernel, Trace

SEED = 2 ** 31 + 4242
TINY = {"config": {"image_height": 64, "image_width": 96,
                   "matching_num_depth_bins": 16, "precision": "32"},
        "mix": {"batch_size": 2, "warmup_steps": 0, "warmup_requests": 1,
                "traced_units": 1, "sample_span": 4, "sampled": 2}}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def span(name, start_us, end_us):
    return types.SimpleNamespace(name=name, start_ns=int(start_us * 1e3),
                                 end_ns=int(end_us * 1e3),
                                 seconds=(end_us - start_us) / 1e6)


# one traced step from t = 1000 us to 1100 us, two steps' worth of units:
#   1000-1002 idle, before any span
#   1002-1010 prior kernel        1010-1015 idle in sr.sync.depth_planes
#   1015-1030 cost volume (a ctypes kernel: ops are the span itself)
#   1030-1040 idle in sr.cv_encoder
#   1040-1060 two overlapping backward kernels, one matching.backward
#             whose ops carry the stale cost_volume.backward name
#   1060-1070 idle, no span           1070-1090 optimizer kernel
#   1090-1100 idle, in sr.train_step
KERNELS = [
    Kernel("conv", 1002, 1010, ("aten::conv", "sr.prior", "sr.train_step")),
    Kernel("k1", 1015, 1030, ("sr.cost_volume", "sr.train_step")),
    Kernel("k2", 1040, 1050, ("aten::x", "sr.cost_volume.backward",
                              "MarkerBackward")),
    Kernel("mm", 1045, 1060, ("aten::mm", "sr.matching.backward",
                              "MarkerBackward", "sr.cost_volume.backward")),
    Kernel("adam", 1070, 1090, ("aten::add", "sr.optimizer",
                                "sr.train_step")),
]
SPANS = [span("sr.train_step", 1001, 1059),
         span("sr.prior", 1001.5, 1003),
         span("sr.cost_volume", 1009, 1016),
         span("sr.sync.depth_planes", 1009.5, 1015),
         span("sr.cv_encoder", 1029, 1041),
         span("sr.train_step", 1065, 1095)]


def trace_of(kernels, w0=1000.0, w1=1100.0, units=2):
    """A `Trace` as `benchmark/trace.py::reduce` builds it."""
    t = Trace(units=units, window_us=w1 - w0, kernels=list(kernels))
    busy, cursor, gaps = 0.0, w0, []
    for s, e in sorted((k.start_us, k.end_us) for k in kernels):
        if s > cursor:
            gaps.append(("op", s - cursor))
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    if cursor < w1:
        gaps.append(("op", w1 - cursor))
    t.busy_us, t.gaps = busy, gaps
    return t


def context(trace, variant="train"):
    return types.SimpleNamespace(trace=trace, variant=variant)


@pytest.fixture
def recorder(monkeypatch):
    """A stand-in for the port's recorder module in `sys.modules`."""
    fake = types.SimpleNamespace(
        recorded=lambda: list(SPANS),
        counters=lambda: {"host_syncs": 12, "train_steps": 3},
        first=lambda name: {
            "sr.train_step": span("sr.train_step", 0, 2.5e6),
            "sr.kernel_build": span("sr.kernel_build", 0.5e6, 2e6),
            "sr.forward": span("sr.forward", 3e6, 3.5e6)}.get(name))
    monkeypatch.setitem(sys.modules, "simplerecon_tpu_torch.tracing", fake)
    return fake


def read(metric, ctx):
    variant = metric.partition(".")[2]
    return harness.load_reader(metric).read(ctx, variant)


def test_device_ms_by_stage_takes_the_innermost_stage():
    ctx = context(trace_of(KERNELS))
    assert read("prior_device_ms.train", ctx) == pytest.approx(8 / 1e3 / 2)
    # K1 under its span alone, K2 under the cost volume's backward
    assert read("cost_volume_device_ms.train", ctx) == pytest.approx(
        25 / 1e3 / 2)
    # the stale cost-volume name does not take the matching kernel
    assert read("matching_device_ms.train", ctx) == pytest.approx(
        15 / 1e3 / 2)
    assert read("optimizer_device_ms.train", ctx) == pytest.approx(
        20 / 1e3 / 2)
    assert read("decoder_device_ms.train", ctx) is None
    assert read("prior_device_ms.eval", ctx) is None
    assert read("prior_device_ms.train", context(None)) is None


def test_window_edges_and_idle_stretches():
    t = trace_of(KERNELS)
    assert program_spans.window_edges(t) == (1000.0, 1100.0)
    assert program_spans.idle_stretches(t) == [
        (1000.0, 1002), (1010, 1015), (1030, 1040), (1060, 1070),
        (1090, 1100.0)]
    # no idle stretch before the first kernel, or none after the last
    for w0, w1 in ((1002.0, 1100.0), (1000.0, 1090.0)):
        assert program_spans.window_edges(trace_of(KERNELS, w0, w1)) == (
            w0, w1)


def test_idle_is_charged_to_sync_and_to_dispatch(recorder):
    ctx = context(trace_of(KERNELS))
    charged = program_spans.charged_idle(ctx.trace, SPANS)
    assert charged == {"sr.sync.depth_planes": 5, "sr.cv_encoder": 10,
                       "sr.train_step": 10}
    assert read("sync_wait_ms.train", ctx) == pytest.approx(5 / 1e3 / 2)
    assert read("dispatch_idle_ms.train", ctx) == pytest.approx(
        20 / 1e3 / 2)
    assert read("dispatch_idle_ms.eval", ctx) is None


def test_host_syncs_reads_the_counters_a_step(recorder):
    assert read("host_syncs.train", context(None)) == 4.0
    assert read("host_syncs.train", context(None, "eval")) is None


def test_first_call_leaves_out_the_kernel_build(recorder):
    ctx = context(None)
    # the build inside the first step is left out of it
    assert read("first_call_s.train", ctx) == pytest.approx(1.0)
    # a build outside the first forward leaves it whole
    assert read("first_call_s.eval", context(None, "eval")) == \
        pytest.approx(0.5)
    assert read("first_call_s.train", context(None, "eval")) is None


def test_readers_find_nothing_without_the_recorder(monkeypatch):
    monkeypatch.delitem(sys.modules, "simplerecon_tpu_torch.tracing",
                        raising=False)
    ctx = context(trace_of(KERNELS))
    for metric in ("dispatch_idle_ms.train", "sync_wait_ms.train",
                   "host_syncs.train", "first_call_s.train"):
        assert read(metric, ctx) is None, metric


def test_traced_training_line_reads_the_recorder():
    """A tiny traced run on the CPU (no device trace there): the counter
    and first-call readers read the port's recorder; no host sync waits
    on the CPU."""
    bench = harness.load_benchmark()
    line, table = harness.run_cell(
        "hero_train_b16", SEED, 0.2, True, torch.device("cpu"),
        overrides={"config": TINY["config"], "mix": TINY["mix"]})
    assert line["correct"], table
    metrics = line["metrics"]
    assert metrics["host_syncs.train"]["value"] == 0
    assert metrics["first_call_s.train"]["value"] > 0
    names = {m["name"] for m in harness.per_layer_for(
        bench, harness.cell_entry(bench, "hero_train_b16"))}
    assert set(metrics) <= names
    assert all(math.isfinite(m["value"]) for m in metrics.values())

