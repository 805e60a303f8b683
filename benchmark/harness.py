"""The benchmark's general part: it reads `BENCHMARK.json`, finds each
name's file (a configuration at its `file`, and its plain reference at
the file's `reference`, which `benchmark/reference/__init__.py` loads; a
traffic mix at `benchmark/traffic/<mix>.json`, a cell's limits at
`benchmark/limits/<cell>.json`, the loop of a mix's `kind` at
`benchmark/loops/<kind>.py`, a per-layer metric `<family>.<variant>` at
`benchmark/metrics/<family>.py`), runs the loop, and builds the result
line. Nothing here names a cell, a configuration, a kind of traffic or a
metric: later configurations with their references, cells, mixes, loops
and metrics come as files and entries.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "simplerecon_tpu")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> Dict:
    return load_json(root / "BENCHMARK.json")


def cell_entry(bench: Dict, name: str) -> Dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config_path(bench: Dict, cell: Dict, root: Path = ROOT) -> Path:
    for config in bench["configs"]:
        if config["name"] == cell["config"]:
            return root / config["file"]
    raise KeyError(f"no configuration named {cell['config']!r}")


def traffic_path(cell: Dict, root: Path = ROOT) -> Path:
    return root / "benchmark" / "traffic" / f"{cell['traffic']}.json"


def limits_path(cell: Dict, root: Path = ROOT) -> Path:
    return root / "benchmark" / "limits" / f"{cell['name']}.json"


def reader_path(metric: str, root: Path = ROOT) -> Path:
    return root / "benchmark" / "metrics" / f"{metric.split('.')[0]}.py"


def load_reader(metric: str, root: Path = ROOT):
    """The module that reads `metric` (its `read(ctx, variant)`)."""
    path = reader_path(metric, root)
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_loop(kind: str):
    """The module of the loop that runs mixes of `kind` (its `run` and
    `readings`), `benchmark/loops/<kind>.py` of the `benchmark` package
    on the import path."""
    return importlib.import_module(f"benchmark.loops.{kind}")


def _applies(metric: Dict, cell: Dict) -> bool:
    return "workloads" not in metric or cell["name"] in metric["workloads"]


def end_to_end_for(bench: Dict, cell: Dict) -> List[Dict]:
    return [m for m in bench["end_to_end"] if _applies(m, cell)]


def per_layer_for(bench: Dict, cell: Dict) -> List[Dict]:
    moved = {m["name"] for m in end_to_end_for(bench, cell)}
    return [m for m in bench["per_layer"]
            if _applies(m, cell) and m["moves"] in moved]


def forbidden_modules(modules=None) -> List[str]:
    """The top-level names in `modules` (default `sys.modules`) that are
    JAX's or the JAX package's, each compared whole: the port's
    `simplerecon_tpu_torch` is not `simplerecon_tpu`."""
    names = {name.split(".")[0] for name in
             (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def process_seconds() -> float:
    """Seconds since this process started (its start time in
    /proc/self/stat against the system's uptime)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


class Context:
    """What a metric reader reads: the traced window (`trace`, None when
    none was traced on the card; rank 0's where there are ranks), the
    `variant` of the metrics the run reports ("train", "eval"), the
    configuration and the mix, the cards used, the samples a second of
    the untraced window (all ranks'), the peak of device memory, and the
    reference's operations a sample."""

    def __init__(self, config: Dict, mix: Dict, run, chips: int = 1):
        self.variant = run.variant
        self.config, self.mix, self.chips = config, mix, chips
        self.trace = run.trace
        self.samples_per_s = run.samples_per_s if run.trace else None
        self.peak_bytes = run.peak_bytes
        self._flops = run.flops

    def model_flops(self, backward: bool) -> Optional[float]:
        return self._flops.get(backward)


def device_record(device, count: int, peak: int, trace=None) -> Dict:
    import torch
    record = {"platform": "gpu" if device.type == "cuda" else device.type,
              "kind": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
              "count": count, "memory_peak_bytes": int(peak)}
    if trace is not None:
        record["busy_s"] = trace.busy_us / 1e6
        record["window_s"] = trace.window_us / 1e6
    return record


def run_cell(name: str, seed: int, seconds: float, traced: bool, device,
             root: Path = ROOT, overrides: Optional[Dict] = None) -> tuple:
    """Runs cell `name` once on `device`. Returns (result line as a
    dict, the compared numbers with their limits). `overrides` may replace
    keys of the configuration ("config") and of the mix ("mix"), for
    small CPU runs in tests."""
    from benchmark import check

    bench = load_benchmark(root)
    cell = cell_entry(bench, name)
    config = load_json(config_path(bench, cell, root))
    mix = load_json(traffic_path(cell, root))
    limits = load_json(limits_path(cell, root))
    overrides = overrides or {}
    config.update(overrides.get("config", {}))
    mix.update(overrides.get("mix", {}))
    loop = load_loop(mix["kind"])

    setup = {}
    run = loop.run(config, mix, seed, seconds, traced, device,
                   lambda: setup.setdefault("s", process_seconds()))
    values = dict(run.values, setup_s=setup["s"])

    metrics = {}
    if traced:
        ctx = Context(config, mix, run, cell["chips"])
        for metric in per_layer_for(bench, cell):
            family, _, variant = metric["name"].partition(".")
            value = load_reader(metric["name"], root).read(ctx, variant)
            if value is not None and math.isfinite(value):
                metrics[metric["name"]] = {"value": value,
                                           "unit": metric["unit"]}
    else:
        for metric in end_to_end_for(bench, cell):
            metrics[metric["name"]] = {"value": values[metric["name"]],
                                       "unit": metric["unit"]}
    correct, table = check.judge(run.numbers, limits)
    line = {"correct": correct, "attempted": run.attempted,
            "failed": run.failed, "metrics": metrics,
            "device": device_record(device, cell["chips"], run.peak_bytes,
                                    run.trace)}
    if traced and run.trace is not None:
        line["breakdown"] = run.trace.breakdown()
    line["checks"] = table
    return line, table
