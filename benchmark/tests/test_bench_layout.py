"""The benchmark's files: every name in BENCHMARK.json resolves to its
file, the file keeps the contract's shape, new mixes, loops and metrics
are taken up as added files, and the work counts match hand counts."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import harness, work

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return harness.load_benchmark()


def test_every_name_resolves_to_its_file(bench):
    for cell in bench["workloads"]:
        assert harness.config_path(bench, cell).is_file()
        assert harness.traffic_path(cell).is_file()
        assert harness.limits_path(cell).is_file()
        mix = harness.load_json(harness.traffic_path(cell))
        loop = harness.load_loop(mix["kind"])
        assert callable(loop.run) and callable(loop.readings)
        limits = harness.load_json(harness.limits_path(cell))
        assert limits and all(v >= 0 for v in limits.values())
    for metric in bench["per_layer"]:
        assert callable(harness.load_reader(metric["name"]).read)
    for config in bench["configs"]:
        assert (ROOT / config["file"]).is_file()
        assert config["file"].startswith(tuple(bench["paths"]))


def test_benchmark_file_keeps_the_contract(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [c["name"] for c in bench["workloads"] + bench["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    cells = {c["name"]: c for c in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
    for cell in bench["workloads"]:
        assert len(harness.end_to_end_for(bench, cell)) >= 2
        assert harness.per_layer_for(bench, cell)
    four = sum(c["chips"] == 4 for c in bench["workloads"])
    assert four <= max(1, len(cells) // 4)


def test_added_mix_and_metric_are_found_without_edits(tmp_path, bench):
    """A copy of the benchmark with a new mix, a new metric reader and a
    new cell, added as files and entries only."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    new = json.loads(json.dumps(bench))
    new["workloads"].append({"name": "hero_dummy", "config": "hero_model",
                             "traffic": "dummy_mix", "chips": 1,
                             "why": "a test cell"})
    new["per_layer"].append({"name": "dummy_metric.eval", "unit": "ms",
                             "better": "lower", "source": "device_trace",
                             "layer": "device", "moves": "depth_maps_per_s",
                             "workloads": ["hero_dummy"]})
    for m in new["end_to_end"]:
        if "workloads" in m and "hero_eval_b16" in m["workloads"]:
            m["workloads"].append("hero_dummy")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    mix = harness.load_json(ROOT / "benchmark/traffic/eval_batches.json")
    mix["batch_size"] = 8
    (tmp_path / "benchmark/traffic/dummy_mix.json").write_text(
        json.dumps(mix))
    (tmp_path / "benchmark/limits/hero_dummy.json").write_text(
        json.dumps({"depth_gap": 0.5}))
    (tmp_path / "benchmark/metrics/dummy_metric.py").write_text(
        "def read(ctx, variant):\n    return 7.0 if variant == 'eval' "
        "else None\n")

    loaded = harness.load_benchmark(tmp_path)
    cell = harness.cell_entry(loaded, "hero_dummy")
    assert harness.load_json(harness.traffic_path(cell, tmp_path)
                             )["batch_size"] == 8
    assert harness.load_json(harness.limits_path(cell, tmp_path)) == {
        "depth_gap": 0.5}
    assert "dummy_metric.eval" in {m["name"] for m in
                                   harness.per_layer_for(loaded, cell)}
    reader = harness.load_reader("dummy_metric.eval", tmp_path)
    assert reader.read(None, "eval") == 7.0
    assert {m["name"] for m in harness.end_to_end_for(loaded, cell)} == {
        "setup_s", "depth_maps_per_s", "depth_batch_p95_ms"}


def test_added_loop_kind_is_run_without_edits(tmp_path, bench):
    """A copy of the benchmark with a new kind of traffic: its loop as a
    new file under `loops/`, its mix, its cell and its limits; the
    copy's `run_cell` runs it at a tiny size on the CPU."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    new = json.loads(json.dumps(bench))
    new["workloads"].append({"name": "hero_twice", "config": "hero_model",
                             "traffic": "twice_mix", "chips": 1,
                             "why": "a test cell"})
    for m in new["end_to_end"]:
        if "workloads" in m and "hero_eval_b16" in m["workloads"]:
            m["workloads"].append("hero_twice")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    mix = harness.load_json(ROOT / "benchmark/traffic/eval_batches.json")
    mix.update(kind="twice", batch_size=1)
    (tmp_path / "benchmark/traffic/twice_mix.json").write_text(
        json.dumps(mix))
    (tmp_path / "benchmark/limits/hero_twice.json").write_text(
        json.dumps({"depth_gap": 0.02}))
    (tmp_path / "benchmark/loops/twice.py").write_text(
        "from benchmark.loops import eval as one\n"
        "def run(config, mix, seed, seconds, *args):\n"
        "    out = one.run(config, mix, seed, seconds, *args)\n"
        "    out.values['depth_maps_per_s'] *= 2\n"
        "    return out\n"
        "readings = one.readings\n")
    code = (
        "import json, sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
        "import torch; torch.set_num_threads(2)\n"
        "from pathlib import Path\n"
        "from benchmark import harness\n"
        "assert harness.ROOT == Path(sys.argv[1]).resolve()\n"
        "over = {'config': {'image_height': 64, 'image_width': 96,\n"
        "                   'matching_num_depth_bins': 16,\n"
        "                   'precision': '32'},\n"
        "        'mix': {'warmup_requests': 1, 'sample_span': 2,\n"
        "                'sampled': 1}}\n"
        "line, _ = harness.run_cell('hero_twice', 5, 0.1, False,\n"
        "                           torch.device('cpu'), overrides=over)\n"
        "print(json.dumps(line))\n")
    done = subprocess.run([sys.executable, "-c", code, str(tmp_path),
                           str(ROOT)], cwd=tmp_path, capture_output=True,
                          text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    line = json.loads(done.stdout.strip().splitlines()[-1])
    assert line["correct"], line
    assert set(line["metrics"]) == {"setup_s", "depth_maps_per_s",
                                    "depth_batch_p95_ms"}


def test_import_guard_compares_whole_top_level_names():
    assert harness.forbidden_modules(
        {"simplerecon_tpu_torch": 1, "simplerecon_tpu_torch.ops": 1,
         "torch": 1, "jaxtyping": 1}) == []
    assert harness.forbidden_modules(
        {"simplerecon_tpu.ops.pallas_cv": 1, "torch": 1}) == [
        "simplerecon_tpu"]
    assert harness.forbidden_modules({"jax.numpy": 1, "flax": 1}) == [
        "flax", "jax"]


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import benchmark.reference, benchmark.check, "
            "benchmark.work, benchmark.generator; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'simplerecon_tpu', "
            "'simplerecon_tpu_torch')]; print(bad); sys.exit(bool(bad))")
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stdout + done.stderr


def test_work_matches_hand_counts():
    # one view, one plane, one pixel, one channel: C_in = 2 + 10 + 4
    shape = (1, 1, 1, 1, 1, 1)
    cin = 16
    fwd_ops = 2 * (cin * 128 + 128 * 128 + 128)
    ops, nbytes = work.sweep_work(shape, 2, backward=False)
    assert ops == fwd_ops
    assert nbytes == (1 + 1) * 2 + (cin * 128 + 128 * 128 + 128) * 2 + 4
    # dot sweep at b=1, k=2, 2x2 pixels, c=4, d=3: 24 samples
    ops, nbytes = work.dot_sweep_work((1, 2, 2, 2, 4, 3), 4)
    assert ops == 24 * (2 * (9 + 16 + 4) + 16)
    assert nbytes == (2 * 4 * 4 + 4 * 4) * 4 + 12 * 4 + (64 + 16 + 3) * 4
    # the scatter's K2 mode: 24 samples, 4 channels, 16 operations each
    ops, _ = work.scatter_work((1, 2, 2, 2, 4, 3), 2, dot=False)
    assert ops == 24 * 4 * 16
    # a 1x1x4x4 pool: 9 windows, 2x2 outputs
    assert work.pool_work((1, 1, 4, 4), 4, False) == (9 * 3 + 4 * 32,
                                                      (16 + 4) * 4)
    assert work.bound_ms(989e9, 0, work.PEAK_FLOPS["bf16"]) == \
        pytest.approx(1.0)
    assert work.bound_ms(0, 3.35e9, 1.0e15) == pytest.approx(1.0)
