"""The benchmark's files: every name in BENCHMARK.json resolves to its
file, the file keeps the contract's shape, new configurations with their
references, mixes, loops and metrics are taken up as added files, the
references' layouts and seeded weights stay as they were, and the work
counts match hand counts."""

from __future__ import annotations

import hashlib
import json
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import generator, harness, reference, work

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


GROUP_REFERENCE = """\
import torch.nn as nn

from benchmark.reference import model


def build(config):
    \"\"\"The hero with the matching stem's norms GroupNorm-8 in float32
    (the port's `matching_norm: "group"`).\"\"\"
    encoder = model.ResnetMatchingEncoder(config["matching_feature_dims"])
    encoder.net[1] = nn.GroupNorm(8, 64)
    for block in encoder.net[4]:
        block.bn1, block.bn2 = nn.GroupNorm(8, 64), nn.GroupNorm(8, 64)
    return model.build(config, matching_model=encoder)
"""


def test_added_configuration_brings_its_own_reference(tmp_path, bench):
    """A copy of the benchmark with a new configuration (the hero with
    `matching_norm: "group"`) whose `reference` names a new file built on
    `model.py`'s parts, and an eval cell on it with its limits: the
    copy's `run_cell` runs it at a tiny size on the CPU and it is
    correct. The same configuration with `model.py` as its reference
    fails at set-up, where the port's model refuses the state dict drawn
    over a layout it does not have."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    new = json.loads(json.dumps(bench))
    hero = harness.load_json(ROOT / "benchmark/configs/hero_model.json")
    for name, ref in (("hero_group", "benchmark/reference/hero_group.py"),
                      ("hero_group_plain", "benchmark/reference/model.py")):
        path = f"benchmark/configs/{name}.json"
        (tmp_path / path).write_text(json.dumps(
            {**hero, "name": name, "matching_norm": "group",
             "reference": ref}))
        new["configs"].append({"name": name, "source": hero["source"],
                               "file": path, "reduced": [],
                               "why": "a test configuration"})
        new["workloads"].append({"name": f"{name}_eval", "config": name,
                                 "traffic": "eval_batches", "chips": 1,
                                 "why": "a test cell"})
        for m in new["end_to_end"]:
            if "hero_eval_b16" in m.get("workloads", ()):
                m["workloads"].append(f"{name}_eval")
        shutil.copy(ROOT / "benchmark/limits/hero_eval_b16.json",
                    tmp_path / f"benchmark/limits/{name}_eval.json")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    (tmp_path / "benchmark/reference/hero_group.py").write_text(
        GROUP_REFERENCE)
    code = (
        "import json, sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
        "import torch; torch.set_num_threads(2)\n"
        "from benchmark import cells, harness, reference\n"
        "notes = []\n"
        "cells.note = notes.append\n"
        "over = {'config': {'image_height': 64, 'image_width': 96,\n"
        "                   'matching_num_depth_bins': 16,\n"
        "                   'precision': '32'},\n"
        "        'mix': {'warmup_requests': 1, 'sample_span': 2,\n"
        "                'sampled': 1, 'batch_size': 2}}\n"
        "config = harness.load_json(harness.ROOT / "
        "'benchmark/configs/hero_group.json')\n"
        "_, norms, _ = reference.layout(config)\n"
        "try:\n"
        "    harness.run_cell('hero_group_plain_eval', 5, 0.1, False,\n"
        "                     torch.device('cpu'), overrides=over)\n"
        "    plain = 'ran'\n"
        "except RuntimeError as e:\n"
        "    plain = str(e)\n"
        "plain_notes, notes[:] = list(notes), []\n"
        "line, _ = harness.run_cell('hero_group_eval', 5, 0.1, False,\n"
        "                           torch.device('cpu'), overrides=over)\n"
        "print(json.dumps({'line': line, 'plain': plain,\n"
        "                  'plain_notes': plain_notes,\n"
        "                  'norms': sorted(norms)}))\n")
    done = subprocess.run([sys.executable, "-c", code, str(tmp_path),
                           str(ROOT)], cwd=tmp_path, capture_output=True,
                          text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    out = json.loads(done.stdout.strip().splitlines()[-1])
    assert out["line"]["correct"], out["line"]
    assert set(out["line"]["metrics"]) == {"setup_s", "depth_maps_per_s",
                                           "depth_batch_p95_ms"}
    # the group norms' scales are drawn about 1, as the batch norms' are
    assert {"matching_model.net.1", "matching_model.net.4.0.bn1",
            "matching_model.net.4.1.bn2"} <= set(out["norms"])
    assert "Error(s) in loading state_dict" in out["plain"], out["plain"]
    assert "Unexpected key(s)" in out["plain"]
    assert "matching_model.net.1.running_mean" in out["plain"]
    assert not any("weights and model made" in n
                   for n in out["plain_notes"]), out["plain_notes"]


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
    """A fresh process that loads the `reference` file of every
    configuration in BENCHMARK.json holds nothing of JAX, the JAX package
    or the port."""
    code = ("import sys; import benchmark.reference, benchmark.check, "
            "benchmark.work, benchmark.generator\n"
            "from benchmark import harness, reference\n"
            "for c in harness.load_benchmark()['configs']:\n"
            "    reference.module(harness.load_json(harness.ROOT / c['file']))"
            "\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'simplerecon_tpu', "
            "'simplerecon_tpu_torch')]; print(bad); sys.exit(bool(bad))")
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stdout + done.stderr


def test_reference_that_imports_the_program_is_refused(tmp_path):
    """A configuration whose reference file imports the port (or JAX) is
    refused when the file is loaded, and the module is not kept."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "benchmark/reference/leaky.py").write_text(
        "import simplerecon_tpu_torch.models  # noqa: F401\n"
        "from benchmark.reference.model import build  # noqa: F401\n")
    code = ("import sys; sys.path.insert(0, sys.argv[1])\n"
            "from benchmark import reference\n"
            "try:\n"
            "    reference.module({'reference': "
            "'benchmark/reference/leaky.py'})\n"
            "except ImportError as e:\n"
            "    print(e); assert 'benchmark.reference.leaky' not in "
            "sys.modules\n"
            "else:\n"
            "    sys.exit('loaded')\n"
            "for bad in ('../BENCHMARK.json', 'benchmark/configs/"
            "hero_model.json'):\n"
            "    try:\n"
            "        reference.module({'reference': bad})\n"
            "    except ValueError:\n"
            "        pass\n"
            "    else:\n"
            "        sys.exit(bad)\n")
    done = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=tmp_path, capture_output=True, text=True,
                          timeout=120)
    assert done.returncode == 0, done.stdout + done.stderr
    assert "imports simplerecon_tpu_torch" in done.stdout


FROZEN_SEED = 2 ** 31 + 12345
FROZEN = {
    "hero_model": {
        "entries": 1121,
        "names_shapes": "a9a12bccafd3a40e59d92422c68ddca7"
                        "a1eb174bd559b1de626ca5dd48411a4a",
        "norms": 114,
        "norm_names": "2c9d60c4791bc1618e920dfaeb2912d4"
                      "d60c01f3e3d16f04071202f6bd4b2155",
        "fixed": ["matching_model.net.3.1.filt"],
        "weights": "00a26f2d25f84664bcd2befb38135511"
                   "11f20da7ac28e1cf89f4d8d32cd34d7b"},
    "dot_product_model": {
        "entries": 1115,
        "names_shapes": "dc8759aaa49f98ddedd3dae220996b05"
                        "e86dfcd3fc0597c969a98dfa6785114a",
        "norms": 114,
        "norm_names": "2c9d60c4791bc1618e920dfaeb2912d4"
                      "d60c01f3e3d16f04071202f6bd4b2155",
        "fixed": ["matching_model.net.3.1.filt"],
        "weights": "f8a4c909da8d335a07875431bf223488"
                   "58ed45ea5e4b35a1bc5f6d2ecc49f3bf"},
}


def _sha(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


@pytest.mark.parametrize("name", sorted(FROZEN))
def test_reference_layout_and_weights_are_frozen(name):
    """The reference's state-dict names, shapes and order, its norm
    modules, its constant buffers, and `generator.make_weights` over them
    on the CPU for one seed, at the configuration's full size, as
    computed on commit 6bbeb37c4b20 (before each configuration named its
    own reference file): the seeded weights of the benchmark's cells do
    not move with the reference's form."""
    config = harness.load_json(ROOT / f"benchmark/configs/{name}.json")
    shapes, norms, fixed = reference.layout(config)
    state = generator.make_weights(shapes, FROZEN_SEED, "cpu", fixed, norms)
    digest = hashlib.sha256()
    for n, t in state.items():
        digest.update(n.encode())
        digest.update(t.contiguous().numpy().tobytes())
    assert {"entries": len(shapes),
            "names_shapes": _sha("\n".join(f"{n} {s}"
                                           for n, s in shapes.items())),
            "norms": len(norms), "norm_names": _sha("\n".join(sorted(norms))),
            "fixed": sorted(fixed),
            "weights": digest.hexdigest()} == FROZEN[name]


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
