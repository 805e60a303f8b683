"""Each cell's loop at a tiny size on the CPU, through the port's plain
paths: the result line keeps the contract, the reference agrees with the
port, and a run with its timed path broken underneath comes out not
correct. The card's own run, marked `gpu`, runs where a card is."""

from __future__ import annotations

import contextlib
import io
import json
import math
import shutil

import pytest
import torch

from benchmark import harness, run as run_cli

CELLS = ("hero_train_b16", "dot_train_b16", "hero_eval_b16")
TINY = {"config": {"image_height": 64, "image_width": 96,
                   "matching_num_depth_bins": 16, "precision": "32"},
        "mix": {"batch_size": 2, "warmup_steps": 0, "warmup_requests": 1,
                "traced_units": 1, "sample_span": 4, "sampled": 2}}
SEED = 2 ** 31 + 12345


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def check_line(line: dict, bench: dict, cell: dict, traced: bool) -> None:
    """The result line as the contract has it."""
    assert list(line)[:3] == ["correct", "attempted", "failed"]
    assert list(line)[-1] == "checks"
    assert isinstance(line["correct"], bool)
    assert line["attempted"] >= 1 and 0 <= line["failed"] <= line[
        "attempted"]
    for key in ("platform", "kind", "count", "memory_peak_bytes"):
        assert key in line["device"]
    want = (harness.per_layer_for(bench, cell) if traced
            else harness.end_to_end_for(bench, cell))
    names = {m["name"]: m["unit"] for m in want}
    for name, metric in line["metrics"].items():
        assert names[name] == metric["unit"]
        assert math.isfinite(metric["value"])
    if not traced:
        assert set(line["metrics"]) == set(names)
        assert all(m["value"] > 0 for m in line["metrics"].values())
    for row in line["checks"].values():
        assert set(row) == {"value", "limit"}
    json.dumps(line)


def tiny_run(cell: str, traced: bool = False, seconds: float = 0.2,
             **mix):
    overrides = {"config": TINY["config"], "mix": {**TINY["mix"], **mix}}
    return harness.run_cell(cell, SEED, seconds, traced,
                            torch.device("cpu"), overrides=overrides)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_agrees_with_the_reference(cell):
    bench = harness.load_benchmark()
    line, table = tiny_run(cell)
    check_line(line, bench, harness.cell_entry(bench, cell), False)
    assert line["correct"], table
    # float32 on both sides: far inside any limit
    for name, row in table.items():
        assert row["value"] <= 0.02, (name, row)


def test_traced_line_keeps_the_contract():
    bench = harness.load_benchmark()
    line, _ = tiny_run("hero_eval_b16", traced=True)
    check_line(line, bench, harness.cell_entry(bench, "hero_eval_b16"), True)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "half_loss"])
def test_broken_training_step_is_not_correct(fault, monkeypatch):
    """A step that leaves its state unchanged; one that forwards and
    takes its loss over half of the batch (the rows missing); one that
    forwards every row and takes its loss over half (caught by value)."""
    from simplerecon_tpu_torch.parallel import train as train_lib
    if fault == "half_loss":
        with harness.load_loop("train").loss_over_half_the_batch():
            line, table = tiny_run("hero_train_b16")
        assert not line["correct"], table
        assert table["half_batch_share"]["value"] > \
            table["half_batch_share"]["limit"], table
        return
    if fault == "state_unchanged":
        def step(self):
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in self.params]
            return torch.nn.utils.get_total_norm(grads)
        monkeypatch.setattr(train_lib.Optimizer, "step", step)
    else:
        whole = train_lib.loss_and_backward

        def half(model, batch, flip):
            rows = {part: {k: v[:v.shape[0] // 2] for k, v in data.items()}
                    for part, data in batch.items()}
            return whole(model, rows, flip)
        monkeypatch.setattr(train_lib, "loss_and_backward", half)
    line, table = tiny_run("hero_train_b16")
    assert not line["correct"], table


def test_altered_answer_is_not_correct(monkeypatch):
    from simplerecon_tpu_torch.models import depth_model
    forward = depth_model.DepthModel.forward

    def altered(self, *args, **kwargs):
        out = forward(self, *args, **kwargs)
        out["depth_pred_s0_bhw1"] = out["depth_pred_s0_bhw1"] * 1.5
        return out
    monkeypatch.setattr(depth_model.DepthModel, "forward", altered)
    line, table = tiny_run("hero_eval_b16")
    assert not line["correct"], table


RANKS_CELL = {"name": "hero_train_ddp4", "config": "hero_model",
              "traffic": "ddp_train_step", "chips": 4, "why": "a test cell"}
RANKS_LIMITS = {"depth_gap": 0.02, "grad_median_gap": 0.02,
                "update_median_gap": 0.02, "stats_gap": 0.02,
                "ranks_differ": 0}


@pytest.fixture
def ranks_root(tmp_path):
    """A copy of the benchmark's files with the data-parallel cell that
    `BENCHMARK.json` leaves for later (the loop `loops/ddp_train.py` and
    the mix `traffic/ddp_train_step.json` are in place)."""
    shutil.copytree(harness.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.load_benchmark()
    bench["workloads"].append(RANKS_CELL)
    for m in bench["end_to_end"]:
        if "hero_train_b16" in m.get("workloads", ()):
            m["workloads"].append(RANKS_CELL["name"])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "benchmark/limits/hero_train_ddp4.json").write_text(
        json.dumps(RANKS_LIMITS))
    return tmp_path


def ranks_run(root):
    overrides = {"config": TINY["config"],
                 "mix": {**TINY["mix"], "batch_size": 8}}
    return harness.run_cell(RANKS_CELL["name"], SEED, 0.2, False,
                            torch.device("cpu"), root=root,
                            overrides=overrides)


def test_ranks_cell_runs_and_fails_without_the_exchange(ranks_root,
                                                         monkeypatch):
    """Four gloo ranks: a sound run agrees with the ranks' mean; with the
    exchange between ranks left out (each rank steps on its own
    gradient) the run is not correct."""
    from simplerecon_tpu_torch.parallel import train as train_lib
    bench = harness.load_benchmark(ranks_root)
    line, table = ranks_run(ranks_root)
    check_line(line, bench, RANKS_CELL, False)
    assert line["correct"], table

    class Unsynced(torch.nn.Module):
        def __init__(self, model):
            super().__init__()
            self.module = model

        def forward(self, *args, **kwargs):
            return self.module(*args, **kwargs)
    monkeypatch.setattr(train_lib, "wrap_ddp", Unsynced)
    # ranks forked, not spawned, inherit the fault
    monkeypatch.setattr(harness.load_loop("ddp_train"), "START_METHOD",
                        "fork")
    line, table = ranks_run(ranks_root)
    assert not line["correct"], table
    assert table["ranks_differ"]["value"] > 0


def test_ranks_cell_refuses_a_rank_holding_jax(ranks_root, monkeypatch):
    """Each rank's process reports the JAX modules it holds: one that
    holds any ends the run without a result."""
    monkeypatch.setattr(harness, "forbidden_modules", lambda: ["jax"])
    monkeypatch.setattr(harness.load_loop("ddp_train"), "START_METHOD",
                        "fork")
    with pytest.raises(RuntimeError, match="jax"):
        ranks_run(ranks_root)


def test_run_without_a_card_fails_and_prints_no_result(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = run_cli.main(["--workload", "hero_eval_b16", "--seed", "1",
                             "--seconds", "1", "--trace", "0"])
    assert code != 0 and out.getvalue() == ""


def test_run_holding_jax_fails_and_prints_no_result(monkeypatch):
    """The import guard runs after the window, in the printing process."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: (
        {"correct": True, "checks": {}}, {}))
    monkeypatch.setitem(__import__("sys").modules, "jax",
                        __import__("types").ModuleType("jax"))
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = run_cli.main(["--workload", "hero_eval_b16", "--seed", "1",
                             "--seconds", "1", "--trace", "0"])
    assert code != 0 and out.getvalue() == ""
    assert "jax" in err.getvalue()


@pytest.mark.gpu
def test_cell_on_the_card():
    """A short run of the eval cell on the card: correct, and a line the
    contract accepts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bench = harness.load_benchmark()
    line, table = harness.run_cell("hero_eval_b16", SEED, 2.0, False,
                                   torch.device("cuda", 0))
    check_line(line, bench, harness.cell_entry(bench, "hero_eval_b16"),
               False)
    assert line["correct"], table
