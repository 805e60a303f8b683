"""The control at a size a test run holds: the reference put in the
program's place and computed at fp8 (the step below the configurations'
bf16) must come out not correct against each cell's limits, as it does
on the card at the cells' own sizes (`benchmark/control.py`)."""

from __future__ import annotations

import pytest
import torch

from benchmark import cells, check, generator, harness

TINY_CONFIG = {"image_height": 64, "image_width": 96,
               "matching_num_depth_bins": 16}
SEED = 2 ** 33 + 7


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def tiny(cell_name: str):
    bench = harness.load_benchmark()
    cell = harness.cell_entry(bench, cell_name)
    config = harness.load_json(harness.config_path(bench, cell))
    mix = harness.load_json(harness.traffic_path(cell))
    config.update(TINY_CONFIG)
    mix.update(batch_size=2)
    return config, mix, harness.load_json(harness.limits_path(cell))


@pytest.mark.parametrize("cell", ["hero_train_b16", "dot_train_b16"])
def test_fp8_control_fails_a_training_cell(cell):
    config, mix, limits = tiny(cell)
    device = torch.device("cpu")
    state = cells.seeded_state(config, SEED, device)
    pool = generator.make_pool(config, mix, SEED, device)
    coins = generator.flip_coins(SEED, check.STEPS)
    want = cells.reference_training(config, state, pool, coins, device)
    got = cells.reference_training(config, state, pool, coins, device,
                                   precision="fp8")
    correct, table = check.judge(check.compare_training(got, want), limits)
    assert not correct, table


def test_fp8_control_fails_the_inference_cell():
    config, mix, limits = tiny("hero_eval_b16")
    device = torch.device("cpu")
    state = cells.seeded_state(config, SEED, device)
    batch = generator.make_batch(config, mix, SEED, 0, device)
    want = cells.reference_answers(config, state, batch, device)
    got = cells.reference_answers(config, state, batch, device,
                                  precision="fp8")
    correct, table = check.judge(check.compare_answers(got, want), limits)
    assert not correct, table
