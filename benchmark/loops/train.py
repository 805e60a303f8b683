"""The training step, back to back, over a pool of seeded batches: set-up
builds the one training object, takes its first `check.STEPS` steps
through the window's own call on distinct batches (they are what the
reference follows), then the window drives it on."""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict

import torch

from benchmark import cells, check, generator, program
from benchmark.cells import note, sync


def run(config: Dict, mix: Dict, seed: int, seconds: float, traced: bool,
        device: torch.device, set_up_done: Callable[[], None]) -> cells.Run:
    out = cells.Run(variant="train")
    state, model, pool = cells.set_up(config, mix, seed, device)
    trainer = program.Trainer(config, model, generator.flip_generator(seed))
    prog = cells.program_training(trainer, pool, state)
    note(f"first {check.STEPS} steps taken")
    step = check.STEPS
    for _ in range(mix["warmup_steps"]):
        trainer.step(pool[step % len(pool)])
        step += 1
    sync(device)
    note("warmed up")
    set_up_done()

    finite, times = [], []
    t0 = time.perf_counter()
    while True:
        start = time.perf_counter()
        metrics = trainer.step(pool[step % len(pool)])
        finite.append(torch.isfinite(metrics["loss"])
                      & torch.isfinite(metrics["grad_norm"]))
        step += 1
        times.append(time.perf_counter() - start)
        if time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    elapsed = time.perf_counter() - t0
    note(f"window: {len(times)} steps, host ms a step median "
         f"{1e3 * sorted(times)[len(times) // 2]:.1f} max "
         f"{1e3 * max(times):.1f}")
    out.attempted = len(finite)
    out.failed = int((~torch.stack(finite)).sum().item())
    b = mix["batch_size"]
    out.values["train_samples_per_s"] = out.attempted * b / elapsed
    out.samples_per_s = out.values["train_samples_per_s"]
    out.peak_bytes = cells.peak_bytes(device)

    if traced:
        def body(i):
            trainer.step(pool[(step + i) % len(pool)])
        out.trace = cells.traced_window(device, mix["traced_units"], body)
        note("trace read")
        out.flops[True] = cells.count_flops(config, pool[0], device, True)

    note("window closed")
    del trainer, model, metrics
    if device.type == "cuda":
        torch.cuda.empty_cache()
    coins = generator.flip_coins(seed, check.STEPS)
    ref = cells.reference_training(config, state, pool, coins, device)
    out.numbers = check.compare_training(prog, ref)
    note("reference compared")
    return out


# --------------------------------------------------------------------------
# the readings that the limits are set from (`benchmark/control.py`)
# --------------------------------------------------------------------------

@contextlib.contextmanager
def loss_over_half_the_batch():
    """A fault planted in the program: the forward takes every row of the
    batch, the loss (and so the gradient) only the first half's."""
    from simplerecon_tpu_torch import losses as loss_lib
    whole = loss_lib.compute_losses
    loss_lib.compute_losses = lambda cur, src, outputs: whole(
        cells.first_half(cur), cells.first_half(src),
        cells.first_half(outputs))
    try:
        yield
    finally:
        loss_lib.compute_losses = whole


def _leaf_record(reading: Dict, ref: Dict) -> Dict[str, list]:
    """For the record, each leaf's [elements, |g|, |d|, <e, d>, |e|]: g
    the reference's first gradient, d its move with the loss over the
    first half of the rows, e the program's gradient less g."""
    out = {}
    for n, full in ref["grad_vec"].items():
        f = full.double()
        d = f - ref["grad_half"][n].double()
        e = reading["grad_vec"][n].double() - f
        out[n] = [f.numel(), f.norm().item(), d.norm().item(),
                  (e * d).sum().item(), e.norm().item()]
    return out


def readings(config: Dict, mix: Dict, seed: int, device,
             control: bool) -> list:
    """The program against the reference on `seed`; with `control`, also
    the fp8 control, the program with its loss over half the batch, and
    the program in float32 (autocast off), a witness of what bf16 alone
    moves."""
    state = cells.seeded_state(config, seed, device)
    pool = generator.make_pool(config, mix, seed, device)
    coins = generator.flip_coins(seed, check.STEPS)

    def program_run(run_config=config):
        model = program.build_model(run_config, state, device)
        trainer = program.Trainer(run_config, model,
                                  generator.flip_generator(seed))
        got = cells.program_training(trainer, pool, state)
        del trainer, model
        if device.type == "cuda":
            torch.cuda.empty_cache()
        return got

    got = {"program": program_run()}
    if control:
        with loss_over_half_the_batch():
            got["half_loss"] = program_run()
        got["program_fp32"] = program_run({**config, "precision": "32"})
        got["control"] = cells.reference_training(
            config, state, pool, coins, device, precision="fp8")
    ref = cells.reference_training(config, state, pool, coins, device)
    rows = []
    for name, reading in got.items():
        rows.append({"seed": seed, "reading": name,
                     **check.compare_training(reading, ref),
                     "leaves": _leaf_record(reading, ref),
                     "grad_look": check.leaf_look(reading, ref, "grad"),
                     "change_look": check.leaf_look(reading, ref, "change"),
                     "losses": [s["loss"] for s in reading["losses"]],
                     "ref_losses": [s["loss"] for s in ref["losses"]]})
    return rows
