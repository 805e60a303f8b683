"""Depth inference as the eval CLI runs it: a closed loop with one client
and one request outstanding, each request a batch of the pool, done when
its outputs are in host memory."""

from __future__ import annotations

import math
import random
import time
from typing import Callable, Dict, List

import torch

from benchmark import cells, check, generator, program
from benchmark.cells import note, sync


def sampled_requests(seed: int, mix: Dict) -> set:
    """The requests of the window whose answers are compared: the first
    of each pool batch and `sampled` more, drawn from the seed among the
    first `sample_span`."""
    rng = random.Random(generator.derived_seed(seed, "sample"))
    return set(range(mix["pool"])) | set(
        rng.sample(range(mix["sample_span"]), mix["sampled"]))


def p95(values: List[float]) -> float:
    """The nearest-rank 95th percentile."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(0.95 * len(ordered)) - 1)]


def run(config: Dict, mix: Dict, seed: int, seconds: float, traced: bool,
        device: torch.device, set_up_done: Callable[[], None]) -> cells.Run:
    out = cells.Run(variant="eval")
    state, model, pool = cells.set_up(config, mix, seed, device)
    forward = program.make_forward_fn(model)

    def request(batch):
        answer = forward(batch["cur"], batch["src"])
        return {k: v.cpu() for k, v in answer.items()}

    for i in range(mix["warmup_requests"]):
        request(pool[i % len(pool)])
    sync(device)
    note("warmed up")
    set_up_done()

    keep = sampled_requests(seed, mix)
    kept, latencies, failed = [], [], 0
    t0 = time.perf_counter()
    while True:
        i = len(latencies)
        start = time.perf_counter()
        answer = request(pool[i % len(pool)])
        latencies.append(time.perf_counter() - start)
        if not torch.isfinite(answer["depth_pred_s0_bhw1"]).all():
            failed += 1
        if i in keep:
            kept.append((i % len(pool), answer))
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    ordered = sorted(latencies)
    note(f"window: {len(latencies)} requests, ms median "
         f"{1e3 * ordered[len(ordered) // 2]:.1f} p99 "
         f"{1e3 * ordered[int(0.99 * (len(ordered) - 1))]:.1f} max "
         f"{1e3 * ordered[-1]:.1f}, over 2x the median "
         f"{sum(t > 2 * ordered[len(ordered) // 2] for t in ordered)}")
    out.attempted, out.failed = len(latencies), failed
    b = mix["batch_size"]
    out.values["depth_maps_per_s"] = out.attempted * b / elapsed
    out.values["depth_batch_p95_ms"] = p95(latencies) * 1e3
    out.samples_per_s = out.values["depth_maps_per_s"]
    out.peak_bytes = cells.peak_bytes(device)

    if traced:
        out.trace = cells.traced_window(
            device, mix["traced_units"],
            lambda i: request(pool[i % len(pool)]))
        note("trace read")
        out.flops[False] = cells.count_flops(config, pool[0], device, False)

    note("window closed")
    del model, forward
    if device.type == "cuda":
        torch.cuda.empty_cache()
    found = []
    for index in sorted({j for j, _ in kept}):
        want = cells.reference_answers(config, state, pool[index], device)
        found += [check.compare_answers(got, want)
                  for j, got in kept if j == index]
    out.numbers = check.worst(found)
    note("reference compared")
    return out


def readings(config: Dict, mix: Dict, seed: int, device,
             control: bool) -> list:
    """The program's answer to each pool batch against the reference's
    on `seed`; with `control`, the fp8 control's too."""
    state = cells.seeded_state(config, seed, device)
    pool = generator.make_pool(config, mix, seed, device)
    model = program.build_model(config, state, device)
    forward = program.make_forward_fn(model)
    answers = []
    for batch in pool:
        answer = forward(batch["cur"], batch["src"])
        answers.append({k: v.cpu() for k, v in answer.items()})
    del model, forward
    if device.type == "cuda":
        torch.cuda.empty_cache()
    got = {"program": answers}
    if control:
        got["control"] = [cells.reference_answers(
            config, state, batch, device, precision="fp8") for batch in pool]
    want = [cells.reference_answers(config, state, batch, device)
            for batch in pool]
    return [{"seed": seed, "reading": name,
             **check.worst([check.compare_answers(g, w)
                            for g, w in zip(answers_of, want)])}
            for name, answers_of in got.items()]
