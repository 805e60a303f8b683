"""Data-parallel training: one rank a card, each stepping
`parallel/train.py::ddp_train_step` on its rows of each global batch
(`batch_size` is the global batch, `ranks` its ranks). This process is
rank 0; the others are spawned processes. The ranks meet through a file
in a fresh directory under the temporary directory (`TMPDIR`) and hand
their results back through files there; the directory is removed at the
end.

Rank 0 decides when the window closes and tells the others after every
step over a host-side (gloo) group, so that all take the same steps and
no rank waits for its card to do so. It alone is traced, and alone keeps
the readings the comparison takes; the reference follows the ranks' mean
(`reference_ranks`: the shards of each batch, each shard's batch-norm
statistics from the same start, averaged after). Every rank runs with
one host thread and reports the JAX modules its process holds.
"""

from __future__ import annotations

import datetime
import hashlib
import json
import multiprocessing
import os
import shutil
import tempfile
import time
from typing import Callable, Dict, List

import torch
import torch.distributed as dist

from benchmark import cells, check, generator, harness, program, reference
from benchmark.reference import losses as ref_losses

START_METHOD = "spawn"
JOIN_TIMEOUT = datetime.timedelta(seconds=120)


def _statistics(model) -> torch.Tensor:
    return torch.cat([b.detach().float().flatten()
                      for n, b in model.named_buffers()
                      if n.endswith(("running_mean", "running_var"))])


def _digest(model) -> str:
    """SHA-256 of every parameter's and buffer's bytes, in state order."""
    h = hashlib.sha256()
    for value in model.state_dict().values():
        h.update(value.detach().cpu().contiguous().view(-1).view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _join(rank: int, world: int, init_file: str, device) -> None:
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method="file://" + init_file, rank=rank,
        world_size=world, timeout=JOIN_TIMEOUT,
        **({"device_id": device} if backend == "nccl" else {}))


def rank_loop(rank: int, world: int, init_file: str, config: Dict,
              mix: Dict, seed: int, seconds: float, traced: bool,
              device_type: str,
              set_up_done: Callable[[], None] = lambda: None) -> Dict:
    """One rank's run, from joining to leaving the group; rank 0's result
    carries the readings, the trace and the window's counts."""
    torch.set_num_threads(1)
    device = program.mesh.rank_device(rank, world, device_type)
    _join(rank, world, init_file, device)
    try:
        host = dist.new_group(backend="gloo")
        state = cells.seeded_state(config, seed, device)
        model = program.build_model(config, state, device)
        trainer = program.DdpTrainer(config, model,
                                     generator.flip_generator(seed))
        pool = [program.mesh.shard_batch(
            generator.make_batch(config, mix, seed, i, device), rank, world)
            for i in range(mix["pool"])]
        cells.note(f"rank {rank}: weights, model and batches made")
        prog = cells.program_training(trainer, pool, state)
        prog["stats"] = _statistics(model)
        step = check.STEPS
        for _ in range(mix["warmup_steps"]):
            trainer.step(pool[step % len(pool)])
            step += 1
        cells.sync(device)
        dist.barrier()
        if rank == 0:
            cells.note("warmed up")
            set_up_done()

        stop = torch.zeros(1)       # on the host: no wait for the card
        finite = []
        t0 = time.perf_counter()
        while True:
            metrics = trainer.step(pool[step % len(pool)])
            finite.append(torch.isfinite(metrics["loss"])
                          & torch.isfinite(metrics["grad_norm"]))
            step += 1
            if rank == 0:
                stop.fill_(float(time.perf_counter() - t0 >= seconds))
            dist.broadcast(stop, 0, group=host)
            if stop.item():
                break
        cells.sync(device)
        elapsed = time.perf_counter() - t0
        result = {"steps": len(finite), "elapsed": elapsed,
                  "failed": int((~torch.stack(finite)).sum().item()),
                  "peak": cells.peak_bytes(device)}

        def body(i):
            trainer.step(pool[(step + i) % len(pool)])
        if traced:
            if rank == 0:
                result["trace"] = cells.traced_window(
                    device, mix["traced_units"], body)
            else:
                for i in range(mix["traced_units"]):
                    body(i)
        cells.sync(device)
        result["digest"] = _digest(model)
        if rank == 0:
            result["readings"] = prog
        return result
    finally:
        dist.destroy_process_group()


def _rank_main(rank, world, init_file, out_dir, config, mix, seed, seconds,
               traced, device_type):
    result = rank_loop(rank, world, init_file, config, mix, seed, seconds,
                       traced, device_type)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({**{k: result[k] for k in ("steps", "failed", "peak",
                                             "digest")},
                   "forbidden": harness.forbidden_modules()}, f)


def reference_ranks(config: Dict, state, pool: List[Dict], coins, device,
                    world: int, precision: str = "float32") -> Dict:
    """The reference's first `check.STEPS` steps of the ranks' mean: each
    step's gradient the mean of the shards' (each shard's loss over
    `world`), each shard's batch-norm statistics updated from the same
    start and averaged after, the losses averaged."""
    restore = reference.float32_exactly()
    try:
        model = reference.load(config, state, device, precision).train()
        params = dict(model.named_parameters())
        stats = [b for n, b in model.named_buffers()
                 if n.endswith(("running_mean", "running_var"))]
        opt = ref_losses.AdamW(params.values(), lr=config["lr"],
                               wd=config["wd"])
        losses, grad, depth = [], {}, None
        for s in range(check.STEPS):
            for p in params.values():
                p.grad = None
            start = [b.clone() for b in stats]
            mean = [torch.zeros_like(b) for b in stats]
            terms_mean = {t: 0.0 for t in check.TERMS}
            batch = pool[s % len(pool)]
            for r in range(world):
                shard = shard_rows(batch, r, world)
                for b, b0 in zip(stats, start):
                    b.copy_(b0)
                outputs = model(shard["cur"], shard["src"], flip=coins[s])
                terms = ref_losses.compute_losses(shard["cur"], shard["src"],
                                                  outputs)
                (terms["loss"] / world).backward()
                for t in check.TERMS:
                    terms_mean[t] += terms[t].item() / world
                for m, b in zip(mean, stats):
                    m.add_(b / world)
                if s == 0 and r == 0:
                    depth = outputs["depth_pred_s0_bhw1"].detach().clone()
                del outputs, terms
            with torch.no_grad():
                for b, m in zip(stats, mean):
                    b.copy_(m)
            losses.append(terms_mean)
            if s == 0:
                grad = cells.norms({n: p.grad if p.grad is not None
                                    else torch.zeros_like(p)
                                    for n, p in params.items()})
            opt.step()
        change = {n: (p.detach() - state[n]).norm().item()
                  for n, p in params.items()}
        return {"losses": losses, "grad": grad, "change": change,
                "depth": depth, "stats": _statistics(model)}
    finally:
        restore()


def shard_rows(batch, rank: int, world: int):
    """Rank `rank`'s rows of a global batch (the reference's own cut)."""
    rows = batch["cur"]["image_b3hw"].shape[0] // world
    return {part: {k: v[rank * rows:(rank + 1) * rows]
                   for k, v in data.items()} for part, data in batch.items()}


def run(config: Dict, mix: Dict, seed: int, seconds: float, traced: bool,
        device: torch.device, set_up_done: Callable[[], None]) -> cells.Run:
    world = mix["ranks"]
    out = cells.Run(variant="train")
    work = tempfile.mkdtemp(prefix="benchmark_ranks_")
    init_file = os.path.join(work, "rendezvous")
    context = multiprocessing.get_context(START_METHOD)
    others = [context.Process(
        target=_rank_main, args=(r, world, init_file, work, config, mix, seed,
                                 seconds, traced, device.type))
        for r in range(1, world)]
    try:
        for p in others:
            p.start()
        result = rank_loop(0, world, init_file, config, mix, seed, seconds,
                           traced, device.type, set_up_done)
        for p in others:
            p.join(timeout=300)
        codes = [p.exitcode for p in others]
        if any(code != 0 for code in codes):
            raise RuntimeError(f"a rank failed: exit codes {codes}")
        ranks = [result] + [json.load(open(os.path.join(work,
                                                        f"rank{r}.json")))
                            for r in range(1, world)]
    finally:
        for p in others:
            if p.is_alive():
                p.terminate()
                p.join()
        shutil.rmtree(work, ignore_errors=True)
    cells.note("ranks joined")
    found = sorted({m for r in ranks[1:] for m in r["forbidden"]})
    if found:
        raise RuntimeError("a rank's process holds " + ", ".join(found)
                           + "; no result")

    out.attempted = result["steps"]
    out.failed = max(r["failed"] for r in ranks)
    out.values["train_samples_per_s"] = (result["steps"] * mix["batch_size"]
                                         / result["elapsed"])
    out.samples_per_s = out.values["train_samples_per_s"]
    out.peak_bytes = max(r["peak"] for r in ranks)
    out.trace = result.get("trace")
    if traced:
        pool0 = generator.make_batch(config, mix, seed, 0, device)
        out.flops[True] = cells.count_flops(config, pool0, device, True)
        del pool0
    if device.type == "cuda":
        torch.cuda.empty_cache()
    pool = [generator.make_batch(config, mix, seed, i, device)
            for i in range(check.STEPS)]
    state = cells.seeded_state(config, seed, device)
    ref = reference_ranks(config, state, pool, generator.flip_coins(
        seed, check.STEPS), device, world)
    out.numbers = check.compare_training(result["readings"], ref)
    out.numbers["ranks_differ"] = float(sum(
        r["digest"] != result["digest"] for r in ranks[1:]))
    cells.note("reference compared")
    return out


def readings(config: Dict, mix: Dict, seed: int, device,
             control: bool) -> list:
    """The control against the reference, both the ranks' mean computed
    in one process (the program's readings come from the benchmark's own
    runs, which need the ranks)."""
    if not control:
        return []
    state = cells.seeded_state(config, seed, device)
    pool = [generator.make_batch(config, mix, seed, i, device)
            for i in range(check.STEPS)]
    coins = generator.flip_coins(seed, check.STEPS)
    got = reference_ranks(config, state, pool, coins, device, mix["ranks"],
                          precision="fp8")
    want = reference_ranks(config, state, pool, coins, device, mix["ranks"])
    return [{"seed": seed, "reading": "control",
             **check.compare_training(got, want),
             "losses": [s["loss"] for s in got["losses"]],
             "ref_losses": [s["loss"] for s in want["losses"]]}]
