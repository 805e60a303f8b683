"""The training program (counterpart of `simplerecon_tpu/scripts/train.py`):
a loop over the training set through `parallel/train.py::train_step`,
scalar logs as JSON lines, validation every `val_interval` steps over
`val_batches` batches with image panels from the first, the last and the
best checkpoint by validation loss, an options and source snapshot, and
`--resume` (the full state) or `--load_weights_from_checkpoint` (weights
only, a fresh optimizer).

    python -m simplerecon_tpu_torch.scripts.train \
        --config_file configs/models/hero_model.yaml --dataset synthetic \
        --single_debug_scan_id scene

Runs on the CUDA card; `main(opts, device="cpu")` runs on the CPU. The
initial weights are drawn from `opts.random_seed`, and so are the flip
coin's generator, the epochs' order and every item's augmentation.

With `--num_devices N` above 1 the program runs N ranks, one process
each (`torch.multiprocessing`, meeting through a file under the log
directory), as the JAX CLI steps over N devices: `batch_size` is the
global batch, which must divide by N; each rank decodes its rows of
each batch and runs `parallel/train.py::ddp_train_step`. On the card
the ranks take one card each over NCCL, and more ranks than visible
cards raise unless `main(..., backend="gloo")` lets them share cards;
`main(opts, device="cpu")` runs the ranks on the CPU over gloo. Rank 0
alone writes the logs, panels, validations and checkpoints, which hold
one copy of the state, as a single-device run's do.

Writes under `<log_dir>/<name>/`: `options.yaml`, `code/` (the package's
source), `metrics.jsonl`, `panels/step<N>_<i>.png`,
`checkpoints/step_<N>/` (the newest two) and `best/step_<N>/`.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from simplerecon_tpu_torch import tracing
from simplerecon_tpu_torch.data.loader import (DataLoader, device_prefetch,
                                               to_train_schema)
from simplerecon_tpu_torch.data.registry import get_dataset
from simplerecon_tpu_torch.models.depth_model import (build_depth_model,
                                                      resolve_device)
from simplerecon_tpu_torch.options import (Options, OptionsHandler,
                                           save_options_yaml)
from simplerecon_tpu_torch.parallel import mesh
from simplerecon_tpu_torch.parallel import train as train_lib
from simplerecon_tpu_torch.utils import checkpoint as ckpt_lib


class JSONLLogger:
    """Scalar logs, one JSON object a line in `<log_dir>/metrics.jsonl`,
    and image panels as PNGs."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._fh = open(self.path, "a")

    def log(self, step: int, metrics: Dict[str, float], prefix: str = ""):
        rec = {"step": int(step),
               **{f"{prefix}{k}": float(v) for k, v in metrics.items()}}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def log_images(self, step: int, panels_nhw3: np.ndarray,
                   panel_dir: str):
        """Writes each panel as `<panel_dir>/step<step>_<i>.png`."""
        from simplerecon_tpu_torch.utils.visualization import save_image
        os.makedirs(panel_dir, exist_ok=True)
        for i, panel in enumerate(panels_nhw3):
            save_image(os.path.join(panel_dir,
                                    f"step{int(step):08d}_{i}.png"), panel)

    def close(self):
        self._fh.close()


def build_dataloaders(opts: Options, shard=(0, 1)):
    """The training loader (shuffled, seeded by `random_seed`, this
    rank's rows of each batch under `shard=(rank, world)`) and the
    validation loader (whole batches), both dropping a last partial
    batch."""
    dataset_class, _ = get_dataset(opts.dataset,
                                   opts.dataset_scan_split_file or None,
                                   opts.single_debug_scan_id,
                                   verbose=False)

    def make(split, shuffle, batch_size, shard=(0, 1)):
        ds = dataset_class(
            dataset_path=opts.dataset_path, split=split,
            mv_tuple_file_suffix=opts.mv_tuple_file_suffix,
            tuple_info_file_location=opts.tuple_info_file_location or None,
            num_images_in_tuple=opts.num_images_in_tuple
            or opts.model_num_views,
            image_height=opts.image_height, image_width=opts.image_width,
            shuffle_tuple=opts.shuffle_tuple,
            rng=np.random.RandomState(opts.random_seed))
        return DataLoader(ds, batch_size=batch_size, shuffle=shuffle,
                          num_workers=opts.num_workers, drop_last=True,
                          adapter=to_train_schema, seed=opts.random_seed,
                          shard=shard)

    return (make("train", True, opts.batch_size, shard),
            make("val", False, opts.val_batch_size))


def validate(state, val_loader, opts: Options, device, logger, step: int,
             panel_dir: str) -> Optional[float]:
    """`val_batches` batches through `eval_step`; panels of the first.
    Returns the mean validation loss, or None when no batch ran."""
    from simplerecon_tpu_torch.utils.visualization import build_image_panels
    val_losses = []
    for vi, vbatch in enumerate(device_prefetch(val_loader, device)):
        if vi >= opts.val_batches:
            break
        loss_dict, outputs = train_lib.eval_step(state.model, vbatch)
        val_losses.append(float(loss_dict["loss"]))
        if vi == 0:
            panels = build_image_panels(
                vbatch["cur"], {k: v for k, v in outputs.items()
                                if v is not None})
            logger.log_images(step, panels, panel_dir)
    return float(np.mean(val_losses)) if val_losses else None


def main(opts: Options, device=None, on_step=None, backend=None):
    """Trains the model of `opts` on `device` (the CUDA card unless
    another is given) to `opts.max_steps`; `on_step(state, batch,
    metrics)`, when given, is called after each step. Returns the
    `TrainState`, with `run_stats`: the host seconds of each step (its
    span `sr.train_step`), of each loader wait (`sr.loader.wait`) and
    their sum, of each validation and each checkpoint write, the card's
    peak memory (bytes), the steps run and the kernels' launches.

    With `opts.num_devices` above 1, runs that many ranks (`run_ranks`;
    `backend` names their process group's backend, by default NCCL on
    the card and gloo on the CPU) and returns the state of the last
    checkpoint, restored as a single-device run would restore it, with
    rank 0's `run_stats` and each rank's under `"ranks"`."""
    if opts.num_devices > 1:
        if on_step is not None:
            raise ValueError("on_step runs in a single-device run only")
        return run_ranks(opts, device, backend)
    return train(opts, resolve_device(device), on_step=on_step)


def new_state(opts: Options, device) -> train_lib.TrainState:
    """The seeded model, a fresh optimizer and the flip coin's
    generator."""
    model = build_depth_model(opts, device=device, seed=opts.random_seed)
    return train_lib.TrainState(
        model=model, optimizer=train_lib.make_optimizer(opts, model),
        generator=torch.Generator().manual_seed(opts.random_seed))


def run_ranks(opts: Options, device=None, backend=None
              ) -> train_lib.TrainState:
    """`opts.num_devices` ranks of `train`, one process each, on the
    devices `mesh.rank_device` gives them. A rank that fails fails the
    run (the others are stopped)."""
    import torch.multiprocessing as mp
    world = opts.num_devices
    device_type = torch.device("cuda" if device is None else device).type
    devices = [mesh.rank_device(rank, world, device_type, backend)
               for rank in range(world)]
    mesh.rank_rows(opts.batch_size, 0, world)       # raises if b % n
    if device_type == "cuda":
        from simplerecon_tpu_torch.ops import _build
        _build.build()      # once here, not once a rank
    log_dir = os.path.join(opts.log_dir, opts.name)
    os.makedirs(log_dir, exist_ok=True)
    init_file = os.path.join(log_dir, f".ranks-{os.getpid()}")
    if os.path.exists(init_file):
        os.remove(init_file)
    results = mp.get_context("spawn").SimpleQueue()
    # CPU ranks share this process's threads
    threads = max(1, torch.get_num_threads() // world)
    stats = {}
    try:
        ranks = mp.spawn(_rank_main, nprocs=world, join=False, args=(
            world, opts, device_type, backend, init_file, results, threads))
        while True:
            done = ranks.join(timeout=1)
            while not results.empty():
                rank, rank_stats = results.get()
                stats[rank] = rank_stats
            if done:
                break
    finally:
        if os.path.exists(init_file):
            os.remove(init_file)
    state = new_state(opts, devices[0])
    ckpt_lib.restore_checkpoint(os.path.join(log_dir, "checkpoints"), state)
    state.run_stats = dict(stats[0], ranks=[stats[r] for r in range(world)])
    return state


def _rank_main(rank: int, world: int, opts: Options, device_type: str,
               backend, init_file: str, results, threads: int) -> None:
    device = mesh.rank_device(rank, world, device_type, backend)
    if device.type == "cpu":
        torch.set_num_threads(threads)
    mesh.init_process_group(rank, world, init_file, device, backend)
    try:
        state = train(opts, device, rank=rank, world=world)
        results.put((rank, state.run_stats))
    finally:
        mesh.destroy_process_group()


def train(opts: Options, device: torch.device, rank: int = 0,
          world: int = 1, on_step=None) -> train_lib.TrainState:
    """The training loop of rank `rank` of `world` (one when there is no
    process group) on `device`; see `main`."""
    from simplerecon_tpu_torch.ops import launch_counts
    lead = rank == 0
    np.random.seed(opts.random_seed)
    log_dir = os.path.join(opts.log_dir, opts.name)
    ckpt_dir = os.path.join(log_dir, "checkpoints")
    logger = None
    if lead:
        os.makedirs(log_dir, exist_ok=True)
        save_options_yaml(os.path.join(log_dir, "options.yaml"), opts)
        from simplerecon_tpu_torch.utils.cache import copy_code_state
        try:
            copy_code_state(log_dir)
        except OSError as e:
            print(f"code snapshot failed: {e}")
        logger = JSONLLogger(log_dir)

    state = new_state(opts, device)
    model = state.model
    if opts.resume:
        ckpt_lib.restore_checkpoint(opts.resume, state)
        print(f"resumed from {opts.resume} at step {state.step}")
    elif opts.load_weights_from_checkpoint:
        ckpt_lib.load_weights(opts.load_weights_from_checkpoint, model)
        print(f"loaded weights from {opts.load_weights_from_checkpoint}")
    ddp_model = train_lib.wrap_ddp(model) if world > 1 else None
    lr_schedule = train_lib.make_lr_schedule(opts)
    train_loader, val_loader = build_dataloaders(opts, (rank, world))

    stats = dict(step_seconds=[], loader_seconds=[], val_seconds=[],
                 checkpoint_seconds=[])
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    def checkpoint(directory, keep):
        if not lead:
            return
        t0 = time.perf_counter()
        ckpt_lib.save_checkpoint(directory, state, opts, keep=keep)
        stats["checkpoint_seconds"].append(time.perf_counter() - t0)

    best_val_loss = float("inf")
    t_last = time.perf_counter()
    while state.step < opts.max_steps:
        batches = iter(device_prefetch(train_loader, device))
        while state.step < opts.max_steps:
            with tracing.span("sr.loader.wait") as wait:
                batch = next(batches, None)
            if batch is None:
                break
            if ddp_model is None:
                metrics = train_lib.train_step(state.model, state.optimizer,
                                               batch, state.generator)
            else:
                metrics = train_lib.ddp_train_step(
                    ddp_model, state.optimizer, batch, state.generator)
            state.step += 1
            stats["loader_seconds"].append(wait.seconds)
            stats["step_seconds"].append(tracing.last("sr.train_step").seconds)
            if on_step is not None:
                on_step(state, batch, metrics)

            if lead and state.step % opts.log_interval == 0:
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t_last
                t_last = time.perf_counter()
                metrics["steps_per_sec"] = opts.log_interval / max(dt, 1e-9)
                metrics["lr"] = float(lr_schedule(state.step))
                logger.log(state.step, metrics, prefix="train/")
                print(f"step {state.step}: loss={metrics['loss']:.4f} "
                      f"({metrics['steps_per_sec']:.2f} it/s)")

            if lead and state.step % opts.val_interval == 0:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                val_loss = validate(state, val_loader, opts, device, logger,
                                    state.step,
                                    os.path.join(log_dir, "panels"))
                stats["val_seconds"].append(time.perf_counter() - t0)
                if val_loss is not None:
                    logger.log(state.step, {"loss": val_loss}, prefix="val/")
                    print(f"step {state.step}: val loss {val_loss:.4f}")
                    checkpoint(ckpt_dir, 2)
                    if val_loss < best_val_loss:
                        best_val_loss = val_loss
                        checkpoint(os.path.join(log_dir, "best"), 1)

    checkpoint(ckpt_dir, 2)
    if lead:
        logger.close()
        print(f"training done at step {state.step}")
    stats["steps"] = len(stats["step_seconds"])
    stats["loader_wait_seconds"] = sum(stats["loader_seconds"])
    stats["launches"] = launch_counts()
    stats["peak_memory_bytes"] = (torch.cuda.max_memory_allocated(device)
                                  if device.type == "cuda" else 0)
    state.run_stats = stats
    return state


if __name__ == "__main__":
    handler = OptionsHandler()
    opts = handler.parse_and_merge_options()
    handler.pretty_print_options()
    main(opts)
