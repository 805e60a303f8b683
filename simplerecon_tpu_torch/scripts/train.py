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

Runs on one CUDA card (`num_devices` above 1 is taken as 1);
`main(opts, device="cpu")` runs on the CPU. The initial weights are drawn
from `opts.random_seed`, and so is the flip coin's generator.

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

from simplerecon_tpu_torch.data.loader import (DataLoader, device_prefetch,
                                               to_train_schema)
from simplerecon_tpu_torch.data.registry import get_dataset
from simplerecon_tpu_torch.models.depth_model import (build_depth_model,
                                                      resolve_device)
from simplerecon_tpu_torch.options import (Options, OptionsHandler,
                                           save_options_yaml)
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


def build_dataloaders(opts: Options):
    """The training loader (shuffled, seeded by `random_seed`) and the
    validation loader, both dropping a last partial batch."""
    dataset_class, _ = get_dataset(opts.dataset,
                                   opts.dataset_scan_split_file or None,
                                   opts.single_debug_scan_id,
                                   verbose=False)

    def make(split, shuffle, batch_size):
        ds = dataset_class(
            dataset_path=opts.dataset_path, split=split,
            mv_tuple_file_suffix=opts.mv_tuple_file_suffix,
            tuple_info_file_location=opts.tuple_info_file_location or None,
            num_images_in_tuple=opts.num_images_in_tuple
            or opts.model_num_views,
            image_height=opts.image_height, image_width=opts.image_width,
            shuffle_tuple=opts.shuffle_tuple)
        return DataLoader(ds, batch_size=batch_size, shuffle=shuffle,
                          num_workers=opts.num_workers, drop_last=True,
                          adapter=to_train_schema, seed=opts.random_seed)

    return (make("train", True, opts.batch_size),
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


def main(opts: Options, device=None, on_step=None):
    """Trains the model of `opts` on `device` (the CUDA card unless
    another is given) to `opts.max_steps`; `on_step(state, batch,
    metrics)`, when given, is called after each step. Returns the
    `TrainState`, with `run_stats`: the host seconds of each step, of
    each loader wait, of each validation and each checkpoint write, the
    card's peak memory (bytes) and the steps run."""
    device = resolve_device(device)
    np.random.seed(opts.random_seed)
    log_dir = os.path.join(opts.log_dir, opts.name)
    ckpt_dir = os.path.join(log_dir, "checkpoints")
    os.makedirs(log_dir, exist_ok=True)
    save_options_yaml(os.path.join(log_dir, "options.yaml"), opts)
    from simplerecon_tpu_torch.utils.cache import copy_code_state
    try:
        copy_code_state(log_dir)
    except OSError as e:
        print(f"code snapshot failed: {e}")
    logger = JSONLLogger(log_dir)

    if opts.num_devices > 1:
        print(f"num_devices {opts.num_devices}: training on one device")
    model = build_depth_model(opts, device=device, seed=opts.random_seed)
    state = train_lib.TrainState(
        model=model, optimizer=train_lib.make_optimizer(opts, model),
        generator=torch.Generator().manual_seed(opts.random_seed))
    if opts.resume:
        ckpt_lib.restore_checkpoint(opts.resume, state)
        print(f"resumed from {opts.resume} at step {state.step}")
    elif opts.load_weights_from_checkpoint:
        ckpt_lib.load_weights(opts.load_weights_from_checkpoint, model)
        print(f"loaded weights from {opts.load_weights_from_checkpoint}")
    lr_schedule = train_lib.make_lr_schedule(opts)
    train_loader, val_loader = build_dataloaders(opts)

    stats = dict(step_seconds=[], loader_seconds=[], val_seconds=[],
                 checkpoint_seconds=[])
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    def checkpoint(directory, keep):
        t0 = time.perf_counter()
        ckpt_lib.save_checkpoint(directory, state, opts, keep=keep)
        stats["checkpoint_seconds"].append(time.perf_counter() - t0)

    best_val_loss = float("inf")
    t_last = time.perf_counter()
    while state.step < opts.max_steps:
        batches = iter(device_prefetch(train_loader, device))
        while state.step < opts.max_steps:
            t0 = time.perf_counter()
            batch = next(batches, None)
            t1 = time.perf_counter()
            if batch is None:
                break
            metrics = train_lib.train_step(state.model, state.optimizer,
                                           batch, state.generator)
            state.step += 1
            stats["loader_seconds"].append(t1 - t0)
            stats["step_seconds"].append(time.perf_counter() - t1)
            if on_step is not None:
                on_step(state, batch, metrics)

            if state.step % opts.log_interval == 0:
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t_last
                t_last = time.perf_counter()
                metrics["steps_per_sec"] = opts.log_interval / max(dt, 1e-9)
                metrics["lr"] = float(lr_schedule(state.step))
                logger.log(state.step, metrics, prefix="train/")
                print(f"step {state.step}: loss={metrics['loss']:.4f} "
                      f"({metrics['steps_per_sec']:.2f} it/s)")

            if state.step % opts.val_interval == 0:
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
    logger.close()
    print(f"training done at step {state.step}")
    stats["steps"] = len(stats["step_seconds"])
    stats["peak_memory_bytes"] = (torch.cuda.max_memory_allocated(device)
                                  if device.type == "cuda" else 0)
    state.run_stats = stats
    return state


if __name__ == "__main__":
    handler = OptionsHandler()
    opts = handler.parse_and_merge_options()
    handler.pretty_print_options()
    main(opts)
