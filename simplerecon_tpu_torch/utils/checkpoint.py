"""Checkpoints: full training state with resume, weights-only loads, and
the options stored beside them (counterpart of
`simplerecon_tpu/utils/checkpoint.py`).

The JAX package's layout, with `torch.save` files in place of orbax:

    <ckpt_dir>/step_<N>/state.pt       full state (`save_checkpoint`)
    <ckpt_dir>/step_<N>/weights.pt     weights only (`strip_checkpoint`)
    <ckpt_dir>/step_<N>/options.yaml

The full state is a `parallel/train.py::TrainState`: the model's
state_dict (batch-norm statistics included), the AdamW moments, the
optimizer's update count and its skip counters, the step, and the
flip generator's state. Restoring it gives back the same bits.
`save_checkpoint` keeps the newest `keep` step directories.

`save_weights` writes one file `{"state_dict", "options"}`. The weight
loaders take a checkpoint directory (its newest step), a step directory
or a file: one of these, a bare state_dict, or a reference Lightning
file, whose `state_dict` holds the same names as the port's modules.
The options stored with a checkpoint are authoritative for the model at
inference.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Optional

import torch
import torch.nn as nn

from simplerecon_tpu_torch.options import (Options, load_options_yaml,
                                           save_options_yaml)

_STEP_RE = re.compile(r"^step_(\d+)$")
STATE_FILE = "state.pt"
WEIGHTS_FILE = "weights.pt"


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"step_{step}")


def _steps(ckpt_dir: str) -> list:
    return sorted(int(m.group(1)) for d in os.listdir(ckpt_dir)
                  if (m := _STEP_RE.match(d)))


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The largest N of the `step_<N>` directories under `ckpt_dir`, or
    None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def _cpu(tree):
    """A copy of `tree` (dicts, lists, tuples of tensors and scalars) with
    every tensor on the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def _state_blob(state, opts: Optional[Options]) -> dict:
    optimizer = state.optimizer
    return {"state_dict": _cpu(state.model.state_dict()),
            "optimizer": _cpu(optimizer.inner.state_dict()),
            "count": optimizer.count,
            "consecutive_errors": optimizer.consecutive_errors,
            "total_errors": optimizer.total_errors,
            "step": state.step,
            "generator": state.generator.get_state(),
            "options": None if opts is None else opts.to_dict()}


def save_checkpoint(ckpt_dir: str, state, opts: Optional[Options] = None,
                    keep: int = 2) -> str:
    """Writes the full `state` (a `TrainState`) and the options under
    `<ckpt_dir>/step_<state.step>/`, then removes all but the newest
    `keep` step directories. Returns the step directory."""
    path = _step_dir(ckpt_dir, state.step)
    os.makedirs(path, exist_ok=True)
    torch.save(_state_blob(state, opts), os.path.join(path, STATE_FILE))
    if opts is not None:
        save_options_yaml(os.path.join(path, "options.yaml"), opts)
    for s in _steps(ckpt_dir)[:-keep]:
        shutil.rmtree(_step_dir(ckpt_dir, s), ignore_errors=True)
    return path


def _read(path: str) -> dict:
    # a reference Lightning file pickles more than tensors
    return torch.load(path, map_location="cpu", weights_only=False)


def _resolve(path: str, step: Optional[int] = None) -> str:
    """The step directory of `path`: `path` itself when it is a
    `step_<N>` directory, else `<path>/step_<step>` (the newest step
    when `step` is None)."""
    if _STEP_RE.match(os.path.basename(os.path.normpath(path))):
        return path
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    return _step_dir(path, step)


def _blob_file(path: str, step: Optional[int] = None) -> str:
    """The file to read the weights of `path` from: `path` itself when
    it is a file, else the state or weights file of its step
    directory."""
    if os.path.isfile(path):
        return path
    step_dir = _resolve(path, step)
    for name in (STATE_FILE, WEIGHTS_FILE):
        if os.path.isfile(os.path.join(step_dir, name)):
            return os.path.join(step_dir, name)
    raise FileNotFoundError(f"no {STATE_FILE} or {WEIGHTS_FILE} in "
                            f"{step_dir}")


def restore_checkpoint(ckpt_dir: str, state, step: Optional[int] = None):
    """Full-state resume: loads the checkpoint of `ckpt_dir` (its newest
    step unless `step` is given; or a step directory) into `state` in
    place, on the model's device. Returns `state`."""
    blob = _read(os.path.join(_resolve(ckpt_dir, step), STATE_FILE))
    state.model.load_state_dict(blob["state_dict"], strict=True)
    optimizer = state.optimizer
    optimizer.inner.load_state_dict(blob["optimizer"])
    optimizer.count = blob["count"]
    optimizer.consecutive_errors = blob["consecutive_errors"]
    optimizer.total_errors = blob["total_errors"]
    state.step = blob["step"]
    state.generator.set_state(blob["generator"])
    return state


def save_weights(path: str, model: nn.Module,
                 opts: Optional[Options] = None) -> str:
    """Writes the model's state_dict (on the CPU) and the options to one
    file."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"state_dict": _cpu(model.state_dict()),
                "options": None if opts is None else opts.to_dict()}, path)
    return path


def load_weights(path: str, model: nn.Module, strict: bool = True,
                 step: Optional[int] = None) -> nn.Module:
    """Loads the weights of a checkpoint directory (its newest step, or
    `step`), a step directory, a port file, a bare state_dict or a
    reference Lightning file into `model`, on the model's device. The
    optimizer state of a full checkpoint is not read."""
    blob = _read(_blob_file(path, step))
    state = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    # a Lightning file keeps the trainer's bookkeeping beside the weights
    state = {k: v for k, v in state.items() if isinstance(v, torch.Tensor)}
    model.load_state_dict(state, strict=strict)
    return model


def load_options_from_checkpoint(path: str, step: Optional[int] = None
                                 ) -> Optional[Options]:
    """The options stored with a checkpoint: the `options.yaml` of a
    checkpoint or step directory, or those inside a file; None when it
    holds none."""
    if not os.path.isfile(path):
        yaml_path = os.path.join(_resolve(path, step), "options.yaml")
        if os.path.isfile(yaml_path):
            return Options.from_dict(load_options_yaml(yaml_path))
        path = _blob_file(path, step)
    blob = _read(path)
    stored = blob.get("options") if isinstance(blob, dict) else None
    return None if stored is None else Options.from_dict(stored)


def strip_checkpoint(src_dir: str, dst_dir: str,
                     step: Optional[int] = None) -> str:
    """Writes a weights-only copy of a full checkpoint (the model's
    state_dict, the step and the options, no optimizer state) to
    `<dst_dir>/step_<N>/`, with its `options.yaml`. Returns that
    directory."""
    src = _resolve(src_dir, step)
    blob = _read(os.path.join(src, STATE_FILE))
    path = _step_dir(dst_dir, blob["step"])
    os.makedirs(path, exist_ok=True)
    torch.save({"state_dict": blob["state_dict"], "step": blob["step"],
                "options": blob["options"]},
               os.path.join(path, WEIGHTS_FILE))
    opts_yaml = os.path.join(src, "options.yaml")
    if os.path.exists(opts_yaml):
        shutil.copy(opts_yaml, os.path.join(path, "options.yaml"))
    return path
