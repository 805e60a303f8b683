"""Weights and options in one `torch.save` file (counterpart of the
weights-only parts of `simplerecon_tpu/utils/checkpoint.py`).

The file holds `{"state_dict": ..., "options": ...}`: the model's
state_dict (the reference's parameter names, which the port's modules
use) and the options as a plain dict. The options in a checkpoint are
authoritative for the model at inference. `load_weights` also takes a
bare state_dict or a reference Lightning file, whose `state_dict` holds
the same names.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn as nn

from simplerecon_tpu_torch.options import Options


def save_checkpoint(path: str, model: nn.Module,
                    opts: Optional[Options] = None) -> str:
    """Writes the model's state_dict (on the CPU) and the options."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    blob = {"state_dict": {k: v.detach().cpu()
                           for k, v in model.state_dict().items()},
            "options": None if opts is None else opts.to_dict()}
    torch.save(blob, path)
    return path


def _read(path: str) -> dict:
    # a reference Lightning file pickles more than tensors
    return torch.load(path, map_location="cpu", weights_only=False)


def load_weights(path: str, model: nn.Module, strict: bool = True
                 ) -> nn.Module:
    """Loads the weights of a port checkpoint, a bare state_dict or a
    reference Lightning file into `model`, on the model's device."""
    blob = _read(path)
    state = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    # a Lightning file keeps the trainer's bookkeeping beside the weights
    state = {k: v for k, v in state.items() if isinstance(v, torch.Tensor)}
    model.load_state_dict(state, strict=strict)
    return model


def load_options_from_checkpoint(path: str) -> Optional[Options]:
    """The options stored with a port checkpoint, or None when it holds
    none."""
    blob = _read(path)
    stored = blob.get("options") if isinstance(blob, dict) else None
    return None if stored is None else Options.from_dict(stored)
