"""The plain float32 reference of the benchmark's configurations. It
imports neither JAX nor any package of this repository's program."""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference.model import BatchNorm2d, DepthModel, blur_filter

MODEL_KEYS = ("feature_volume_type", "matching_num_depth_bins",
              "min_matching_depth", "max_matching_depth",
              "matching_feature_dims", "model_num_views")


def build(config: Dict, device) -> DepthModel:
    """The reference model of `config` on `device` (its own init)."""
    with torch.device(device):
        return DepthModel(**{k: config[k] for k in MODEL_KEYS})


def layout(config: Dict, device="cpu") -> tuple:
    """(state-dict shapes, the norm modules' names, the constant buffers)
    of `config`'s model: what the weight generator draws over. The model
    is built on `device` for its shapes and dropped."""
    model = build(config, device)
    shapes = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    norms = frozenset(n for n, m in model.named_modules()
                      if isinstance(m, BatchNorm2d))
    fixed = {n: blur_filter(t.shape[0]) for n, t in model.state_dict().items()
             if n.endswith(".filt")}
    return shapes, norms, fixed


def load(config: Dict, state: Dict[str, torch.Tensor], device,
         precision: str = "float32") -> DepthModel:
    """The reference model of `config` on `device` holding a copy of
    `state`, computing in `precision` ("float32", or the control's
    "fp8")."""
    model = build(config, device)
    model.load_state_dict({k: v.detach().clone() for k, v in state.items()})
    return model.set_precision(precision)


def float32_exactly():
    """Turns TF32 off for the reference's products; returns a function
    that restores the earlier settings."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def restore():
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before
    return restore
