"""The system under test, as the benchmark drives it: the PyTorch and
CUDA port `simplerecon_tpu_torch`, through its own entries
(`models/depth_model.py::DepthModel`, `parallel/train.py::train_step`
and `make_optimizer`, `scripts/test.py::make_forward_fn`, the eval CLI's
forward: eval mode, `inference_mode`, the model's autocast; and
`parallel/mesh.py` for ranks). Nothing else of the benchmark imports the
port.
"""

from __future__ import annotations

from typing import Dict

import torch

from simplerecon_tpu_torch.models import depth_model
from simplerecon_tpu_torch.options import Options
from simplerecon_tpu_torch.parallel import mesh  # noqa: F401  (the ranks')
from simplerecon_tpu_torch.parallel import train as train_lib
from simplerecon_tpu_torch.scripts.test import make_forward_fn  # noqa: F401

# the config keys the port's Options take; the rest describe the file
_NOT_OPTIONS = ("source", "assumed", "reference", "run_as")


def options(config: Dict) -> Options:
    opts = Options()
    opts.update_from({k: v for k, v in config.items()
                      if k not in _NOT_OPTIONS})
    return opts


def build_model(config: Dict, state: Dict[str, torch.Tensor], device
                ) -> torch.nn.Module:
    """The port's depth model for `config` on `device`, holding `state`
    (the benchmark's seeded weights): built as `build_depth_model` builds
    it, on the device, without its host-side initializer."""
    opts = options(config)
    backend = getattr(opts, "cost_volume_backend", "xla_fused")
    with torch.device(device):
        model = depth_model.DepthModel(
            matching_scale=opts.matching_scale,
            matching_num_depth_bins=opts.matching_num_depth_bins,
            min_matching_depth=opts.min_matching_depth,
            max_matching_depth=opts.max_matching_depth,
            matching_feature_dims=opts.matching_feature_dims,
            matching_norm=opts.matching_norm,
            matching_pool_impl=opts.matching_pool_impl,
            model_num_views=opts.model_num_views,
            feature_volume_type=opts.feature_volume_type,
            compute_dtype=depth_model._compute_dtype(opts),
            hero_sweep=depth_model.HERO_SWEEPS[backend],
            matching_encoder_type=opts.matching_encoder_type)
    model.load_state_dict(state)
    return model.eval()


class Trainer:
    """The training step as the training CLI runs it: `train_step` on one
    model, its optimizer and its flip generator, handed from set-up to
    the window as one object."""

    def __init__(self, config: Dict, model, flip_generator: torch.Generator):
        self.model = model
        self.optimizer = train_lib.make_optimizer(options(config), model)
        self.generator = flip_generator

    def step(self, batch) -> Dict[str, torch.Tensor]:
        return train_lib.train_step(self.model, self.optimizer, batch,
                                    self.generator)

    def first_moments(self) -> Dict[str, torch.Tensor]:
        """AdamW's first moment of each parameter, by name (empty before
        the first applied update)."""
        state = self.optimizer.inner.state
        return {name: state[p]["exp_avg"]
                for name, p in self.model.named_parameters() if p in state}

    def beta1(self) -> float:
        return self.optimizer.inner.param_groups[0]["betas"][0]


# --------------------------------------------------------------------------
# data-parallel training over ranks: `mesh.rank_device` and
# `mesh.shard_batch` (`parallel/mesh.py`), `wrap_ddp` and `ddp_train_step`
# --------------------------------------------------------------------------

class DdpTrainer(Trainer):
    """The data-parallel step as the training CLI's ranks run it:
    `ddp_train_step` on `wrap_ddp`'s model, on this rank's rows."""

    def __init__(self, config: Dict, model, flip_generator: torch.Generator):
        super().__init__(config, model, flip_generator)
        self.ddp = train_lib.wrap_ddp(model)

    def step(self, batch) -> Dict[str, torch.Tensor]:
        return train_lib.ddp_train_step(self.ddp, self.optimizer, batch,
                                        self.generator)
