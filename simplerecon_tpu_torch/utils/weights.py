"""Weights for the port: seeded random init, and the bridge from the JAX
package's variables.

The port's parameters carry the reference Lightning state_dict names, so
`jax_to_state_dict` is the inverse of
`simplerecon_tpu.utils.convert_reference_checkpoint.convert_state_dict`:
a JAX `{"params", "batch_stats"}` tree (as numpy arrays) becomes a
state_dict that both the port and `convert_state_dict` read. Transposes:
conv kernels (kH, kW, I, O) -> (O, I, kH, kW), depthwise kernels
(kH, kW, 1, C) -> (C, 1, kH, kW), dense kernels (I, O) -> (O, I); BatchNorm
scale/bias/mean/var -> weight/bias/running_mean/running_var; GroupNorm
(a scale without batch statistics) scale/bias -> weight/bias.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Iterator, Tuple

import numpy as np
import torch
import torch.nn as nn


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraws every conv and linear layer from `generator` as the JAX
    package initialises them (flax's defaults: weights normal with
    variance 1/fan_in, biases zero) and resets BatchNorm and GroupNorm to
    the identity. In place; returns `model`."""
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            std = 1.0 / math.sqrt(mod.weight[0].numel())
            mod.weight.copy_(torch.empty(mod.weight.shape).normal_(
                0.0, std, generator=generator))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.BatchNorm2d, nn.GroupNorm)):
            mod.reset_parameters()
    return model


def _leaf_modules(tree: Dict, path: Tuple[str, ...] = ()
                  ) -> Iterator[Tuple[Tuple[str, ...], Dict]]:
    """Yields (path, {param name: array}) for every JAX leaf module."""
    if any(not isinstance(v, dict) for v in tree.values()):
        yield path, tree
        return
    for name, sub in tree.items():
        yield from _leaf_modules(sub, path + (name,))


def _block_leaf(leaf: str) -> str:
    return "downsample.0" if leaf == "downsample_conv" else leaf


def _torch_prefix(path: Tuple[str, ...], unet: bool = False) -> str:
    """Reference state_dict prefix of the JAX leaf module at `path`;
    `unet`: the matching model is the `UNetMatchingEncoder`."""
    top, rest = path[0], path[1:]
    if top == "matching_model" and unet:
        fixed = {"conv_stem": "encoder.conv_stem", "bn1": "encoder.bn1",
                 "layer_1": "decoder.layer_blocks.1", "outconv": "outconv.1"}
        if rest[0] in fixed:
            return f"matching_model.{fixed[rest[0]]}"
        inner = re.fullmatch(r"inner_(\d)", rest[0])
        if inner:
            return f"matching_model.decoder.inner_blocks.{inner.group(1)}"
        blk = re.fullmatch(r"blocks_(\d)_(\d)", rest[0])
        return (f"matching_model.encoder.blocks.{blk.group(1)}."
                f"{blk.group(2)}.{rest[1]}")
    if top == "matching_model":
        fixed = {"conv1": "net.0", "bn1": "net.1", "head_conv1": "net.5",
                 "head_conv2": "net.8"}
        if rest[0] in fixed:
            return f"matching_model.{fixed[rest[0]]}"
        blk = re.fullmatch(r"layer1_(\d)", rest[0])
        return f"matching_model.net.4.{blk.group(1)}.{rest[1]}"
    if top == "cost_volume":
        i = int(re.fullmatch(r"dense(\d+)", rest[1]).group(1))
        return f"cost_volume.mlp.net.{2 * i}"
    if top == "cost_volume_net":
        m = re.fullmatch(r"conv_(\d)([ab])", rest[0])
        name = (f"conv_{m.group(1)}.{'ab'.index(m.group(2))}" if m
                else rest[0])
        return f"cost_volume_net.convs.{name}.{_block_leaf(rest[1])}"
    if top == "depth_decoder":
        out = re.fullmatch(r"output_(\d)_(block|conv)", rest[0])
        if out:
            idx = 0 if out.group(2) == "block" else 1
            tail = (f".{_block_leaf(rest[1])}" if len(rest) > 1 else "")
            return f"depth_decoder.convs.output_{out.group(1)}.{idx}{tail}"
        if rest[0].startswith("in_conv_"):
            blk = rest[1].replace("block", "")
            return (f"depth_decoder.convs.{rest[0]}.{blk}."
                    f"{_block_leaf(rest[2])}")
        return f"depth_decoder.convs.{rest[0]}.{_block_leaf(rest[1])}"
    if top == "encoder":
        if rest[0] in ("conv_stem", "bn_stem"):
            return "encoder." + {"conv_stem": "conv_stem",
                                 "bn_stem": "bn1"}[rest[0]]
        m = re.fullmatch(r"stage(\d+)_block(\d+)", rest[0])
        return (f"encoder.blocks.{m.group(1)}.{m.group(2)}."
                + ".".join(rest[1:]))
    raise KeyError(f"no state_dict name for JAX module {'/'.join(path)}")


def jax_to_state_dict(params: Dict, batch_stats: Dict
                      ) -> Dict[str, np.ndarray]:
    """JAX DepthModel variables (numpy leaves) -> the port's state_dict,
    including the BlurPool filter and `num_batches_tracked` buffers. A
    norm with a scale is a BatchNorm where `batch_stats` holds its
    statistics and a GroupNorm where it holds none."""
    sd: Dict[str, np.ndarray] = {}
    unet = "conv_stem" in params.get("matching_model", {})
    for path, leaf in _leaf_modules(params):
        prefix = _torch_prefix(path, unet)
        if "scale" in leaf:
            sd[f"{prefix}.weight"] = np.asarray(leaf["scale"])
            sd[f"{prefix}.bias"] = np.asarray(leaf["bias"])
            stats = batch_stats
            for p in path:
                stats = stats.get(p, {})
            if not stats:   # GroupNorm
                continue
            sd[f"{prefix}.running_mean"] = np.asarray(stats["mean"])
            sd[f"{prefix}.running_var"] = np.asarray(stats["var"])
            sd[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)
            continue
        kernel = np.asarray(leaf["kernel"])
        perm = (3, 2, 0, 1) if kernel.ndim == 4 else (1, 0)
        sd[f"{prefix}.weight"] = np.ascontiguousarray(kernel.transpose(perm))
        if "bias" in leaf:
            sd[f"{prefix}.bias"] = np.asarray(leaf["bias"])
    if "matching_model.net.0.weight" in sd:
        a = np.array([1.0, 3.0, 3.0, 1.0], np.float32)
        filt = np.outer(a, a) / np.outer(a, a).sum()
        ch = sd["matching_model.net.0.weight"].shape[0]
        sd["matching_model.net.3.1.filt"] = np.ascontiguousarray(
            np.broadcast_to(filt, (ch, 1, 4, 4)))
    return sd


def load_jax_variables(model: nn.Module, variables: Dict) -> nn.Module:
    """Loads JAX `{"params", "batch_stats"}` (numpy leaves) into `model`,
    strictly: every port parameter and buffer must be covered."""
    sd = jax_to_state_dict(variables["params"], variables["batch_stats"])
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()}, strict=True)
    return model
