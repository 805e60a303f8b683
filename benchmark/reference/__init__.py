"""The plain float32 reference of the benchmark's configurations. Each
configuration's file names its reference under `reference`: a Python
file under `benchmark/` whose `build(config)` returns the reference
model (the interface of `model.py::DepthModel`: `forward(cur, src,
flip=False, return_mask=False)`, `set_precision("float32" | "fp8")` and
`set_checkpoint_sweep(on)`). A later architecture comes as a new file
beside `model.py`, which may import that file's parts. Loading a
reference imports neither JAX nor any package of this repository's
program."""

from __future__ import annotations

import ast
import importlib
import sys
from pathlib import Path
from typing import Dict

import torch
import torch.nn as nn

from benchmark.harness import FORBIDDEN

ROOT = Path(__file__).resolve().parents[2]
# what no reference may import: JAX, the JAX package and the port
NOT_IMPORTED = FORBIDDEN + ("simplerecon_tpu_torch",)
# the affine norms whose scales the weight generator draws about 1
NORMS = (nn.modules.batchnorm._NormBase, nn.GroupNorm, nn.LayerNorm)
# buffers drawn from the seed; every other buffer is a constant kept as
# the reference builds it
DRAWN_BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def _imported(path: Path) -> set:
    """The top-level names of the modules that `path` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def module(config: Dict):
    """The module of `config`'s `reference` file, imported once under its
    dotted name (`benchmark/reference/model.py` is
    `benchmark.reference.model`), so that a file which imports another
    reference's parts shares them."""
    path = (ROOT / config["reference"]).resolve()
    rel = path.relative_to(ROOT)
    if rel.parts[0] != "benchmark" or path.suffix != ".py" \
            or not path.is_file():
        raise ValueError(f"reference {config['reference']!r} is not a "
                         f"Python file under benchmark/")
    name = ".".join(rel.with_suffix("").parts)
    if name in sys.modules:
        return sys.modules[name]
    _refuse(rel, _imported(path))
    before = set(sys.modules)
    try:
        loaded = importlib.import_module(name)
        _refuse(rel, {m.split(".")[0] for m in set(sys.modules) - before})
    except BaseException:
        sys.modules.pop(name, None)
        raise
    return loaded


def _refuse(rel: Path, names: set) -> None:
    bad = sorted(names & set(NOT_IMPORTED))
    if bad:
        raise ImportError(f"reference {rel} imports {', '.join(bad)}")


def build(config: Dict, device) -> nn.Module:
    """The reference model of `config` on `device` (its own init)."""
    with torch.device(device):
        return module(config).build(config)


def layout(config: Dict, device="cpu") -> tuple:
    """(state-dict shapes, the norm modules' names, the constant buffers)
    of `config`'s model: what the weight generator draws over. The model
    is built on `device` for its shapes and dropped."""
    model = build(config, device)
    state = model.state_dict()
    shapes = {n: tuple(t.shape) for n, t in state.items()}
    norms = frozenset(n for n, m in model.named_modules()
                      if isinstance(m, NORMS))
    buffers = {n for n, _ in model.named_buffers()}
    fixed = {n: t.detach().clone() for n, t in state.items()
             if n in buffers and not n.endswith(DRAWN_BUFFERS)}
    return shapes, norms, fixed


def load(config: Dict, state: Dict[str, torch.Tensor], device,
         precision: str = "float32") -> nn.Module:
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
