"""Ranks, process groups and batch shards (counterpart of
`simplerecon_tpu/parallel/mesh.py`).

The JAX package lays its devices out as a one-axis `data` mesh; here
that axis is the ranks of a `torch.distributed` process group, one
process a rank. Each rank holds a replica of the model and takes rows
[rank * b / world, (rank + 1) * b / world) of every global batch of b
rows (`shard_batch`, or a `DataLoader` built with `shard=`). A layout
over several hosts (the JAX `make_hybrid_mesh`) is the same group with
ranks on every node: `torch.distributed` starts them through one
rendezvous address and needs no other code here.

Backends: NCCL when each rank has a card of its own, gloo on the CPU.
gloo also carries CUDA tensors, through host memory, so several ranks
can share one card when the caller asks for gloo by name
(`rank_device`); NCCL refuses two ranks of one communicator on a card.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
# how long a rank waits for the others at a collective before the run
# fails
TIMEOUT = datetime.timedelta(minutes=10)


def default_backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def rank_device(rank: int, world: int, device_type: str,
                backend: Optional[str] = None) -> torch.device:
    """The device of `rank`: the CPU, or `cuda:{rank}`. With more ranks
    than visible cards this raises, unless `backend` is "gloo" by name:
    then the ranks take the cards in turn, `cuda:{rank % cards}`."""
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    if device_type == "cpu":
        if backend == "nccl":
            raise ValueError("NCCL needs CUDA devices")
        return torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"no ranks on device type {device_type!r}")
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the ranks on the CPU")
    if world > cards and backend != "gloo":
        raise RuntimeError(
            f"{world} ranks but {cards} visible CUDA device(s): NCCL takes "
            f"one rank a card; ask for at most {cards} (--num_devices), or "
            "name backend='gloo' to share cards")
    return torch.device("cuda", rank % cards)


def init_process_group(rank: int, world: int, init_file: str,
                       device: torch.device,
                       backend: Optional[str] = None) -> str:
    """Joins `rank` to a process group of `world` ranks that meet through
    the file `init_file` (absent before the first rank starts, on a file
    system every rank sees). Returns the backend. A failed join
    raises."""
    backend = backend or default_backend(device.type)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method="file://" + os.path.abspath(init_file),
        rank=rank, world_size=world, timeout=TIMEOUT,
        **({"device_id": device} if backend == "nccl" else {}))
    return backend


def destroy_process_group():
    if dist.is_initialized():
        dist.destroy_process_group()


def rank_rows(batch_size: int, rank: int, world: int) -> slice:
    """The rows of a global batch that `rank` takes."""
    if batch_size % world:
        raise ValueError(f"batch_size {batch_size} must divide over {world} "
                         "ranks")
    rows = batch_size // world
    return slice(rank * rows, (rank + 1) * rows)


def shard_batch(batch, rank: int, world: int):
    """Rank `rank`'s rows of a global batch: a dict of dicts of arrays or
    tensors, whose leading axis is the batch (lists of frame ids are cut
    the same way)."""
    first = next(v for part in batch.values() for v in part.values()
                 if hasattr(v, "shape"))
    rows = rank_rows(first.shape[0], rank, world)
    return {part: {key: value[rows] for key, value in data.items()}
            for part, data in batch.items()}
