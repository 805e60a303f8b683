"""Batching loader and host-to-device double buffer (counterpart of
`simplerecon_tpu/data/loader.py`).

`DataLoader` decodes tuples in a thread pool (numpy and the native
rasterizer release the GIL for the heavy parts) while a background
thread keeps a bounded queue of ready batches, numpy dicts
`{"cur": ..., "src": ...}`. Each item draws its augmentation from a
state of its own, made from (seed, epoch, index) (`item_rng`), and the
epoch's order from the loader's seeded state, so the batches depend on
neither `num_workers` nor the threads' timing; a loader given
`shard=(rank, world)` decodes only that rank's rows of each batch,
which are the rows a single loader would give there.

`device_prefetch` moves the batches onto a device, one batch ahead of
the consumer: on a CUDA device each array is copied into pinned host
memory and then, without blocking, to the card on a side stream, and
the consumer's stream waits for that copy before it takes the batch. String leaves (frame ids) pass through.
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch


def collate(elements: List[Tuple[Dict, Dict]]) -> Dict[str, Dict]:
    """Stacks `(cur_data, src_data)` pairs into a batch dict."""
    cur_keys = elements[0][0].keys()
    src_keys = elements[0][1].keys()

    def stack(dicts, key):
        vals = [d[key] for d in dicts]
        if isinstance(vals[0], (str, list)):
            return vals
        return np.stack(vals, axis=0)

    cur = {k: stack([e[0] for e in elements], k) for k in cur_keys}
    src = {k: stack([e[1] for e in elements], k) for k in src_keys}
    return {"cur": cur, "src": src}


def to_train_schema(batch: Dict[str, Dict]) -> Dict[str, Dict]:
    """Adapts a reference-schema batch (depth_b1hw with a channel dim) to
    the training step's schema (depth_bhw, mask_b_bhw, depth_bkhw)."""
    cur, src = dict(batch["cur"]), dict(batch["src"])
    if "depth_b1hw" in cur:
        cur["depth_bhw"] = cur.pop("depth_b1hw")[:, 0]
        cur.pop("mask_b1hw", None)
        cur["mask_b_bhw"] = cur.pop("mask_b_b1hw")[:, 0]
        # the losses expect zero-filled (not NaN) GT outside the mask
        cur["depth_bhw"] = np.nan_to_num(cur["depth_bhw"], nan=0.0)
    if "depth_b1hw" in src:
        src["depth_bkhw"] = np.nan_to_num(src.pop("depth_b1hw")[:, :, 0],
                                          nan=0.0)
        src.pop("mask_b1hw", None)
        src.pop("mask_b_b1hw", None)
    return {"cur": cur, "src": src}


def device_prefetch(batches, device, size: int = 2
                    ) -> Iterator[Dict[str, Dict]]:
    """Yields each batch of `batches` with its numpy arrays as tensors on
    `device`, keeping up to `size` batches in flight ahead of the
    consumer so that the copy of batch n+1 overlaps the work on batch n.
    """
    device = torch.device(device)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def put(batch):
        def leaf(x):
            if not isinstance(x, np.ndarray):
                return x
            t = torch.from_numpy(np.ascontiguousarray(x))
            if stream is None:
                return t.to(device)
            with torch.cuda.stream(stream):
                return t.pin_memory().to(device, non_blocking=True)

        moved = {part: {k: leaf(v) for k, v in data.items()}
                 for part, data in batch.items()}
        event = None
        if stream is not None:
            event = torch.cuda.Event()
            event.record(stream)
        return moved, event

    def take(entry):
        moved, event = entry
        if event is not None:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(event)
            for data in moved.values():
                for v in data.values():
                    if isinstance(v, torch.Tensor):
                        # the consumer's stream uses the copy's memory
                        v.record_stream(consumer)
        return moved

    it = iter(batches)
    buf = collections.deque()
    for batch in it:
        buf.append(put(batch))
        if len(buf) == size:
            break
    while buf:
        out = buf.popleft()
        nxt = next(it, None)
        if nxt is not None:
            buf.append(put(nxt))
        yield take(out)


def item_rng(seed: int, epoch: int, index: int) -> np.random.RandomState:
    """The state item `index` of epoch `epoch` draws its flip coin,
    shuffle and colour jitter from."""
    return np.random.RandomState(np.random.MT19937(
        np.random.SeedSequence([seed, epoch, int(index)])))


class DataLoader:
    """Iterates batches over a dataset with threaded decode and prefetch.

    Args:
        dataset: any `GenericMVSDataset`.
        batch_size: the global batch size (the last batch is partial
            unless `drop_last`).
        shuffle: reshuffle element order each epoch.
        num_workers: decode threads.
        prefetch: max ready batches queued ahead.
        seed: seeds the epochs' order and every item's state.
        shard: `(rank, world)`: yield only rows [rank * b / world,
            (rank + 1) * b / world) of each batch of b rows, b a multiple
            of `world`.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 8, prefetch: int = 4,
                 drop_last: bool = False, seed: int = 0,
                 adapter=None, shard=(0, 1)):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.seed = seed
        self.rng = np.random.RandomState(seed)
        self.epoch = 0
        self.adapter = adapter
        self.rank, self.world = shard
        if batch_size % self.world or not drop_last and self.world > 1:
            raise ValueError(
                f"batch_size {batch_size} must divide over {self.world} "
                "ranks, with drop_last")

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[Dict[str, Dict]]:
        indices = self._indices()
        epoch = self.epoch
        self.epoch += 1
        n_batches = len(self)
        rows = self.batch_size // self.world

        def item(index):
            return self.dataset.__getitem__(
                index, item_rng(self.seed, epoch, index))
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in range(n_batches):
                        if stop.is_set():
                            return
                        chunk = indices[b * self.batch_size:
                                        (b + 1) * self.batch_size][
                            self.rank * rows:(self.rank + 1) * rows]
                        elems = list(pool.map(item, chunk))
                        batch = collate(elems)
                        if self.adapter is not None:
                            batch = self.adapter(batch)
                        out_q.put(batch)
                out_q.put(None)
            except BaseException as e:  # raised again in the consumer
                out_q.put(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                batch = out_q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
