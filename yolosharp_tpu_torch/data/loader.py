"""Prefetching data loader and the host-to-device prefetch (a copy of
yolosharp_tpu/data/loader.py:21-140).

Parity target: Data/YoloDataLoader.cs:6-45 (multi-worker shuffle loader
with custom collate). Batches are padded fixed-shape numpy dicts assembled
in a background thread from a thread pool of sample transforms, so host
augmentation overlaps the device's work; where the dataset renders its
batches on the device (``use_device_augment``) the thread plans whole
batches instead (``device_batch``: labels, a uint8 source pool and the
plan arrays), which ``device_prefetch`` + ``to_device`` copy to the card
pinned, one batch ahead, as any other batch.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np
import torch


PREFETCH = 2        # batches made ahead of the consumer, by each stage


def device_prefetch(iterable, put_fn):
    """Run `put_fn` (the host-to-device copy) on each item in a thread of
    its own, PREFETCH items ahead of the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
    stop = threading.Event()

    def transfer():
        try:
            for item in iterable:
                if stop.is_set():
                    break
                q.put(put_fn(item))
        except Exception as exc:  # surface to consumer
            q.put(exc)
        finally:
            q.put(None)

    t = threading.Thread(target=transfer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on `device`: on CUDA through pinned memory
    with non-blocking copies on the current stream."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t
    return out


class DataLoader:
    """Batches of `dataset` in a shuffled (seed 0, as the JAX loader) or
    fixed order; the last batch is padded with repeats of its own rows.

    With `world` > 1 (data-parallel ranks) the loader of rank r makes rows
    [r B / world, (r + 1) B / world) of each global batch of B =
    batch_size rows: the permutation is the same on every rank, so the
    ranks' rows together are the single-device loader's batch. Planned
    mosaic batches take their partners inside the rank's rows
    (``partner_group`` = B / world)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 workers: int = 4, max_labels: Optional[int] = None,
                 rank: int = 0, world: int = 1):
        if batch_size % world:
            raise ValueError(f"batch_size={batch_size} does not split over "
                             f"{world} ranks")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.workers = max(1, workers)
        self.rng = np.random.default_rng(0)
        self._max_labels = max_labels
        self.rank, self.world = rank, world
        self.partner_group = batch_size // world if world > 1 else 0

    @property
    def max_labels(self) -> int:
        return self._max_labels or self.dataset.max_label_count

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def _batches(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            self.rng.shuffle(order)
        for start in range(0, n, self.batch_size):
            idx = order[start:start + self.batch_size]
            if len(idx) < self.batch_size:
                # pad the final batch by repeating its own rows: keeps the
                # batch shape fixed and the rectangle-shape groups intact
                pad = self.batch_size - len(idx)
                idx = np.concatenate([idx, np.resize(idx, pad)])
            per = self.batch_size // self.world
            yield idx[self.rank * per:(self.rank + 1) * per]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        ml = self.max_labels
        q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()

        def produce():
            try:
                with ThreadPoolExecutor(self.workers) as pool:
                    for idx in self._batches():
                        if stop.is_set():
                            break
                        if self.dataset.use_device_augment():
                            # the host plans, the device renders
                            q.put(self.dataset.device_batch(
                                idx, ml, self.partner_group))
                        else:
                            recs = list(pool.map(self.dataset.get, idx))
                            q.put(self.dataset.collate(recs, ml))
            except Exception as exc:  # surface worker errors to consumer
                q.put(exc)
            finally:
                q.put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
