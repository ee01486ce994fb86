"""Threaded host data loader: shuffle, parallel sample fetch and collate
(JAX: data/loader.py).

A pool of threads reads each sample (h5py releases the GIL while it reads)
and does the sample's own share of the collate: padding, polarity packing
and the LUT-cell sort, with the native C++ ops, which release the GIL too
(`collate.prepare_sample`).  A producer thread keeps the next batch's
samples in the pool while it stacks the current one, optionally into
pinned host memory, and hands numpy batches to the consumer through a
bounded queue, so the host prepares batches while the card runs steps.
With capacity buckets a sample's share waits until its batch is read:
the batch's largest sample sets the capacity (`collate.bucket_capacities`).
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, Optional, Sequence

import numpy as np

from .collate import bucket_capacities, prepare_sample, stack_samples


def pinned_empty(shape, dtype) -> np.ndarray:
    """An uninitialized numpy array in pinned (page-locked) host memory,
    from which a copy to the card runs asynchronously."""
    import torch

    t = torch.empty(shape, dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
                    pin_memory=True)
    return t.numpy()


class DataLoader:
    """Epoch-based loader over an indexable dataset."""

    def __init__(self, dataset, batch_size: int, capacity: int,
                 shuffle: bool = True, num_workers: int = 8,
                 polarity_aware: bool = False,
                 pos_capacity: Optional[int] = None, drop_last: bool = True,
                 seed: int = 0, prefetch: int = 2,
                 collate_fn: Optional[Callable] = None,
                 lut_cell_sort_params: Optional[tuple] = None,
                 pin_memory: bool = False,
                 capacity_buckets: Optional[Sequence[int]] = None):
        """`collate_fn(samples) -> batch` replaces the fixed-capacity
        collate and then runs in the producer thread; `pin_memory` stacks
        the default collate's arrays into pinned host memory (for a card:
        training/loop.py::to_device then copies them asynchronously);
        `capacity_buckets` (ascending) pads each batch to the smallest
        bucket covering its largest sample instead of `capacity` (with
        polarity_aware, each half at half the bucket)."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.collate_fn = collate_fn
        self._collate_kw = dict(capacity=capacity,
                                polarity_aware=polarity_aware,
                                pos_capacity=pos_capacity,
                                lut_cell_sort_params=lut_cell_sort_params)
        self._alloc = pinned_empty if pin_memory else None
        self.capacity_buckets = (None if capacity_buckets is None
                                 else tuple(capacity_buckets))
        self._epoch = 0

    def _fetch(self, idx: int):
        """A pool task: the sample, prepared unless a collate_fn is given
        or the capacity waits for the batch (buckets)."""
        sample = self.dataset[idx]
        if self.collate_fn or self.capacity_buckets is not None:
            return sample
        return prepare_sample(sample, **self._collate_kw)

    def _stack(self, items, pool) -> Dict[str, np.ndarray]:
        if self.collate_fn:
            return self.collate_fn(items)
        if self.capacity_buckets is not None:
            kw = dict(self._collate_kw)
            if "events" in items[0] or "pos_events" in items[0]:
                kw["capacity"], kw["pos_capacity"] = bucket_capacities(
                    items, self.capacity_buckets, kw["polarity_aware"])
            items = list(pool.map(lambda s: prepare_sample(s, **kw), items))
        return stack_samples(items, self._alloc)

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        self._epoch += 1
        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    # The next batch's samples are in the pool while this
                    # one is stacked and queued.
                    pending = collections.deque()
                    for idxs in batches:
                        if stop.is_set():
                            return
                        pending.append([pool.submit(self._fetch, j)
                                        for j in idxs])
                        if len(pending) > 1:
                            out_q.put(self._stack(
                                [f.result() for f in pending.popleft()],
                                pool))
                    while pending and not stop.is_set():
                        out_q.put(self._stack(
                            [f.result() for f in pending.popleft()], pool))
                out_q.put(None)
            except BaseException as exc:      # re-raised by the consumer
                out_q.put(exc)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while thread.is_alive():
                try:
                    out_q.get(timeout=0.1)
                except queue.Empty:
                    pass
            thread.join()
