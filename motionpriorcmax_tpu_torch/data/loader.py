"""Threaded host data loader: shuffle, parallel sample fetch and the
fixed-capacity collate (JAX: data/loader.py).

A producer thread fetches each batch's samples with a thread pool (h5py
releases the GIL while it reads) and collates them; the consumer takes
numpy batches from a bounded queue, so the host prepares the next batch
while the card runs the current step.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, Optional

import numpy as np

from .collate import collate_fixed_capacity


class DataLoader:
    """Epoch-based loader over an indexable dataset."""

    def __init__(self, dataset, batch_size: int, capacity: int,
                 shuffle: bool = True, num_workers: int = 8,
                 polarity_aware: bool = False,
                 pos_capacity: Optional[int] = None, drop_last: bool = True,
                 seed: int = 0, prefetch: int = 2,
                 collate_fn: Optional[Callable] = None,
                 lut_cell_sort_params: Optional[tuple] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.collate_fn = collate_fn or (
            lambda samples: collate_fixed_capacity(
                samples, capacity, polarity_aware, pos_capacity,
                lut_cell_sort_params=lut_cell_sort_params))
        self._epoch = 0

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
                    for idxs in batches:
                        if stop.is_set():
                            return
                        samples = list(pool.map(self.dataset.__getitem__,
                                                idxs))
                        out_q.put(self.collate_fn(samples))
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
