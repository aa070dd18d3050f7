"""Host->device input pipeline: threaded batch assembly with prefetch.

Replaces the reference's ``torch.utils.data.DataLoader(num_workers=8,
pin_memory=True, drop_last=True)`` (sem_seg_training.py:524-528)
with a thread-pool loader + a small prefetch queue. Block extraction is
NumPy gather work that releases the GIL, so threads (not processes) suffice
and avoid pickling the whole dataset into 8 workers. Device transfer is the
caller's job (jax.device_put happens inside the jit'd step), so the loader
yields pinned host numpy batches a step ahead of consumption.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Tuple

import numpy as np


class BatchLoader:
    """Iterable over [B, num_point, C] float32 / [B, num_point] int32 batches."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int = 8,
                 seed: Optional[int] = None, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self._seed = seed
        # Per-sample RNG base: with a user seed, block sampling is fully
        # deterministic regardless of worker thread scheduling (each sample
        # gets its own default_rng([base, epoch, idx]) stream); without one,
        # draw the base from OS entropy once.
        self._rng_base = (int(np.random.SeedSequence().entropy) % (2 ** 63)
                          if seed is None else int(seed))
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self) -> Iterator[np.ndarray]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(
                None if self._seed is None else self._seed + self._epoch)
            rng.shuffle(order)
        stop = (n - n % self.batch_size) if self.drop_last else n
        for s in range(0, stop, self.batch_size):
            yield order[s:s + self.batch_size]

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        self._epoch += 1
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        sample = getattr(self.dataset, "sample", None)
        epoch = self._epoch

        def fetch_one(i: int):
            if sample is not None:
                rng = np.random.default_rng([self._rng_base, epoch, int(i)])
                return sample(int(i), rng)
            return self.dataset[int(i)]

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for batch_idx in self._batches():
                        samples = list(pool.map(fetch_one, batch_idx))
                        feats = np.stack([s[0] for s in samples]).astype(np.float32)
                        labels = np.stack([s[1] for s in samples]).astype(np.int32)
                        out_q.put((feats, labels))
            except Exception as e:  # surface worker errors to the consumer
                out_q.put(e)
            finally:
                out_q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = out_q.get()
            if item is sentinel:
                break
            if isinstance(item, Exception):
                raise item
            yield item
