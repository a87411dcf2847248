"""Input pipeline: batching, shuffling, threaded loading and the copy to
the device.

Port of the JAX package's ``data/pipeline.py:27-171``:

- map-style datasets (``__len__``/``__getitem__`` -> dict of numpy arrays);
- epoch-seeded shuffling (the reference's ``sampler.set_epoch``);
- per-rank sharding (``host_local_slice``, the reference's
  DistributedSampler): the global order is seeded by (seed, epoch) alike
  on every rank, and each rank of a process group
  (``parallel/distributed.py``) takes its contiguous slice, as each JAX
  process takes its ``jax.process_index()``'s; ``len()`` and the batches
  are the rank's;
- worker threads that overlap the numpy sample work with device compute;
- ``device_prefetch``: a background thread copies pinned host batches to
  the card with ``non_blocking=True``, ``depth`` batches ahead.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Sequence

import numpy as np
import torch

from ..parallel import distributed

def default_collate(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray) or np.isscalar(vals[0]):
            out[key] = np.stack([np.asarray(v) for v in vals])
        else:
            out[key] = vals  # e.g. paths
    return out


def host_local_slice(global_indices: np.ndarray, rank: int = 0, world: int = 1) -> np.ndarray:
    """Rank ``rank``'s contiguous slice of the global index order, ``len //
    world`` indices (the JAX package's ``host_local_slice`` with
    ``jax.process_index()`` / ``process_count()``; the last ``len % world``
    are left out, as there)."""
    if world == 1:
        return global_indices
    per = len(global_indices) // world
    return global_indices[rank * per:(rank + 1) * per]


class DataLoader:
    """Minimal map-style loader with shuffle, per-rank slices and worker
    threads.  The rank and the number of ranks are the process group's
    (``parallel/distributed.py``; one process without one), read when the
    loader is iterated or measured, as JAX's reads its process index."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, drop_last: bool = True,
                 num_workers: int = 4, collate_fn: Callable = default_collate, seed: int = 0):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(0, int(num_workers))
        self.collate = collate_fn
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def __len__(self) -> int:
        n = len(self.dataset) // distributed.data_size()
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _index_order(self) -> np.ndarray:
        """The epoch-seeded global order, then this rank's slice: its data
        rank's, so the model ranks of one data row read the same rows."""
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(idx)
        return host_local_slice(idx, distributed.data_rank(), distributed.data_size())

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = self._index_order()
        n_batches = len(self)
        batches = [idx[i * self.batch_size:(i + 1) * self.batch_size] for i in range(n_batches)]

        def load(b):
            return self.collate([self.dataset[int(i)] for i in b])

        if self.num_workers == 0:
            for b in batches:
                yield load(b)
            return

        # pipeline batches through a thread pool, preserving order
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            depth = self.num_workers + 1
            futures = [pool.submit(load, b) for b in batches[:depth]]
            for i in range(n_batches):
                batch = futures[i].result()
                if depth + i < n_batches:
                    futures.append(pool.submit(load, batches[depth + i]))
                yield batch


def to_device(batch: Dict, device) -> Dict:
    """numpy arrays -> tensors on ``device`` (pinned and copied with
    ``non_blocking=True`` to a card); other values pass through."""
    device = torch.device(device)
    out = {}
    for key, val in batch.items():
        if isinstance(val, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(val))
            if device.type == "cuda":
                t = t.pin_memory()
            out[key] = t.to(device, non_blocking=True)
        else:
            out[key] = val
    return out


def device_prefetch(iterator: Iterator, device="cuda", depth: int = 2) -> Iterator:
    """Yield the batches of ``iterator`` on ``device``, copied by a
    background thread up to ``depth`` batches ahead.  The copies go on the
    card's current stream, so the steps that read them are ordered after
    them.  An exception in the thread is raised in the consumer; closing
    the generator stops the thread."""
    buf: "queue.Queue" = queue.Queue(maxsize=max(1, int(depth)))
    done = object()
    stop = threading.Event()
    failure: list = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                buf.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in iterator:
                if not put(to_device(item, device)):
                    return
        except Exception as e:  # surface it in the consumer, do not truncate
            failure.append(e)
        finally:
            put(done)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = buf.get()
            if item is done:
                if failure:
                    raise failure[0]
                return
            yield item
    finally:
        stop.set()
        thread.join(timeout=10)
