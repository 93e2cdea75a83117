"""Batching with background prefetch (counterpart of the JAX package's
``data/loader.py``; reference Train_Geo.py:48-51).

Yields collated numpy batches in order; the caller moves them to its
device. Three backends: synchronous (``num_workers=0``), a thread pool
(the sample pipeline's heavy parts, numpy and the ctypes host ops, release
the GIL) and a persistent spawn process pool for datasets whose
``__getitem__`` holds the GIL.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Iterator

import numpy as np

from . import collate

_WORKER_DATASET = None


def _init_worker(dataset) -> None:
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _worker_collate(args) -> Dict[str, np.ndarray]:
    # the pool pickles the dataset once, at its start, so the epoch rides
    # along with every task: a set_epoch in the parent never reaches the
    # workers' copies
    epoch, idxs = args
    if hasattr(_WORKER_DATASET, "set_epoch"):
        _WORKER_DATASET.set_epoch(int(epoch))
    return collate([_WORKER_DATASET[int(i)] for i in idxs])


class DataLoader:
    """Iterable over collated batches with background prefetch.

    ``num_workers`` threads (or, with ``use_processes``, spawn processes)
    share the batch stream; batches come out in order and at most
    ``prefetch`` finished ones wait ahead of the consumer. ``shuffle``
    draws each epoch's order from ``(seed, epoch)``; ``set_epoch`` also
    reaches the dataset (and, with processes, the workers' copies).
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = True, num_workers: int = 2,
                 seed: int = 0, prefetch: int = 4,
                 use_processes: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.seed = seed
        self.prefetch = max(1, prefetch)
        self.use_processes = use_processes
        self._epoch = 0
        self._pool = None

    def _process_pool(self):
        if self._pool is None:
            import multiprocessing as mp
            ctx = mp.get_context("spawn")   # never fork a CUDA process
            self._pool = ctx.Pool(self.num_workers, initializer=_init_worker,
                                  initargs=(self.dataset,))
        return self._pool

    def close(self) -> None:
        if self._pool is not None:
            self._pool.terminate()
            self._pool = None

    def __del__(self):
        self.close()

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def _index_batches(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng(
                (self.seed, self._epoch)).permutation(n)
        stop = (n // self.batch_size * self.batch_size
                if self.drop_last else n)
        for s in range(0, stop, self.batch_size):
            yield order[s:s + self.batch_size]

    def _iter_processes(self) -> Iterator[Dict[str, np.ndarray]]:
        pool = self._process_pool()
        batches = [np.asarray(i, dtype=np.int64)
                   for i in self._index_batches()]
        # at most `window` tasks in flight: finished batches never pile up
        # faster than the consumer takes them
        window = max(self.prefetch, self.num_workers)
        pending: deque = deque()
        submitted = min(window, len(batches))
        for i in range(submitted):
            pending.append(pool.apply_async(
                _worker_collate, ((self._epoch, batches[i]),)))
        while pending:
            out = pending.popleft().get()
            if submitted < len(batches):
                pending.append(pool.apply_async(
                    _worker_collate, ((self._epoch, batches[submitted]),)))
                submitted += 1
            yield out

    def _iter_threads(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = list(self._index_batches())
        n = len(batches)
        cond = threading.Condition()
        results: Dict[int, Dict[str, np.ndarray]] = {}
        state = {"next_in": 0, "next_out": 0, "stop": None}

        def worker():
            while True:
                with cond:
                    i = state["next_in"]
                    if i >= n or state["stop"] is not None:
                        return
                    state["next_in"] = i + 1
                try:
                    out = collate([self.dataset[int(j)]
                                   for j in batches[i]])
                except BaseException as e:   # re-raised in the consumer
                    with cond:
                        state["stop"] = e
                        cond.notify_all()
                    return
                with cond:
                    # hold at most `prefetch` batches ahead of the consumer;
                    # the worker of `next_out` never waits, so no deadlock
                    while (i - state["next_out"] >= self.prefetch
                           and state["stop"] is None):
                        cond.wait()
                    results[i] = out
                    cond.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(max(1, min(self.num_workers, n)))]
        for t in threads:
            t.start()
        try:
            for i in range(n):
                with cond:
                    while i not in results and state["stop"] is None:
                        cond.wait()
                    if state["stop"] is not None:
                        raise state["stop"]
                    out = results.pop(i)
                    state["next_out"] = i + 1
                    cond.notify_all()
                yield out
        finally:
            with cond:   # release the workers if the consumer stopped early
                if state["stop"] is None and state["next_out"] < n:
                    state["stop"] = GeneratorExit()
                cond.notify_all()

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.num_workers <= 0:
            for idxs in self._index_batches():
                yield collate([self.dataset[int(i)] for i in idxs])
            return
        if self.use_processes:
            yield from self._iter_processes()
        else:
            yield from self._iter_threads()
