"""Host-side data loader with threaded prefetch (the port's copy of
``ocrs_models_tpu/data/loader.py``).

Worker threads (numpy releases the interpreter lock for the heavy parts)
fetch samples ahead of the training loop and assemble collated batches into
a bounded queue. The shuffle order of epoch ``e`` is
``default_rng(seed + e)``, and the index space is sliced
``process_index::process_count`` so that each process of a multi-process
run reads a disjoint subset. Every process then runs the same number of
steps, whatever the subsets' sizes (a collective step of one rank with no
partner would hang them all): without ``drop_last`` a process that runs
out of samples gets batches of padding rows (``collate_fn`` of one sample,
its ``sample_weight`` set to 0 and any ``n_valid`` to 0), with
``drop_last`` every process stops where the shortest one does.
:func:`device_prefetch` then copies batches to the device from pinned host
memory, ahead of the step that uses them.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Sequence

import numpy as np
import torch


class DataLoader:
    def __init__(
        self,
        dataset: Sequence,
        batch_size: int,
        collate_fn: Callable[[list], dict],
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = False,
        num_threads: int = 2,
        prefetch: int = 2,
        process_index: int = 0,
        process_count: int = 1,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_threads = max(1, num_threads)
        self.prefetch = prefetch
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0

    def _batch_indices(self) -> list[np.ndarray]:
        """This process's batches of sample indices; an empty array stands
        for a batch of padding rows."""
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        order = order[self.process_index :: self.process_count]
        batches = [order[i : i + self.batch_size] for i in range(0, len(order), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        if self.process_count > 1:
            n, procs, b = len(self.dataset), self.process_count, self.batch_size
            most, fewest = -(-n // procs), n // procs  # samples of the first and last process
            steps = fewest // b if self.drop_last else -(-most // b)
            empty = np.zeros((0,), order.dtype)
            batches = batches[:steps] + [empty] * (steps - len(batches))
        return batches

    def _collate(self, pool, idx_batch: np.ndarray) -> dict:
        if len(idx_batch):
            return self.collate_fn(list(pool.map(lambda i: self.dataset[int(i)], idx_batch)))
        batch = self.collate_fn([self.dataset[0]])
        batch["sample_weight"] = np.zeros_like(batch["sample_weight"])
        if "n_valid" in batch:
            batch["n_valid"] = 0
        return batch

    def __len__(self) -> int:
        return len(self._batch_indices())

    def __iter__(self) -> Iterator[dict]:
        batches = self._batch_indices()
        self.epoch += 1
        if not batches:
            return iter(())

        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            # Never block forever on a full queue: a consumer that stops
            # early (an exception mid-epoch, a partial iteration) sets
            # `stop` from its finally, and the producer must see it to exit.
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_threads) as pool:
                    for idx_batch in batches:
                        if stop.is_set():
                            return
                        if not put_or_stop(self._collate(pool, idx_batch)):
                            return
                put_or_stop(None)
            except Exception as e:  # surface worker errors to the consumer
                put_or_stop(e)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()

        def gen():
            try:
                while True:
                    item = out_q.get()
                    if item is None:
                        return
                    if isinstance(item, Exception):
                        raise item
                    yield item
            finally:
                stop.set()

        return gen()


def to_device(batch: dict, device: torch.device) -> dict:
    """The batch's numpy arrays as tensors on ``device``. For a CUDA device the
    host side is pinned and the copies are ``non_blocking`` on the current
    stream, so they overlap the work queued before them."""
    out = {}
    for key, value in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(value))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[key] = t
    return out


def device_prefetch(iterator: Iterator[dict], device: torch.device, depth: int = 2):
    """Yield ``(host_batch, device_batch)`` with up to ``depth`` batches
    already on their way to ``device``; the host batch stays available for
    host-side metrics (decoding, CER)."""
    buf: list = []
    for batch in iterator:
        buf.append((batch, to_device(batch, device)))
        if len(buf) >= depth:
            yield buf.pop(0)
    while buf:
        yield buf.pop(0)
