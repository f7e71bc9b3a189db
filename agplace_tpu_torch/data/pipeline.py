"""Host-side input pipeline (``agplace_tpu/data/pipeline.py``).

``Prefetcher`` collates batches in worker threads, in order, while the card
runs the previous steps (the collate work is numpy and the native
voxelizer, which releases the GIL).  ``prefetch_to_device`` keeps two
batches in flight to the card: pinned host tensors copied ``non_blocking``
on a side stream; with a ``sharding`` (``parallel.mesh.batch_sharding``)
only this rank's block of the batch is copied.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
from typing import Callable, Iterable, Iterator, Sequence

import numpy as np
import torch

from agplace_tpu_torch.device import resolve_device


class Prefetcher:
    """Iterate ``make_batch(item)`` over ``items`` with ``num_workers``
    threads, preserving order, keeping at most ``buffer_size`` ready
    batches.  ``make_batch`` must be thread-safe.  An exception in a
    worker is raised to the consumer at its item."""

    def __init__(self, items: Sequence, make_batch: Callable,
                 num_workers: int = 4, buffer_size: int = 4):
        self.items = list(items)
        self.make_batch = make_batch
        self.num_workers = max(1, num_workers)
        self.buffer_size = max(1, buffer_size)

    def __len__(self) -> int:
        return len(self.items)

    def __iter__(self) -> Iterator:
        if self.num_workers == 1:
            for it in self.items:
                yield self.make_batch(it)
            return

        results: dict = {}
        cond = threading.Condition()
        task_q: "queue.Queue" = queue.Queue()
        for idx, it in enumerate(self.items):
            task_q.put((idx, it))
        stop = threading.Event()
        consumed = [0]  # the index the consumer waits for next

        def worker():
            while not stop.is_set():
                try:
                    idx, it = task_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    batch, err = self.make_batch(it), None
                except Exception as e:  # raised to the consumer in order
                    batch, err = None, e
                with cond:
                    # bounded buffer: wait until the consumer catches up
                    while (not stop.is_set()
                           and idx - consumed[0] > self.buffer_size):
                        cond.wait(timeout=0.1)
                    results[idx] = (batch, err)
                    cond.notify_all()

        workers = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for w in workers:
            w.start()
        try:
            for i in range(len(self.items)):
                with cond:
                    while i not in results:
                        cond.wait(timeout=0.1)
                    batch, err = results.pop(i)
                    consumed[0] = i + 1
                    cond.notify_all()
                if err is not None:
                    raise err
                yield batch
        finally:
            stop.set()
            with cond:
                cond.notify_all()
            for w in workers:
                w.join(timeout=2.0)


def map_tensors(batch, fn):
    """``fn`` over every array of a batch (dicts, dataclasses such as
    ``BEVGrid``, numpy arrays turned into tensors, tensors)."""
    if isinstance(batch, dict):
        return {k: map_tensors(v, fn) for k, v in batch.items()}
    if dataclasses.is_dataclass(batch):
        return dataclasses.replace(batch, **{
            f.name: map_tensors(getattr(batch, f.name), fn)
            for f in dataclasses.fields(batch)})
    if isinstance(batch, np.ndarray):
        return fn(torch.from_numpy(np.ascontiguousarray(batch)))
    if isinstance(batch, torch.Tensor):
        return fn(batch)
    return batch


def _tensors(batch):
    out = []
    map_tensors(batch, lambda t: out.append(t) or t)
    return out


def prefetch_to_device(iterator: Iterable, device, depth: int = 2,
                       sharding=None) -> Iterator:
    """Yield the batches of ``iterator`` on ``device``, ``depth`` of them in
    flight ahead of the consumer.  On the card each batch is pinned and
    copied ``non_blocking`` on a side stream; the consumer's stream waits
    for that copy's event before it gets the batch, and each tensor is
    recorded on the consumer's stream so its memory is not reused while
    that stream may still read it.  ``sharding``
    (``parallel.mesh.batch_sharding``, any callable on a host batch): each
    host batch is cut to this rank's part on the host, before the copy."""
    device = resolve_device(device)
    if sharding is not None:
        iterator = map(sharding, iterator)
    if device.type != "cuda":
        for batch in iterator:
            yield map_tensors(batch, lambda t: t.to(device))
        return
    side = torch.cuda.Stream(device)
    buf: collections.deque = collections.deque()

    def ready(entry):
        batch, done = entry
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        for t in _tensors(batch):
            t.record_stream(consumer)
        return batch

    for batch in iterator:
        host = map_tensors(batch, lambda t: t.pin_memory())
        # the copies' destinations come from the side stream's own pool,
        # so the side stream need not wait for the consumer's queued work
        with torch.cuda.stream(side):
            dev = map_tensors(host, lambda t: t.to(device,
                                                   non_blocking=True))
            done = torch.cuda.Event()
            done.record(side)
        buf.append((dev, done))
        if len(buf) >= depth:
            yield ready(buf.popleft())
    while buf:
        yield ready(buf.popleft())
