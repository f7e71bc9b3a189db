"""Tracing of the port: named spans at its layer boundaries, the training
loop's phase totals and the ``--profile_steps`` trace.

Spans are off by default, and ``span(name)`` then costs one test of a
module flag and returns a shared null context.  ``enable(True)`` turns
them on: a span opens ``torch.profiler.record_function(name)``, so under a
profiler it is a host row of the trace (and, around the kernels launched
inside it, a ``gpu_user_annotation`` row on the device's timeline), and on
exit it appends ``Record(name, parent, t0_ns, t1_ns, thread)`` to a
bounded ring, on ``time.perf_counter_ns``'s clock, the parent being the
span open around it on the same thread.  ``drain()`` returns the records,
the calls of each name and the records the full ring dropped, and resets
all three.

The spans the program opens (``NAMES``):

* ``entry.embed_queries`` / ``entry.embed_db`` (``infer.make_infer_fns``'
  closures), ``entry.train_step`` (``train.step.make_train_step``);
* ``mm.image`` / ``mm.voxel`` / ``mm.fusion``: the MM query tower's image
  branch (backbone, pooling, its l2n), voxel branch (the voxel backbone,
  pooling, its l2n) and the fusion after them (shallow or addorg, stage-2
  fusion, its head, the final sum);
* ``train.forward`` (both towers and both losses), ``train.backward`` (the
  gradients cleared, then ``loss.backward()``), ``train.optimizer``
  (``opt.step``);
* ``geoloc.tokenizer`` / ``geoloc.encoder`` (CCT's convs; its positional
  add, layers and final LayerNorm), ``geoloc.attn`` (one a CCT layer: the
  scores, their softmax and AV), ``geoloc.aggregation`` (a GeoLoc tower's
  head, with its L2 placements).
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch

NAMES = frozenset({
    "entry.embed_queries", "entry.embed_db", "entry.train_step",
    "mm.image", "mm.voxel", "mm.fusion",
    "train.forward", "train.backward", "train.optimizer",
    "geoloc.tokenizer", "geoloc.encoder", "geoloc.attn",
    "geoloc.aggregation"})
RING = 1 << 16  # records kept between two drains

_on = False
_NULL = contextlib.nullcontext()
_lock = threading.Lock()
_local = threading.local()
_ring: collections.deque = collections.deque(maxlen=RING)
_calls: Dict[str, int] = collections.Counter()
_dropped = 0


class Record(NamedTuple):
    name: str
    parent: Optional[str]
    t0_ns: int
    t1_ns: int
    thread: int


class Drained(NamedTuple):
    records: List[Record]
    calls: Dict[str, int]
    dropped: int


def enable(on: bool) -> None:
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def span(name: str):
    """A context that records ``name`` while spans are on; the shared
    null context while they are off."""
    if not _on:
        return _NULL
    return _Span(name)


class _Span:
    __slots__ = ("name", "parent", "fn", "t0")

    def __init__(self, name: str):
        if name not in NAMES:
            raise ValueError(f"span {name!r} is not in spans.NAMES")
        self.name = name

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.fn = torch.profiler.record_function(self.name)
        self.fn.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _dropped
        t1 = time.perf_counter_ns()
        self.fn.__exit__(*exc)
        _stack().pop()
        rec = Record(self.name, self.parent, self.t0, t1,
                     threading.get_ident())
        with _lock:
            if len(_ring) == RING:
                _dropped += 1
            _ring.append(rec)
            _calls[self.name] += 1
        return False


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def drain() -> Drained:
    """The records kept and the calls of each name since the last drain,
    and the records dropped; all three reset."""
    global _dropped
    with _lock:
        out = Drained(list(_ring), dict(_calls), _dropped)
        _ring.clear()
        _calls.clear()
        _dropped = 0
    return out


class PhaseTimer:
    """Wall-clock totals per phase: ``with timer('mining'): ...``, then
    ``.totals``.  Phases may nest."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self._stack: list = []

    def __call__(self, name: str):
        self._stack.append((name, None))
        return self

    def __enter__(self):
        name, _ = self._stack[-1]
        self._stack[-1] = (name, time.perf_counter())
        return self

    def __exit__(self, *exc):
        name, t0 = self._stack.pop()
        self.totals[name] = (self.totals.get(name, 0.0)
                             + time.perf_counter() - t0)
        return False


class ProfilerTrace:
    """A ``torch.profiler`` trace (CPU, and CUDA when the card is there)
    written as a Chrome trace to ``{logdir}/trace.json`` on ``stop``.
    Spans are on from the start to ``stop``, which restores the state it
    found."""

    def __init__(self, logdir: str):
        from torch.profiler import ProfilerActivity, profile

        self.logdir = logdir
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.was_on = enabled()
        enable(True)

    def stop(self) -> str:
        self.prof.__exit__(None, None, None)
        enable(self.was_on)
        os.makedirs(self.logdir, exist_ok=True)
        path = os.path.join(self.logdir, "trace.json")
        self.prof.export_chrome_trace(path)
        return path
