"""The measured window: a closed loop that keeps ``depth`` units of work in
flight, timed by the host's clock.

``dispatch(i)`` enqueues unit i on the card and returns an object with
``done()`` (blocks until the unit is complete on the host's side, e.g. a
CUDA event after its result's copy to the host).  A unit's latency runs
from the host's start of its dispatch to the moment its completion is seen;
the window runs from the first dispatch to the last completion, and every
unit dispatched before the deadline is completed and counted.
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Callable, List


@dataclass
class Unit:
    index: int
    start: float  # host clock, s
    done: float = 0.0
    payload: object = None


@dataclass
class Window:
    units: List[Unit] = field(default_factory=list)
    start: float = 0.0
    end: float = 0.0

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def latencies_s(self) -> List[float]:
        return [u.done - u.start for u in self.units]


def closed_loop(dispatch: Callable[[int], object], depth: int,
                seconds: float, first_index: int = 0,
                max_units: int = 0, min_units: int = 0) -> Window:
    """Run units back to back for ``seconds`` and at least ``min_units``
    units (or ``max_units`` units when given), ``depth`` in flight."""
    inflight = collections.deque()
    w = Window()
    clock = time.perf_counter
    i = first_index
    w.start = clock()

    def retire():
        unit, handle = inflight.popleft()
        unit.payload = handle.done()
        unit.done = clock()
        w.units.append(unit)

    while (clock() - w.start < seconds or i - first_index < min_units
           if not max_units else i - first_index < max_units):
        s = clock()
        handle = dispatch(i)
        inflight.append((Unit(i, s), handle))
        i += 1
        if len(inflight) >= depth:
            retire()
    while inflight:
        retire()
    w.end = w.units[-1].done if w.units else w.start
    return w


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between order
    statistics (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
