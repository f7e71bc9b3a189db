"""Device traces of short steady sub-windows, and the check that a trace is
whole.

The profiler on the card drops device events now and then (a profile of 50
calls has shown 21, 45 or 50 of them, and some record nothing), so no
metric trusts one profile blindly.  A trace counts only when the kernels
that the program's own counters vouch for are all in it: each expected
(kernel-name pattern, count) pair must match exactly.  The harness
profiles sub-windows until one passes, and reports the device metrics as
unreadable when none does.

The name table (``HAND``, ``CLASSES``) is a frozen copy of
``scripts/profile_torch_mm.py``'s.
"""

from __future__ import annotations

import re
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

HAND = re.compile(r"(conv3x3_sm90_kernel<[^>]*>|conv_igemm_kernel<[^>]*>"
                  r"|ode_euler_kernel|ode_grid_kernel|ode_wide_kernel"
                  r"|head_sm90_kernel|head_conv0_sm90_kernel"
                  r"|zband_sm90_kernel<[^>]*>|down0_sm90_kernel"
                  r"|stem_pool_kernel|eca_kernel|combine_id_kernel"
                  r"|combine_kernel|p1_sm90_kernel<[^>]*>"
                  r"|down_concat_(?:sm90_)?kernel)")
CLASSES = (
    ("max-pools", ("max_pool",)),
    ("cuDNN / cuBLAS convs and GEMMs", ("cudnn", "xmma", "cutlass", "gemm",
                                        "conv", "sm90_", "implicit")),
    ("sorts / scatters / gathers", ("sort", "scatter", "gather",
                                    "indexselect", "index_select", "radix",
                                    "cub::")),
    ("elementwise / copies", ("elementwise", "copy", "memcpy", "memset",
                              "fill", "cat", "index")),
    ("reductions", ("reduce",)),
)
# the hand kernels by the K-number of the TPU kernel they port (the
# z-banded GEMM serves K2-K4 off their preset widths and is its own class)
K_OF = (("K1", re.compile(r"ode_(euler|grid|wide)_kernel")),
        ("K2", re.compile(r"down0_sm90_kernel")),
        ("K3", re.compile(r"conv3x3_sm90_kernel|eca_kernel|combine_id_kernel"
                          r"|combine_kernel|conv_igemm_kernel<2")),
        ("K4", re.compile(r"head_sm90_kernel|head_conv0_sm90_kernel")),
        ("K5", re.compile(r"stem_pool_kernel")),
        ("zband", re.compile(r"zband_sm90_kernel")))
# every kernel a hand wrapper launches, by name, and how many of each one
# call launches on each instance its shape rule picks (``ops.launches()``,
# ``ops.instance_launches()``; "*" is any instance): the profile must hold
# exactly the counters' sum of each.  A wrapper or instance not listed
# here cannot be vouched for, and no profile of it is whole.
KERNEL = {"ode": r"ode_(euler|grid|wide)_kernel",
          "down0": r"down0_sm90_kernel",
          "zband": r"zband_sm90_kernel",
          "conv3x3": r"conv3x3_sm90_kernel",
          "eca": r"eca_kernel",
          "combine": r"combine_id_kernel|conv_igemm_kernel<2,",
          "head": r"head_sm90_kernel",
          "head_conv0": r"head_conv0_sm90_kernel",
          "stem": r"stem_pool_kernel"}
PER_CALL = {
    "fused_euler_ode": {"*": {"ode": 1}},
    "fused_conv0_down0": {"sm90": {"down0": 1}, "zband": {"zband": 1}},
    "fused_eca_block_sm": {"sm90": {"conv3x3": 2, "eca": 1, "combine": 1},
                           "zband": {"zband": 2, "eca": 1, "combine": 1},
                           "zband+sm90": {"zband": 1, "conv3x3": 1,
                                          "eca": 1, "combine": 1}},
    "fused_head": {"resident": {"head": 1}, "streamed": {"head": 1},
                   "window+zband": {"head_conv0": 1, "zband": 1}},
    "fused_affine_relu_maxpool": {"*": {"stem": 1}}}
MARK = "portbench.subwindow"
SETTLE_S = 0.05


def classify(name: str) -> str:
    own = HAND.search(name)
    if own:
        return own.group(1)
    low = name.lower()
    for label, keys in CLASSES:
        if any(k in low for k in keys):
            return label
    return "other"


def k_of(name: str) -> Optional[str]:
    for k, pat in K_OF:
        if pat.search(name):
            return k
    return None


@dataclass
class Trace:
    """Device operations and host ops of one profiled sub-window, in
    microseconds on the profiler's clock."""
    device: List[Tuple[str, float, float]] = field(default_factory=list)
    host: List[Tuple[str, float, float]] = field(default_factory=list)
    window: Tuple[float, float] = (0.0, 0.0)
    units: int = 0

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def count(self, pattern: str) -> int:
        pat = re.compile(pattern)
        return sum(1 for n, _, _ in self.device if pat.search(n))

    def device_s(self, pattern: Optional[str] = None) -> float:
        pat = re.compile(pattern) if pattern else None
        return sum(e - s for n, s, e in self.device
                   if pat is None or pat.search(n)) / 1e6

    def seconds_by(self, key) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for n, s, e in self.device:
            k = key(n)
            if k is not None:
                out[k] += (e - s) / 1e6
        return dict(out)

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of device operations, clipped to the window."""
        lo, hi = self.window
        spans = sorted((max(s, lo), min(e, hi)) for _, s, e in self.device
                       if e > lo and s < hi)
        merged: List[List[float]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def idle_gaps(self) -> List[Tuple[float, float]]:
        lo, hi = self.window
        gaps, at = [], lo
        for s, e in self.busy_intervals():
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if hi > at:
            gaps.append((at, hi))
        return gaps

    def host_op_at(self, t: float) -> str:
        """The innermost host op running at ``t`` (the marker excluded)."""
        best = None
        for n, s, e in self.host:
            if s <= t <= e and n != MARK and not n.startswith(
                    "Activity Buffer"):  # the profiler's own
                if best is None or e - s < best[1]:
                    best = (n, e - s)
        return best[0] if best else "none"


def whole(trace: Trace,
          expected: Optional[Sequence[Tuple[str, int]]]) -> bool:
    """A trace is whole when it holds device work and every expected
    (pattern, count) matches exactly; None (launches nothing vouches
    for) is never whole."""
    return (expected is not None and bool(trace.device)
            and all(trace.count(p) == n for p, n in expected))


def hand_counters() -> Dict[str, int]:
    """The hand wrappers' launch counters, and each instance's under
    ``<wrapper>/<instance>``."""
    from agplace_tpu_torch import ops

    out = dict(ops.launches())
    for k, inst in ops.instance_launches().items():
        out.update({f"{k}/{i}": n for i, n in inst.items()})
    return out


def expected_from_launches(delta: Dict[str, int]
                           ) -> Optional[List[Tuple[str, int]]]:
    """The expected count of every hand kernel in a sub-window, from the
    deltas of ``hand_counters()`` over it; None where a wrapper or an
    instance launched that ``PER_CALL`` does not list."""
    need: Dict[str, int] = defaultdict(int)
    for wrapper, n in delta.items():
        if "/" in wrapper or not n:
            continue
        table = PER_CALL.get(wrapper)
        if table is None:
            return None
        calls = ({"*": n} if "*" in table else
                 {i: delta.get(f"{wrapper}/{i}", 0) for i in table})
        if sum(calls.values()) != n:  # an instance the table lacks
            return None
        for inst, c in calls.items():
            for kernel, per in table[inst].items():
                need[kernel] += per * c
    return [(KERNEL[k], n) for k, n in sorted(need.items())]


def record(run_units, units: int):
    """Profile ``run_units(units)`` (which ends synchronised) on the host
    and the device, inside the marker span; returns the Trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(MARK):
            run_units(units)
        time.sleep(SETTLE_S)
    t = Trace(units=units)
    for e in prof.events():
        span = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            if e.name != MARK:  # the marker's own span on the device's row
                t.device.append(span)
        else:
            t.host.append(span)
            if e.name == MARK:
                t.window = span[1:]
    return steady(t)


def steady(t: Trace) -> Trace:
    """Start the trace's window where the closed loop first waits for a
    unit (the end of its first ``cudaEventSynchronize``): from there the
    next unit is in flight behind the one running, as all through the
    measured window; before it the first unit ran with nothing queued
    behind it."""
    lo, hi = t.window
    waits = [e for n, s, e in t.host
             if n == "cudaEventSynchronize" and lo <= s and e <= hi]
    if waits:
        t.window = (min(waits), hi)
    return t


def breakdown(trace: Trace) -> dict:
    """The ten device classes that took most time, and the ten longest
    idle gaps by the host op running then, in seconds."""
    ops = trace.seconds_by(classify)
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(trace.idle_gaps(), key=lambda g: g[0] - g[1])[:10]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[trace.host_op_at((s + e) / 2), (e - s) / 1e6]
                          for s, e in gaps]}


def first_whole(run_units, units: int, counters, expect, tries: int):
    """Profile sub-windows of ``units`` units until one is whole.
    ``counters()`` reads the program's counters (a dict of ints) before and
    after each profile; ``expect(delta)`` turns their delta into the
    expected (pattern, count) pairs.  Returns (the whole trace or None, the
    device events each try recorded)."""
    seen = []
    for _ in range(tries):
        before = counters()
        trace = record(run_units, units)
        after = counters()
        delta = {k: after[k] - before.get(k, 0) for k in after}
        seen.append(len(trace.device))
        if whole(trace, expect(delta)):
            return trace, seen
    return None, seen
