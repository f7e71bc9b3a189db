"""Logging and observability (``agplace_tpu/utils/common.py``): the log
sinks, a JSONL metrics stream, phase timers, the parameter count, the
per-experiment results files, and a ``torch.profiler`` trace of the first
steps of a run.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import sys
import time
import traceback
from typing import Any, Dict

import numpy as np
import torch


def setup_logging(save_dir: str, console_level: str = "INFO") -> None:
    """Root logger -> {save_dir}/info.log + debug.log + console, with
    uncaught exceptions written to the log."""
    os.makedirs(save_dir, exist_ok=True)
    fmt = logging.Formatter("%(asctime)s   %(message)s", "%Y-%m-%d %H:%M:%S")
    logger = logging.getLogger()
    logger.handlers = []
    logger.setLevel(logging.DEBUG)
    for name, level in (("info.log", logging.INFO),
                        ("debug.log", logging.DEBUG)):
        h = logging.FileHandler(os.path.join(save_dir, name))
        h.setLevel(level)
        h.setFormatter(fmt)
        logger.addHandler(h)
    console = logging.StreamHandler()
    console.setLevel(getattr(logging, console_level))
    console.setFormatter(fmt)
    logger.addHandler(console)

    def exception_handler(type_, value, tb):
        logger.info("\n" + "".join(traceback.format_exception(type_, value,
                                                              tb)))
    sys.excepthook = exception_handler


def _json_default(o):
    if isinstance(o, (np.floating, np.integer)):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, torch.Tensor):
        return o.detach().cpu().tolist()
    return str(o)


class MetricsWriter:
    """One JSON object per line, append-only."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path

    def write(self, record: Dict[str, Any]) -> None:
        record = dict(record)
        record.setdefault("ts", time.time())
        with open(self.path, "a") as f:
            f.write(json.dumps(record, default=_json_default) + "\n")


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


def count_params(named) -> int:
    """Elements of every parameter of ``named`` ((name, tensor) pairs)."""
    return sum(p.numel() for _, p in named)


class ProfilerTrace:
    """A ``torch.profiler`` trace (CPU, and CUDA when the card is there)
    written as a Chrome trace to ``{logdir}/trace.json`` on ``stop``."""

    def __init__(self, logdir: str):
        from torch.profiler import ProfilerActivity, profile

        self.logdir = logdir
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()

    def stop(self) -> str:
        self.prof.__exit__(None, None, None)
        os.makedirs(self.logdir, exist_ok=True)
        path = os.path.join(self.logdir, "trace.json")
        self.prof.export_chrome_trace(path)
        return path


class ResultsLogger:
    """Per-experiment ``results/{exp_name}.txt`` plus a global
    ``results.txt`` beside the results directory, each opened with a
    timestamp header and closed with a timestamp footer."""

    def __init__(self, exp_name: str, results_dir: str = "results"):
        self.exp_name = exp_name
        os.makedirs(results_dir, exist_ok=True)
        self.exp_path = os.path.join(results_dir, f"{exp_name}.txt")
        self.global_path = os.path.join(
            os.path.dirname(results_dir) or ".", "results.txt")
        for path, mode in ((self.exp_path, "w"), (self.global_path, "a")):
            with open(path, mode) as f:
                f.write(f"{self._stamp()}\n{exp_name}\n")

    @staticmethod
    def _stamp() -> str:
        return datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")

    def info(self, message: str) -> None:
        for path in (self.exp_path, self.global_path):
            with open(path, "a") as f:
                f.write(message + "\n")

    def end(self) -> None:
        for path in (self.exp_path, self.global_path):
            with open(path, "a") as f:
                f.write(f"\n{self._stamp()}\n")
