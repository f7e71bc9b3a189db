"""Every cell end to end at a tiny size on the CPU (the program's plain
versions), the comparison against the reference, and the faults and the
control that have to come out as not correct."""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import calibrate, run
from portbench.harness import cell as cells
from portbench.tests import tiny

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = cells.benchmark()
NAMES = [w["name"] for w in BENCH["workloads"]]
EMBED = [n for n in NAMES if cells.load(n).mix == "embed"]
TRAIN = [n for n in NAMES if cells.load(n).mix == "train"]
KEYS = ("correct", "attempted", "failed", "metrics", "device")


def tiny_run(name, trace=0, seed=3):
    return run.run(tiny.args(name, seed=seed, trace=trace), "cpu",
                   tiny.TINY_CONFIG, tiny.tiny_cell(name))


@pytest.mark.parametrize("name", NAMES)
def test_cell_runs_tiny(name):
    out = tiny_run(name)
    assert all(k in out for k in KEYS)
    assert list(out)[-1] == "checked"
    cell = cells.load(name)
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert out["correct"], out["checked"]
    json.dumps(out)


@pytest.mark.parametrize("name", [EMBED[0], TRAIN[0]])
def test_traced_run_tiny(name):
    """On the CPU no profile has device work: only the metrics read from
    the benchmark's clocks appear, and none reads 0."""
    out = tiny_run(name, trace=1)
    cell = cells.load(name)
    assert set(out["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert out["correct"]


def test_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench import run\n"
            "from portbench.tests import tiny\n"
            "n = %r\n"
            "run.run(tiny.args(n), 'cpu', tiny.TINY_CONFIG, tiny.tiny_cell(n))\n"
            "print(run.forbidden_modules())" % (ROOT, EMBED[0]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"


def _patched_embed(monkeypatch, alter):
    from agplace_tpu_torch import infer

    real = infer.make_infer_fns

    def make(mm, db):
        q, d = real(mm, db)
        return (lambda *a: alter(q(*a))), (lambda *a: alter(d(*a)))

    monkeypatch.setattr(infer, "make_infer_fns", make)


def _one_altered(out):
    out = out.clone()
    out[0] = out[0] * 1.2
    return out


def _half_left_out(out):
    out = out.clone()
    out[out.shape[0] // 2:] = 0
    return out


@pytest.mark.parametrize("alter", [_one_altered, _half_left_out])
@pytest.mark.parametrize("name", EMBED)
def test_embed_fault_is_not_correct(monkeypatch, name, alter):
    _patched_embed(monkeypatch, alter)
    cell = tiny.tiny_cell(name)
    cell.traffic["params"]["check_rows"] = 2 * cell.params["batch"]
    out = run.run(tiny.args(name), "cpu", tiny.TINY_CONFIG, cell)
    assert not out["correct"]


def test_wrong_port_kernel_is_not_correct(monkeypatch):
    """A copy of the program whose K3 (the ECA block) returns its output
    at half scale fails the comparison."""
    from agplace_tpu_torch.ops import bev_block_sm

    real = bev_block_sm.fused_eca_block_sm
    monkeypatch.setattr(bev_block_sm, "fused_eca_block_sm",
                        lambda *a, **k: real(*a, **k) * 0.5)
    out = tiny_run(EMBED[0])
    assert not out["correct"], out["checked"]


def _patched_step(monkeypatch, wrap):
    from agplace_tpu_torch.train import step

    real = step.make_train_step
    monkeypatch.setattr(step, "make_train_step",
                        lambda cfg, mesh=None: wrap(real(cfg, mesh)))


def _unchanged(fn):
    def step(state, batch):
        snap = [p.detach().clone() for _, p in state.named_parameters()]
        out = fn(state, batch)
        with torch.no_grad():
            for (_, p), v in zip(state.named_parameters(), snap):
                p.copy_(v)
        return out
    return step


def _half_batch(fn):
    def step(state, batch):
        from agplace_tpu_torch.data.pipeline import map_tensors

        b = batch["query_image"].shape[0] // 2
        nneg = batch["db_map"].shape[1] - 1
        half = {k: v for k, v in batch.items()}
        for k in ("query_image", "query_eastnorth", "db_map",
                  "db_eastnorth"):
            half[k] = batch[k][:b]
        half["vox"] = map_tensors(batch["vox"], lambda t: t[:b])
        half["triplets_local"] = batch["triplets_local"][:b * nneg]
        return fn(state, half)
    return step


@pytest.mark.parametrize("wrap", [_unchanged, _half_batch])
@pytest.mark.parametrize("name", TRAIN)
def test_train_fault_is_not_correct(monkeypatch, name, wrap):
    _patched_step(monkeypatch, wrap)
    assert not tiny_run(name)["correct"]


def _from_call(first, fault):
    """``fault`` on the step's calls from the ``first``-th on (1-based),
    the program's own step before them."""
    def wrap(fn):
        calls = [0]
        faulty = fault(fn)

        def step(state, batch):
            calls[0] += 1
            return (faulty if calls[0] >= first else fn)(state, batch)
        return step
    return wrap


def _nan_loss(fn):
    def step(state, batch):
        out = dict(fn(state, batch))
        out["loss"] = out["loss"] * float("nan")
        return out
    return step


@pytest.mark.parametrize("name", TRAIN)
def test_train_fault_in_the_window_only_is_not_correct(monkeypatch, name):
    """Set-up's warm-up (one step per pool batch) runs the program's own
    step; every window step leaves the state unchanged."""
    pool = tiny.tiny_cell(name).params["pool"]
    _patched_step(monkeypatch, _from_call(pool + 1, _unchanged))
    out = tiny_run(name)
    assert not out["correct"], out["checked"]


@pytest.mark.parametrize("name", TRAIN)
def test_train_nan_after_the_compared_steps_fails(monkeypatch, name):
    """A window step past those the reference follows returns a
    non-finite loss: it counts as failed and the run is not correct."""
    pool = tiny.tiny_cell(name).params["pool"]
    _patched_step(monkeypatch, _from_call(2 * pool + 1, _nan_loss))
    out = tiny_run(name)
    assert out["failed"] >= 1 and not out["correct"], out


@pytest.mark.parametrize("name", EMBED + TRAIN)
def test_control_is_not_correct(name):
    """The reference one precision step below the configuration's, in the
    program's place, fails at least one number."""
    cell = tiny.tiny_cell(name)
    rec = calibrate.readings(cell, 5, 0.2, "cpu", tiny.TINY_CONFIG)
    limits = cell.limits
    assert all(rec["program"][k] <= v for k, v in limits.items())
    assert any(rec["control"][k] > v for k, v in limits.items())
