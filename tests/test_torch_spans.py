"""The port's spans (``agplace_tpu_torch/utils/spans.py``) on the CPU: off,
a span is one shared null context and nothing is recorded; on, the entries,
the MM's three branches and the training step's three parts are recorded
with their nesting, as host rows of a ``torch.profiler`` trace too, and
change no number; ``ProfilerTrace`` turns them on for its steps, so the
training loop's ``profile_steps`` trace carries them; ``PhaseTimer`` keeps
its totals."""

import collections
import contextlib
import dataclasses
import json
import os
import re
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from agplace_tpu_torch import config
from agplace_tpu_torch.data.base import collate_train
from agplace_tpu_torch.data.pipeline import prefetch_to_device
from agplace_tpu_torch.data.synthetic import SyntheticDataset
from agplace_tpu_torch.data.voxels import prepare_query_vox
from agplace_tpu_torch.infer import make_infer_fns
from agplace_tpu_torch.train.loop import train
from agplace_tpu_torch.train.step import init_state, make_train_step
from agplace_tpu_torch.utils import spans
from agplace_tpu_torch.utils.spans import PhaseTimer, ProfilerTrace

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BRANCHES = ("mm.image", "mm.voxel", "mm.fusion")
STEP = ("train.forward", "train.backward", "train.optimizer")


@pytest.fixture(autouse=True)
def spans_off():
    spans.enable(False)
    spans.drain()
    yield
    spans.enable(False)
    spans.drain()


def _cfg():
    cfg = config.synthetic_config(batch_size=2, image_size=32,
                                  vox_max_points=128)
    return cfg.replace(model=dataclasses.replace(
        cfg.model, pretrained=False,
        mm=dataclasses.replace(cfg.model.mm, vox_grid_extent=(16, 16, 4))))


@pytest.fixture(scope="module")
def world():
    cfg = _cfg()
    ds = SyntheticDataset(n_db=24, n_q=16, image_size=32, seed=0)
    pts = np.stack([ds.load_query_points(i) for i in range(2)])
    images = torch.from_numpy(
        np.stack([ds.load_query_image(i) for i in range(2)]))
    tri = np.array([[0, 0, 5, 7], [1, 1, 9, 3]])
    batch = next(prefetch_to_device(
        [collate_train(ds, tri, cfg, np.random.default_rng(0))], "cpu"))
    return {"cfg": cfg, "images": images, "batch": batch,
            "vox": prepare_query_vox(cfg, pts, "cpu")}


def _embed(world, state):
    for tower in state.towers:
        tower.eval()
    embed_q, _ = make_infer_fns(*state.towers)
    return embed_q(world["images"], world["vox"])


def _step(world, state):
    return make_train_step(world["cfg"])(state, world["batch"])


@pytest.mark.parametrize("name", sorted(spans.NAMES))
def test_off_a_span_is_the_shared_null_context(name):
    assert spans.span(name) is spans.span("mm.image")
    assert isinstance(spans.span(name), contextlib.nullcontext)


@pytest.mark.parametrize("run", [_embed, _step], ids=["embed", "step"])
def test_off_nothing_is_recorded(world, run):
    run(world, init_state(world["cfg"], "cpu"))
    assert spans.drain() == ([], {}, 0)


def _nested(records, parent, children):
    """``children`` once each under the one record of ``parent``, inside
    its interval, in that order."""
    (top,) = [r for r in records if r.name == parent]
    kids = [r for r in records if r.parent == parent]
    assert [r.name for r in kids] == list(children)
    for r in kids:
        assert top.t0_ns <= r.t0_ns <= r.t1_ns <= top.t1_ns
    assert all(a.t1_ns <= b.t0_ns for a, b in zip(kids, kids[1:]))
    return top


def test_on_embed_queries_records_the_entry_and_three_branches(world):
    state = init_state(world["cfg"], "cpu")
    spans.enable(True)
    _embed(world, state)
    d = spans.drain()
    assert d.calls == {"entry.embed_queries": 1, **dict.fromkeys(BRANCHES,
                                                                 1)}
    top = _nested(d.records, "entry.embed_queries", BRANCHES)
    assert top.parent is None and d.dropped == 0
    assert {r.thread for r in d.records} == {threading.get_ident()}


def test_on_train_step_records_forward_backward_optimizer(world):
    state = init_state(world["cfg"], "cpu")
    spans.enable(True)
    _step(world, state)
    d = spans.drain()
    assert d.calls == {"entry.train_step": 1, **dict.fromkeys(STEP, 1),
                       **dict.fromkeys(BRANCHES, 1)}
    assert _nested(d.records, "entry.train_step", STEP).parent is None
    _nested(d.records, "train.forward", BRANCHES)


def test_spans_change_no_number(world):
    """Descriptors, the loss and the stepped parameters, bit-equal with
    spans off and on, from the same state."""
    out = []
    for on in (False, True):
        spans.enable(on)
        state = init_state(world["cfg"], "cpu")
        desc = _embed(world, state)
        loss = _step(world, state)["loss"]
        out.append((desc, loss, [p.detach().clone() for _, p in
                                 state.named_parameters()]))
    (d0, l0, p0), (d1, l1, p1) = out
    assert torch.equal(d0, d1) and torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


@pytest.mark.parametrize("run", [_embed, _step], ids=["embed", "step"])
def test_under_the_profiler_each_span_is_a_user_annotation(world, run):
    """The profiler's host rows of the spans: the same names, calls and
    nesting as the spans' own records."""
    state = init_state(world["cfg"], "cpu")
    spans.enable(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run(world, state)
    d = spans.drain()
    rows = [e for e in prof.events() if e.name in spans.NAMES]
    assert all(e.is_user_annotation for e in rows)
    assert dict(collections.Counter(e.name for e in rows)) == d.calls

    def parent(e):
        p = e.cpu_parent
        while p is not None and p.name not in spans.NAMES:
            p = p.cpu_parent
        return None if p is None else p.name

    assert sorted((e.name, parent(e)) for e in rows) == sorted(
        (r.name, r.parent) for r in d.records)


@pytest.mark.parametrize("was_on", [False, True])
def test_profiler_trace_turns_spans_on_and_restores(tmp_path, was_on):
    spans.enable(was_on)
    trace = ProfilerTrace(str(tmp_path))
    assert spans.enabled()
    with spans.span("entry.train_step"):
        pass
    path = trace.stop()
    assert spans.enabled() == was_on
    assert '"entry.train_step"' in open(path).read()


@pytest.mark.parametrize("on", [False, True])
def test_phase_timer_totals(on):
    """Totals per phase, nested phases each counted, a phase left by an
    exception still counted; spans on or off, a phase opens no span."""
    spans.enable(on)
    timer = PhaseTimer()
    with timer("train"):
        with timer("eval"):
            pass
    with pytest.raises(KeyError):
        with timer("mining"):
            raise KeyError
    with timer("train"):
        pass
    assert set(timer.totals) == {"train", "eval", "mining"}
    assert timer.totals["train"] >= timer.totals["eval"] >= 0
    assert spans.drain() == ([], {}, 0)


def test_profile_steps_trace_carries_the_step_spans(tmp_path):
    """``train`` with ``profile_steps`` = 1 writes a trace whose host rows
    hold the step's spans once each, nested as the spans' own records;
    spans are off again after the traced step (mining and evaluation
    record nothing)."""
    cfg = _cfg()
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, num_workers=0),
        train=dataclasses.replace(cfg.train, save_dir=str(tmp_path),
                                  profile_steps=1))
    train(cfg, SyntheticDataset(n_db=24, n_q=16, image_size=32, seed=0),
          SyntheticDataset(n_db=24, n_q=12, image_size=32, seed=1),
          max_steps=1, device="cpu")
    assert not spans.enabled()
    d = spans.drain()
    want = {"entry.train_step": 1, **dict.fromkeys(STEP, 1),
            **dict.fromkeys(BRANCHES, 1)}
    assert d.calls == want
    events = json.load(open(tmp_path / "profile" / "trace.json"))[
        "traceEvents"]
    rows = [e for e in events if e.get("name") in spans.NAMES]
    assert all(e["cat"] == "user_annotation" for e in rows)
    assert dict(collections.Counter(e["name"] for e in rows)) == want

    def holds(a, b):
        return a["ts"] <= b["ts"] and (b["ts"] + b["dur"]
                                       <= a["ts"] + a["dur"])

    by = {e["name"]: e for e in rows}
    for r in d.records:
        if r.parent is not None:
            assert holds(by[r.parent], by[r.name]), r


def test_names_are_the_spans_the_program_opens():
    """Every literal ``span(...)`` of the package is in ``NAMES``, and
    every name of ``NAMES`` is opened somewhere; on, a name outside
    ``NAMES`` raises."""
    opened = set()
    pkg = os.path.join(ROOT, "agplace_tpu_torch")
    for base, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(base, f)).read()
                opened |= set(re.findall(r'\bspan\("([^"]+)"\)', src))
    assert opened == spans.NAMES
    spans.enable(True)
    with pytest.raises(ValueError):
        spans.span("mm.unknown")


def test_the_ring_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(spans, "RING", 4)
    monkeypatch.setattr(spans, "_ring", collections.deque(maxlen=4))
    spans.enable(True)
    for _ in range(6):
        with spans.span("mm.image"):
            pass
    d = spans.drain()
    assert len(d.records) == 4 and d.dropped == 2
    assert d.calls == {"mm.image": 6}
    assert spans.drain() == ([], {}, 0)


def test_each_thread_has_its_own_parents():
    spans.enable(True)
    with spans.span("entry.train_step"):
        t = threading.Thread(target=lambda: spans.span(
            "mm.image").__enter__().__exit__(None, None, None))
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    parents = {r.name: r.parent for r in spans.drain().records}
    assert parents == {"mm.image": None, "entry.train_step": None}
