"""The GeoLoc cell (``kitti360-cct384-embed-b128``, ``mixes/embed_geoloc.py``)
end to end at a tiny size on the CPU, its faults and control, and its
yardstick: the attention core's work, the span rows a traced run reads,
the whole-profile check and the FLOPs at the cell's size."""

import json

import pytest
import torch

from portbench import calibrate, run
from portbench.harness import cell as cells
from portbench.harness import geoloc
from portbench.harness.profiling import Trace, whole
from portbench.harness.window import closed_loop
from portbench.tests import tiny

NAME = "kitti360-cct384-embed-b128"
TINY_EXTRA = {"model.trunc_te": 2, "model.netvlad_clusters": 8}
TINY_PARAMS = {"batch": 2, "pool": 2, "image_hw": [64, 64], "check_rows": 4,
               "profile_units": 1}
# the tiny cell's limit, from its own readings on the CPU over 12 seeds
# (calibrate.readings): the program 0.0001-0.019, the fp8 control
# 0.30-0.70; 16 tokens an image over 8 clusters make the head's soft
# assignment the noisiest part, so the gap reads wider than at the cell's
# size
TINY_LIMIT = {"desc_rel_err": 0.08}


def tiny_cell():
    cell = cells.load(NAME)
    cell.traffic["params"].update(TINY_PARAMS)
    cell.limits = dict(TINY_LIMIT)
    return cell


def tiny_run(trace=0, seed=2 ** 31 + 11, cell=None):
    return run.run(tiny.args(NAME, seed=seed, trace=trace), "cpu",
                   TINY_EXTRA, cell or tiny_cell())


def test_cell_runs_tiny():
    out = tiny_run()
    assert list(out)[-1] == "checked"
    assert set(out["metrics"]) == {m["name"] for m in
                                   cells.load(NAME).end_to_end}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert out["failed"] == 0 and out["correct"], out["checked"]
    json.dumps(out)


def test_traced_run_tiny():
    """No device work on the CPU: only the host-clock metrics appear."""
    out = tiny_run(trace=1)
    assert set(out["metrics"]) == {"host_enqueue_ms.embed", "mfu.embed"}
    assert out["correct"]


def _one_altered(out):
    out = out.clone()
    out[0] = out[0] * 1.2
    return out


def _rows_swapped(out):
    return out.flip(0)


@pytest.mark.parametrize("alter", [_one_altered, _rows_swapped])
def test_altered_answer_is_not_correct(monkeypatch, alter):
    from agplace_tpu_torch import infer

    real = infer.make_infer_fns

    def make(mm, db):
        q, d = real(mm, db)
        return (lambda *a: alter(q(*a))), d

    monkeypatch.setattr(infer, "make_infer_fns", make)
    cell = tiny_cell()
    # every kept row checked (a window keeps both rows of each batch of
    # 2): a sample of a few could miss each unit's row 0
    cell.traffic["params"]["check_rows"] = 10 ** 6
    assert not tiny_run(cell=cell)["correct"]


def test_a_nonfinite_row_counts_as_failed(monkeypatch):
    def one_nan(out):
        out = out.clone()
        out[1, 5] = float("nan")
        return out

    from agplace_tpu_torch import infer

    real = infer.make_infer_fns
    monkeypatch.setattr(infer, "make_infer_fns", lambda mm, db: (
        (lambda *a: one_nan(real(mm, db)[0](*a))), None))
    out = tiny_run()
    assert out["failed"] > 0 and not out["correct"]


def test_a_tower_that_ignores_the_precision_cannot_run_the_cell(
        monkeypatch):
    """A GeoLoc tower built in fp32 whatever ``compute_dtype`` says (as
    JAX's factory builds it) ends set-up with an error, before any
    window."""
    from agplace_tpu_torch.models import factory

    real = factory.geoloc_net
    monkeypatch.setattr(factory, "geoloc_net",
                        lambda cfg, hw, dtype=None: real(cfg, hw))
    session = tiny_cell().mix_module().Session(tiny_cell(), 3, "cpu",
                                               TINY_EXTRA)
    with pytest.raises(RuntimeError, match="none in the configuration's "
                                           "bfloat16"):
        session.setup()


@pytest.mark.parametrize("seen, precision, ok", [
    ({"bfloat16": 86, "float32": 2}, "bfloat16", True),
    ({"float32": 88}, "bfloat16", False),
    ({}, "bfloat16", False),
    ({"float32": 88}, "float32", True),
])
def test_require_precision(seen, precision, ok):
    from collections import Counter

    if ok:
        geoloc.require_precision(Counter(seen), precision)
    else:
        with pytest.raises(RuntimeError):
            geoloc.require_precision(Counter(seen), precision)


def test_product_dtypes_of_the_tiny_tower():
    """The bf16 tower's encoder takes bf16 in each of its 6 products a
    layer (qkv, QK^T, AV, proj, mlp1, mlp2).  On the CPU the tokenizer's
    two convs run as fp32 convs of bf16-rounded operands; NetVLAD rounds
    its operands and multiplies in fp32 (two products), and the seqpool
    head's weight is fp32: 5 in fp32."""
    session = tiny_cell().mix_module().Session(tiny_cell(), 3, "cpu",
                                               TINY_EXTRA)
    session.setup()
    seen = geoloc.product_dtypes(lambda: session.entry(0))
    assert seen == {"bfloat16": 6 * TINY_EXTRA["model.trunc_te"],
                    "float32": 5}, seen


def test_each_batch_keeps_two_seeded_rows():
    """Of a batch of 4, the window keeps 2 rows a unit, drawn from the
    seed and the unit's index, and every row's finiteness; the check
    samples among the kept rows."""
    cell = tiny_cell()
    cell.traffic["params"].update(batch=4, check_rows=6)
    session = cell.mix_module().Session(cell, 5, "cpu", TINY_EXTRA)
    session.setup()
    w = closed_loop(session.dispatch, 2, 0.0, max_units=6)
    kept = [sorted(u.payload.rows) for u in w.units]
    assert all(len(k) == 2 for k in kept) and len(set(map(tuple, kept))) > 1
    assert all(u.payload.finite.shape == (4,) and u.payload.finite.all()
               for u in w.units)
    assert all(r in kept[u] for u, r in session.sample(w))
    assert len(session.sample(w)) == 6


def test_fp8_control_is_not_correct():
    rec = calibrate.readings(tiny_cell(), 2 ** 31 + 13, 0.2, "cpu",
                             TINY_EXTRA)
    assert rec["program"]["desc_rel_err"] <= TINY_LIMIT["desc_rel_err"]
    assert rec["control"]["desc_rel_err"] > TINY_LIMIT["desc_rel_err"]


# ------------------------------------------------------------ the yardstick
def test_attention_core_work_at_the_cells_size():
    """B 128, 6 heads, 576 tokens of 64: 65.2 GFLOP and 226.5 MB a layer,
    bound by the bytes at ~0.068 ms."""
    w = geoloc.attention_core_work(128, 6, 576, 64)
    assert w.flops == 4 * 128 * 6 * 576 ** 2 * 64
    assert w.bytes == 4 * 2 * 128 * 6 * 576 * 64
    assert w.bound_s == pytest.approx(w.bytes / 3.35e12)
    assert w.bound_s == pytest.approx(0.0676e-3, rel=1e-3)


LN = "vectorized_layer_norm_kernel<float, float, false>"


def _trace():
    """Two units: each a tokenizer row over a conv, an encoder row holding
    two layers (a LayerNorm and a GEMM, an attn row, a LayerNorm) and the
    final LayerNorm."""
    t = Trace(units=2)
    for u in range(2):
        at = 1000.0 * u
        t.device += [("geoloc.tokenizer", at, at + 10), ("fprop", at, at + 10),
                     ("geoloc.encoder", at + 20, at + 200)]
        for a in (at + 20, at + 105):
            t.device += [(LN, a, a + 5), ("gemm", a + 5, a + 20),
                         ("geoloc.attn", a + 20, a + 80),
                         ("bmm", a + 20, a + 40),
                         ("softmax_warp_forward", a + 40, a + 60),
                         ("bmm", a + 60, a + 80), (LN, a + 80, a + 85)]
        t.device += [(LN, at + 190, at + 195)]
    t.window = (0.0, 2000.0)
    return t


def test_span_rows_leave_the_device_ops_and_charge_their_kernels():
    t = _trace()
    rows = geoloc.split_rows(t, {"geoloc.tokenizer", "geoloc.encoder",
                                 "geoloc.attn"})
    assert len(rows) == 8 and not any(n.startswith("geoloc.")
                                      for n, _, _ in t.device)
    spent = geoloc.device_s_under(t, rows)
    assert spent == pytest.approx({"geoloc.tokenizer": 20e-6,
                                   "geoloc.encoder": 350e-6,
                                   "geoloc.attn": 240e-6})
    rec = {"kind": "embed", "trace": t, "span_device_s": spent,
           "attn_bound_s": 30e-6}
    read = {m: cells.metric_reader(m).read(rec) for m in (
        "encoder_device_ms.geoloc", "attn_device_ms.geoloc",
        "attn_roofline_pct.geoloc")}
    assert read == pytest.approx({"encoder_device_ms.geoloc": 0.175,
                                  "attn_device_ms.geoloc": 0.12,
                                  "attn_roofline_pct.geoloc": 25.0})


def test_readers_read_nothing_without_span_rows():
    """The parent commit opens no ``geoloc.*`` span: nothing to read."""
    rec = {"kind": "embed", "trace": _trace(), "span_device_s": {},
           "attn_bound_s": 30e-6}
    for m in ("encoder_device_ms.geoloc", "attn_device_ms.geoloc",
              "attn_roofline_pct.geoloc"):
        assert cells.metric_reader(m).read(rec) is None


def test_whole_profile_needs_every_layer_norm_and_span_row():
    session = tiny_cell().mix_module().Session(tiny_cell(), 1, "cpu",
                                               TINY_EXTRA)
    delta = {"layer_norms": 10, "geoloc.attn": 4, "geoloc.encoder": 2,
             "geoloc.tokenizer": 2}
    t = _trace()
    assert whole(t, session.expect(delta))
    assert whole(t, session.expect({"layer_norms": 10}))  # no spans opened
    assert session.expect({"geoloc.attn": 4}) is None  # no forward
    dropped_row = _trace()
    dropped_row.device.remove(("geoloc.attn", 40.0, 100.0))
    assert not whole(dropped_row, session.expect(delta))
    dropped_kernel = _trace()
    dropped_kernel.device.remove((LN, 190.0, 195.0))
    assert not whole(dropped_kernel, session.expect({"layer_norms": 10}))


def test_counters_count_layer_norm_calls_and_spans():
    """The tiny tower (2 layers): 5 LayerNorm calls a forward; spans are
    on only while a profiler records."""
    from torch.profiler import ProfilerActivity, profile

    session = tiny_cell().mix_module().Session(tiny_cell(), 1, "cpu",
                                               TINY_EXTRA)
    session.setup()
    before = session.counters()
    session.dispatch(0).done()
    mid = session.counters()
    assert mid["layer_norms"] - before["layer_norms"] == 5
    assert not any(k.startswith("geoloc.") for k in mid)
    with profile(activities=[ProfilerActivity.CPU]):
        session.dispatch(1).done()
    after = session.counters()
    assert after["layer_norms"] - mid["layer_norms"] == 5
    assert {k: after[k] for k in after if k.startswith("geoloc.")} == {
        "geoloc.tokenizer": 1, "geoloc.encoder": 1, "geoloc.attn": 2,
        "geoloc.aggregation": 1}
    session.layer_record(session.window(0.05), None)
    assert not session.spans.enabled()


def test_flops_and_tower_at_the_cells_size():
    """37.2 GFLOP an image (tokenizer 6.24, 14 layers of 2.21, NetVLAD
    0.06), 4.76 TFLOP a batch of 128; 24,576-d descriptors from 21.6 M
    parameters."""
    from agplace_tpu_torch.models.factory import make_query_model

    cell = cells.load(NAME)
    session = cell.mix_module().Session(cell, 1, "cpu")
    mm = make_query_model(session.cfg, torch.bfloat16)
    assert mm.out_dim == 64 * 384
    n_params = sum(p.numel() for p in mm.parameters())
    assert 21.0e6 < n_params < 22.5e6
    session.state = {"mm." + k: v for k, v in mm.state_dict().items()}
    per_image = (2 * 192 ** 2 * 64 * 3 * 49 + 2 * 48 ** 2 * 384 * 64 * 49
                 + 14 * (2 * 576 * 384 * (3 * 384 + 384 + 2 * 1152)
                         + 4 * 6 * 576 ** 2 * 64)
                 + 2 * 2 * 576 * 384 * 64)
    assert session.flops() == {"bfloat16": pytest.approx(128 * per_image)}
    assert 128 * per_image == pytest.approx(4.7636e12, rel=1e-4)


def test_config_is_the_published_tower():
    cell = cells.load(NAME)
    cfg = cells.port_config(cell.config, "embed")
    arch = cell.mix_module().arch_of(cfg)
    assert arch["layers"] == 14 and cfg.model.netvlad_clusters == 64
    assert cfg.data.q_resize == cfg.data.db_resize == 384
    assert cell.params["image_hw"] == [384, 384]
    assert cell.config["reduced"] == ["model.compute_dtype",
                                      "model.pretrained"]
    assert cfg.model.compute_dtype == "bfloat16"
