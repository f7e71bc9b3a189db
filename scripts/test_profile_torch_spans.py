"""``scripts/profile_torch_spans.py``'s reading of a profile, on synthetic
traces (the CPU, no card):

    python -m pytest scripts/test_profile_torch_spans.py

The spans' device rows are split off the device operations, each operation
is charged to the innermost row that holds it and the charges add up to
the device total exactly, and idle gaps and waits are named by span and
host op."""

import pytest

from profile_torch_spans import (charge, gaps, idle_by_length, split,
                                 waits_ms)
from portbench.harness.profiling import Trace

# one unit, in us: two image kernels, a voxel kernel, a fusion kernel, then
# the descriptors' copy, launched outside every span; the spans' device
# rows; host events (the spans' host rows among them)
OPS = [("conv", 10.0, 30.0), ("relu", 30.0, 35.0), ("k3", 40.0, 60.0),
       ("gemm", 62.0, 64.0), ("Memcpy DtoH", 70.0, 71.0)]
ROWS = [("entry.embed_queries", 10.0, 64.0), ("mm.image", 10.0, 35.0),
        ("mm.voxel", 40.0, 60.0), ("mm.fusion", 62.0, 64.0)]
HOST = [("entry.embed_queries", 0.0, 9.0), ("mm.image", 0.5, 3.0),
        ("aten::conv2d", 1.0, 2.0), ("aten::relu", 2.0, 2.5),
        ("mm.voxel", 3.0, 6.0), ("agp::k3", 4.0, 5.0),
        ("mm.fusion", 6.0, 8.5), ("aten::mm", 7.0, 8.0),
        ("aten::copy_", 9.5, 9.8), ("cudaEventSynchronize", 64.5, 69.5)]
WANT = {"mm.image": 25e-6, "mm.voxel": 20e-6, "mm.fusion": 2e-6,
        None: 1e-6}


def _trace(window=(0.0, 71.0)):
    return Trace(device=OPS + ROWS, host=list(HOST), window=window,
                 units=1)


def test_split_takes_the_rows_off_the_device_operations():
    t = _trace()
    assert split(t) == ROWS
    assert t.device == OPS
    assert t.device_s() == pytest.approx(48e-6, rel=1e-12)


@pytest.mark.parametrize("rows", [ROWS, ROWS[::-1]], ids=["in", "reversed"])
def test_charge_sums_exactly_to_the_device_total(rows):
    got = charge(OPS, rows)
    assert got.keys() == WANT.keys()
    for k, v in WANT.items():
        assert got[k] == pytest.approx(v, rel=1e-12)
    assert sum(got.values()) == pytest.approx(
        sum(e - s for _, s, e in OPS) / 1e6, rel=1e-12)


def test_an_operation_goes_to_the_innermost_row_left():
    """Without its branch's row an operation goes to the row around it;
    under no row (as the backward's kernels, launched from the autograd
    engine's thread) to None."""
    got = charge(OPS, [r for r in ROWS if r[0] != "mm.voxel"])
    assert got["entry.embed_queries"] == pytest.approx(20e-6, rel=1e-12)
    assert "mm.voxel" not in got
    assert charge(OPS, []) == {None: pytest.approx(48e-6, rel=1e-12)}


def test_gaps_are_named_by_span_and_host_op():
    t = _trace()
    split(t)
    g = gaps(t, n=2)
    assert [x["ms"] for x in g] == pytest.approx([0.010, 0.006])
    # at the window's start the host is still launching the voxel kernel
    assert g[0]["span"] == "mm.voxel" and g[0]["host_op"] == "agp::k3"
    assert "host_ops" not in g[0]
    # before the descriptors' copy the host waits, under no span
    assert g[1]["span"] is None
    assert g[1]["host_op"] == "cudaEventSynchronize"
    assert g[1]["host_ops"] == ["cudaEventSynchronize"]


def test_waits_are_named_by_span_and_op():
    host = [*HOST, ("aten::item", 7.2, 7.9),
            ("cudaStreamSynchronize", 7.4, 7.8)]
    assert waits_ms(host, 2) == pytest.approx({
        "mm.fusion aten::item": 0.0002, "None None": 0.0025})


def test_idle_by_length_sums_the_idle_time():
    t = _trace(window=(0.0, 1071.0))
    split(t)
    got = idle_by_length(t)
    assert {k: n for k, (_, n) in got.items()} == {
        "<5us": 1, "5-50us": 3, "50-500us": 0, ">=500us": 1}
    assert sum(ms for ms, _ in got.values()) == pytest.approx(
        (1071.0 - t.busy_s() * 1e6) / 1e3)
