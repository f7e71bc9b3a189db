"""The whole-profile check, the steady window and the device metrics on
synthetic traces; the roofline arithmetic against chip_smoke's."""

import pytest

from portbench.harness import profiling, roofline
from portbench.harness.profiling import Trace

K1 = "void (anonymous namespace)::ode_euler_kernel<0, 256>(float const*)"
K3 = "void agp::eca_kernel<__nv_bfloat16>(float const*)"
CONV = "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc"
# one K3 call on its sm90 instance: both conv phases, ECA, the combine
K3_SM90 = ["void (anonymous namespace)::conv3x3_sm90_kernel<0>(CUtensorMap_st)",
           "void (anonymous namespace)::conv3x3_sm90_kernel<1>(CUtensorMap_st)",
           K3, "(anonymous namespace)::combine_id_kernel(__nv_bfloat16 const*)"]
K3_DS = "void agp::conv_igemm_kernel<2, 0>(agp::ConvParams)"
ZBAND = "void (anonymous namespace)::zband_sm90_kernel<2>(CUtensorMap_st)"
ONE_K3 = {"fused_euler_ode": 3, "fused_eca_block_sm": 1,
          "fused_eca_block_sm/sm90": 1, "fused_head": 0}


def trace(names, units=1):
    t = Trace(units=units)
    at = 100.0
    for n in names:
        t.device.append((n, at, at + 10.0))
        at += 20.0
    t.window = (90.0, at)
    return t


def test_whole_profile_accepted():
    t = trace([K1, K1, K1, *K3_SM90, CONV])
    assert profiling.whole(t, profiling.expected_from_launches(ONE_K3))


@pytest.mark.parametrize("drop", [0, 3, 4, 5, 6])
def test_dropped_kernel_event_rejected(drop):
    """Every hand kernel of a wrapper's call is counted: K1, and each of
    K3's conv phases, its ECA and its combine."""
    names = [K1, K1, K1, *K3_SM90, CONV]
    del names[drop]
    expected = profiling.expected_from_launches(ONE_K3)
    assert not profiling.whole(trace(names), expected)


def test_each_instance_counts_its_own_kernels():
    """K3 with the 1x1 residual on the zband+sm90 instance: one zband and
    one sm90 conv phase, ECA, the residual's combine GEMM."""
    delta = {"fused_eca_block_sm": 1, "fused_eca_block_sm/zband+sm90": 1}
    names = [ZBAND, K3_SM90[1], K3, K3_DS]
    expected = profiling.expected_from_launches(delta)
    assert profiling.whole(trace(names), expected)
    assert not profiling.whole(trace(names[1:]), expected)
    assert not profiling.whole(trace([*names, K3_SM90[0]]), expected)


@pytest.mark.parametrize("delta", [
    {"fused_eca_block": 1},  # a wrapper the table does not list
    {"fused_eca_block_sm": 1},  # no instance counted
    {"fused_head": 1, "fused_head/fused": 1}])  # an instance it lacks
def test_unvouched_launches_are_never_whole(delta):
    assert profiling.expected_from_launches(delta) is None
    assert not profiling.whole(trace([K1, *K3_SM90]), None)


def test_empty_profile_rejected():
    assert not profiling.whole(Trace(), [])


def test_dropped_conv_event_rejected():
    expected = [(r"fprop", 2)]
    assert profiling.whole(trace([CONV, CONV]), expected)
    assert not profiling.whole(trace([CONV]), expected)


def test_busy_idle_and_steady_window():
    t = trace(["a", "b", "c"])  # busy 100-110, 120-130, 140-150
    t.host = [("cudaEventSynchronize", 105.0, 115.0)]
    assert t.busy_s() == pytest.approx(30e-6)
    profiling.steady(t)
    assert t.window == (115.0, 160.0)
    assert t.busy_s() == pytest.approx(20e-6)
    gaps = t.idle_gaps()
    assert [g for g in gaps] == [(115.0, 120.0), (130.0, 140.0),
                                 (150.0, 160.0)]


def test_breakdown_shape():
    t = trace([K1, K3, CONV, CONV])
    t.host = [("aten::conv2d", 95.0, 200.0)]
    b = profiling.breakdown(t)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    assert dict(b["device_ops"])["cuDNN / cuBLAS convs and GEMMs"] == \
        pytest.approx(20e-6)
    assert b["idle_gaps"][0][0] == "aten::conv2d"


def test_kernel_classes():
    assert profiling.k_of(K1) == "K1"
    assert profiling.k_of(K3) == "K3"
    assert profiling.k_of(CONV) is None


def test_roofline_matches_chip_smoke_shapes():
    """PERF.md's kernel table: K1 [32, 256] fp32, 10 steps is 42 MFLOP;
    K2 / K4's stage at [32,128,128,4] -> [32,64,64,128] 40.7 GFLOP; K3's
    four blocks 272.8 GFLOP at b32."""
    assert roofline.k1_work(32, 256, 10).flops == pytest.approx(42e6,
                                                                rel=5e-3)
    work = roofline.mm_hand_work(32, (128, 128, 4), (64, 128, 256), 256, 10)
    k3 = sum(w.flops for w in work["K3"])
    assert k3 == pytest.approx(272.8e9, rel=2e-3)
    assert roofline.live_blocks_s1(5, 4) == 14
    assert roofline.live_blocks_k2s2(4) == 4


def test_least_time():
    assert roofline.least_time_s({"bfloat16": 989e12, "float32": 67e12}) \
        == pytest.approx(2.0)
