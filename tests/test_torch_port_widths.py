"""K1-K4 at every width of the MM's flag space, on the CPU.

JAX's Pallas kernels take any width their flags give (``fused_euler_ode``
keeps x and W whole in VMEM at any D; ``fused_conv0_down0``, ``fused_head``
and ``fused_eca_block_sm`` assert only even X / Y, the conv0 kernel size
and the residual's widths).  The port's wrappers choose an instance by
shape before each launch (``ode_instance``, ``down0_instance``,
``conv3x3_instance`` / ``block_instance``, ``head_instance``): here the
four rules walk z, C and Z*C well past the presets and give every point
an instance, shapes no z-fold gives raise a named ``ValueError``, and K3's
off-preset conv phases are replayed through the z-banded schedule.
``test_torch_port_widths_mm.py`` holds the port's MM to JAX's at the
widths of ``chip_smoke.py``'s [widths] configurations.
"""

import pytest
import torch

from agplace_tpu_torch.data.voxels import me_down_align
from agplace_tpu_torch.ops import bev_block_sm, bev_down, bev_head, ode_step

# two threads, as the train test files sorted before this one set them:
# every xdist worker imports every test file, the last setting wins, and
# the parallel train tests hold their two-thread worker processes
# bit-equal to the pytest process
torch.set_num_threads(2)


# ------------------------------------------------------------- the rules
def test_rules_walk_the_whole_grid():
    """Every point gets an instance from its rule: K1 at D = 1 .. 2304 (the
    grid instance's last width and the wide instance's first) and at the
    wide instance's last widths (and B = 1 .. 129); K3, K2 and K4
    at every z up to 72 with per-z widths C = 1 .. 64 (and some wider),
    Z*C past 4096 included; the sm90 instances exactly where their tiles
    divide and C is a multiple of 8, the z-banded one everywhere else."""
    for dim in (*range(1, 2305), 27135, 27136):
        assert ode_step.ode_instance(33, dim) == (
            "resident" if dim <= 512 else
            "grid" if dim <= 2176 else "wide")
        t = ode_step.ode_tiling(33, dim)
        assert t.dim == -(-dim // 128) * 128
        assert t.rows == (4 if dim <= 512 else 32 if dim <= 2176 else
                          ode_step.wide_rows(t.dim))
    for batch in range(1, 130):
        assert ode_step.ode_instance(batch, 256) == "resident"
    for z in (*range(1, 41), 64, 72):
        zo = me_down_align(z)[2]
        for ci in (*range(1, 65), 108, 212):
            for co in (ci, 8, 60, 128):
                got = bev_block_sm.conv3x3_instance(z * ci, z * co, z)
                assert got == ("sm90" if ci % 8 == 0 and co % 8 == 0
                               and (z * ci) % 64 == 0
                               and (z * co) % 128 == 0 else "zband")
                zc1, zc2 = z * ci, zo * co
                got = bev_down.down0_instance(zc1, zc2, z)
                assert got == ("sm90" if ci % 8 == 0 and co % 8 == 0
                               and bev_down.down0_widths_ok(zc1, zc2, z)
                               else "zband")
                for k0 in (3, 5):
                    head = bev_head.head_instance(z, k0, zc1, zc2, z)
                    assert (head == "window+zband") == (z not in (4, 8, 16)
                                                        or got == "zband")


@pytest.mark.parametrize("rule,args,match", [
    (ode_step.ode_instance, (0, 256), "empty"),
    (ode_step.ode_instance, (32, 0), "empty"),
    (ode_step.ode_instance, (1, 27137), "wider than"),
    (bev_down.down0_instance, (4160, 2080, 5), "no z-fold"),  # Zo = 3
    (bev_block_sm.conv3x3_instance, (100, 100, 3), "no z-fold"),
    (bev_block_sm.conv3x3_instance, (64, 64, 0), "no z-fold"),
    (bev_head.head_instance, (4, 7, 256, 128, 4), "odd and <= 5"),
    (bev_head.head_instance, (4, 5, 256, 128, 0), "no z-fold"),  # z = 0
])
def test_rules_raise_off_the_grid(rule, args, match):
    with pytest.raises(ValueError, match=match):
        rule(*args)


@pytest.mark.parametrize("rule,args,inst", [
    (ode_step.ode_instance, (1, 1025), "grid"),
    (ode_step.ode_instance, (32, 1536), "grid"),
    (ode_step.ode_instance, (32, 2048), "grid"),
    (ode_step.ode_instance, (32, 2177), "wide"),
    (bev_block_sm.conv3x3_instance, (60, 64, 2), "zband"),       # C = 30
    (bev_block_sm.conv3x3_instance, (66, 66, 33), "zband"),      # z = 33
    (bev_block_sm.conv3x3_instance, (8192, 8192, 2), "sm90"),    # Z*C 8192
    (bev_block_sm.conv3x3_instance, (2160, 2160, 36), "zband"),  # W4's
    (bev_block_sm.conv3x3_instance, (4240, 4240, 20), "zband"),  # C = 212
    (bev_down.down0_instance, (256, 60, 4), "zband"),            # C2 = 30
    (bev_down.down0_instance, (4320, 2160, 72), "zband"),        # W4's
    (bev_head.head_instance, (40, 5, 4320, 2160, 40), "window+zband"),  # W5
])
def test_rules_take_past_the_old_grid(rule, args, inst):
    """Widths the port refused before the z-banded instance (D > 1024, z >
    32, C not a multiple of 8, Z*C > 4096) each get an instance."""
    assert rule(*args) == inst


@pytest.mark.parametrize("zci,zco", [(96, 96), (48, 256), (24, 40),
                                     (192, 192)])
def test_k3_narrow_conv_gather_is_the_conv(zci, zco):
    """K3's conv phases off the sm90 tiles (the z-banded instance at z =
    2: C = 48, 24 -> 128, 12 -> 20 padded to 16 and 24, 96), replayed
    through the z-banded schedule, are the 3x3 'same' conv exactly."""
    from tests.test_torch_port_zband import replay_zband

    assert bev_block_sm.conv3x3_instance(zci, zco, 2) == "zband"
    replay_zband("s1", 2, 5, 9, 2, zci // 2, zco // 2)


# ------------------------------------------- the smoke's device-time reader
class _Event:
    def __init__(self, count, us, cuda=True):
        self.count, self.self_device_time_total = count, us
        self.device_type = (torch.autograd.DeviceType.CUDA if cuda
                            else torch.autograd.DeviceType.CPU)


class _Profile:
    def __init__(self, *events):
        self.events = events

    def key_averages(self):
        return list(self.events)


@pytest.mark.parametrize("counts,best", [
    ((150, 150, 150, 150), 0),   # every profile whole
    ((149, 150, 148, 150), 1),   # drops: the first whole one is read
    ((0, 150, 0, 150), 1),       # every other profile recorded nothing
    ((30, 9, 30, 9), 0),         # every other profile lost most
    ((21, 45, 50, 45), 2),
    ((65, 62, 62, 62), 0),       # the first holds a few more
    ((0, 0, 0, 0), None),        # nothing recorded: it raises
    ((3, 0, 0, 0), 0),
])
def test_device_ms_reads_only_a_profile_with_every_launch(monkeypatch,
                                                          counts, best):
    """``chip_smoke.device_ms`` reads, of PROFILE_TRIES profiles of the same
    calls, the one with the most device events (the tracer only drops
    events: none of the others holds one it lacks), and raises if that one
    recorded no device time.  A stub profiler returns the profiles' event
    counts in turn, each event 10 us, beside CPU events that never count;
    the patterns are the card's (PERF.md section 7)."""
    import chip_smoke

    taken = []

    def profile_once(fn, n):
        got = counts[len(taken)]
        taken.append(n)
        return _Profile(_Event(got, 10.0 * got), _Event(7, 5.0, cuda=False))

    monkeypatch.setattr(chip_smoke, "profile_once", profile_once)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    # a call of 0.1 ms by CUDA events: 50 calls fit the profile's 5 ms
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, **k: 0.1)
    assert chip_smoke.PROFILE_TRIES == len(counts) == 4
    if best is None:
        with pytest.raises(RuntimeError, match="recorded device time"):
            chip_smoke.device_ms(lambda: None, n=50)
        return
    assert chip_smoke.device_ms(lambda: None, n=50) == pytest.approx(
        counts[best] * 0.01 / 50)
    assert taken == [50] * 4


@pytest.mark.parametrize("per_call,calls", [(0.01, 50), (0.1, 50),
                                            (0.7, 7), (12.8, 3)])
def test_device_ms_keeps_its_profiles_short(monkeypatch, per_call, calls):
    """``chip_smoke.device_ms`` profiles as many calls as fit
    PROFILE_SPAN_MS by CUDA events, at most the ``n`` asked for, at least
    3: the tracer dropped events in profiles of 10-35 ms on the card."""
    import chip_smoke

    taken = []

    def profile_once(fn, n):
        taken.append(n)
        return _Profile(_Event(n, 10.0 * n))

    monkeypatch.setattr(chip_smoke, "profile_once", profile_once)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, **k: per_call)
    assert chip_smoke.PROFILE_SPAN_MS == 5.0
    assert chip_smoke.device_ms(lambda: None, n=50) == pytest.approx(0.01)
    assert taken == [calls] * chip_smoke.PROFILE_TRIES
