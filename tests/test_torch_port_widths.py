"""K1-K4 at every width of the MM's flag space, on the CPU.

JAX's Pallas kernels take any width their flags give (``fused_euler_ode``
keeps x and W whole in VMEM at any D; ``fused_conv0_down0``, ``fused_head``
and ``fused_eca_block_sm`` assert only even X / Y, the conv0 kernel size
and the residual's widths).  The port's wrappers choose an instance by
shape before each launch (``ode_instance``, ``down0_instance``,
``conv3x3_instance`` / ``block_instance``, ``head_instance``): here every
point of the width grid goes through the four rules and gets an instance,
points off the grid raise a named ``ValueError``, and the narrow conv
phases' gather is replayed.  ``test_torch_port_widths_mm.py`` holds the
port's MM to JAX's at the widths of ``chip_smoke.py``'s [widths]
configurations.
"""

import pytest
import torch

from agplace_tpu_torch.data.voxels import me_down_align
from agplace_tpu_torch.ops import (bev_block_sm, bev_down, bev_head,
                                   ode_step, widths)
from tests.test_torch_port_stage0 import _ints, _replay_igemm

# two threads, as the train test files sorted before this one set them:
# every xdist worker imports every test file, the last setting wins, and
# the parallel train tests hold their two-thread worker processes
# bit-equal to the pytest process
torch.set_num_threads(2)


# ------------------------------------------------------------- the rules
def test_rules_walk_the_whole_grid():
    """Every point of the grid gets an instance from its rule: K1 at D =
    1 .. 1024 (and B = 1 .. 129), K3 at every Zcin -> Zcout pair of C
    multiples of 8 at every z <= 32 with Z*C <= 4096, K2 at every Z*C1 ->
    Zo*C2 pair, K4 at Z*C0 = z (C0 = 1) and k0 in (3, 5) over the same
    pairs; the sm90 instances exactly where their tiles divide."""
    for dim in range(1, 1025):
        assert ode_step.ode_instance(33, dim) == (
            "resident" if dim <= 512 else "streamed")
        assert ode_step.ode_tiling(33, dim).dim == -(-dim // 128) * 128
    for batch in range(1, 130):
        assert ode_step.ode_instance(batch, 256) == "resident"
    for z in range(1, 33):
        zo = me_down_align(z)[2]
        cs = range(8, 4096 // z + 1, 8)
        cos = range(8, 4096 // zo + 1, 8)
        for ci in cs:
            for co in cs:
                got = bev_block_sm.conv3x3_instance(z * ci, z * co, z)
                assert got == ("sm90" if (z * ci) % 64 == 0
                               and (z * co) % 128 == 0 else "igemm")
            for co in cos:
                zc1, zc2 = z * ci, zo * co
                got = bev_down.down0_instance(zc1, zc2, z)
                assert got == ("sm90" if bev_down.down0_widths_ok(zc1, zc2,
                                                                  z)
                               else "igemm")
                for k0 in (3, 5):
                    head = bev_head.head_instance(z, k0, zc1, zc2, z)
                    assert (head == "igemm") == (z not in (4, 8, 16)
                                                 or got == "igemm")


@pytest.mark.parametrize("rule,args", [
    (ode_step.ode_instance, (0, 256)),
    (ode_step.ode_instance, (1, 1025)),
    (bev_block_sm.conv3x3_instance, (60, 64, 2)),      # C = 30
    (bev_block_sm.conv3x3_instance, (66, 66, 33)),     # z = 33
    (bev_block_sm.conv3x3_instance, (8192, 8192, 2)),  # Z*C > 4096
    (bev_down.down0_instance, (256, 60, 4)),           # C2 = 30
    (bev_down.down0_instance, (4160, 2080, 5)),        # Z*C1 > 4096
    (bev_head.head_instance, (4, 7, 256, 128, 4)),     # k0 = 7
    (bev_head.head_instance, (4, 5, 256, 128, 0)),     # z = 0
])
def test_rules_raise_off_the_grid(rule, args):
    with pytest.raises(ValueError, match="outside the kernel's tiles"):
        rule(*args)


@pytest.mark.parametrize("zci,zco", [(96, 96), (48, 256), (24, 40),
                                     (192, 192)])
def test_k3_narrow_conv_gather_is_the_conv(zci, zco):
    """K3's narrow conv phases (the 3x3 'same' conv on the wmma implicit
    GEMM, by ``igemm_gather``: 32-channel slices at Zcin = 96, 192,
    8-channel chunks at 48 and 24) replayed block by block."""
    assert widths.igemm_gather(zci) == (0 if zci % 32 == 0 else 1)
    _replay_igemm(_ints((2, 5, 9, zci), 6), _ints((3, 3, zci, zco), 7), 1, 1)
