"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU (the kernels have no CPU mode) and skip
without one; on the card run ``python -m pytest --noconftest
tests/test_torch_port_cuda.py -m cuda``.  The file
imports no JAX, so it runs on a machine that has only the port's stack.
Shapes are small.  K1-K4 take every width of the MM's flag space (any z,
C and Z*C; K1 any D up to 27136), each width on the instance its
wrapper's rule picks; the other kernels keep their tile constraints
(folded channel widths in multiples of 32).
"""

import copy
import dataclasses

import pytest
import torch

from agplace_tpu_torch import kitti360_config, nuscenes_config, ops, \
    synthetic_config
from agplace_tpu_torch.data.voxels import me_down_align
from agplace_tpu_torch.ops import (attention, bev_block, bev_block_sm,
                                   bev_down, bev_head, ode_step,
                                   probe_block_sm_v2, probe_down_v2,
                                   stem_pool)
from agplace_tpu_torch.sparse.bev_grid import BEVGrid, fold_w2_k2s2, \
    fold_w2_stride1

K1_TOL = dict(rtol=1e-4, atol=1e-5)  # fp32, summation order only
# bf16 with fp32 accumulation: isolated 1-ulp flips from the different
# summation order (wmma tiles vs cuDNN), scaled by the output's magnitude
# (the residual add can cancel a large flipped term).  A kernel that
# rounds at other points (K2's in K4, K3's in K6) stays inside that bound
# but changes far more outputs, so the share of the non-zero outputs that
# differ at all is bounded too: 0.15 for the ECA blocks, whose conv1 flips
# move many conv2 sums (measured on an H100 80GB HBM3: 2e-4 to 1.4e-2), 1e-3
# for the BEV stage 0, whose conv0 sums are exact (0 to 7.1e-5).
BF16_ATOL_FRAC, BF16_RTOL = 1e-2, 2e-2
BLOCK_FRAC_DIFFER, STAGE0_FRAC_DIFFER = 0.15, 1e-3
# other rounding points differ in more than this share (measured: 0.32
# for K3's in K6, 0.69 for K2's in K4)
ROUNDING_MIN_DIFFER = 0.25
# one conv phase of K3 against its plain version: the same rounding points,
# another summation order (wgmma vs cuDNN), so only isolated 1-ulp flips
# (measured by chip_smoke.py on an H100 80GB HBM3: 2.1e-5 to 9.8e-4 of the
# non-zero outputs); the masked pool sums those bf16 values in fp32 in
# another order (measured: within 1.3e-4 of its largest magnitude)
CONV_FRAC_DIFFER, POOL_TOL = 1e-2, 5e-3


def _frac_differ(got, want):
    """Share of the outputs either leaves non-zero on which they differ."""
    got, want = got.float(), want.float()
    live = (got != 0) | (want != 0)
    return float((got != want).sum()) / max(int(live.sum()), 1)


def _close_bf16(got, want, frac_limit):
    got, want = got.float(), want.float()
    bound = BF16_ATOL_FRAC * want.abs().max() + BF16_RTOL * want.abs()
    assert bool(((got - want).abs() <= bound).all())
    assert float((got - want).abs().mean()) <= 1e-4 * float(want.abs().max())
    frac = _frac_differ(got, want)
    assert frac <= frac_limit, frac


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _gen():
    return torch.Generator().manual_seed(0)


def _affine(g, c, z, dev):
    s = torch.rand(c, generator=g) + 0.5
    b = torch.randn(c, generator=g) * 0.1
    return s.repeat(z).to(dev), b.repeat(z).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["relu", "tanh", "sigmoid", "id"])
def test_k1_kernel_matches_plain(cuda, act):
    g = _gen()
    x = torch.randn(13, 256, generator=g).to(cuda)  # ragged row tile
    w = (torch.randn(256, 256, generator=g) / 16).to(cuda)
    b = (torch.randn(256, generator=g) * 0.1).to(cuda)
    ops.reset_launches()
    with torch.inference_mode():
        got = ode_step.fused_euler_ode(x, w, b, 10, 0.1, act)
        want = ode_step.euler_ode_plain(x, w, b, 10, 0.1, act)
    torch.testing.assert_close(got, want, **K1_TOL)
    assert ode_step.fused_euler_ode.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["relu", "tanh"])
@pytest.mark.parametrize("batch", [1, 32, 33, 128])
def test_k1_kernel_matches_plain_at_batches(cuda, batch, act):
    """The serving batches (32, 128: 4 and 16 clusters of 8 rows) and
    ragged ones (1, 33: a last tile of 1 row)."""
    g = _gen()
    x = torch.randn(batch, 256, generator=g).to(cuda)
    w = (torch.randn(256, 256, generator=g) / 16).to(cuda)
    b = (torch.randn(256, generator=g) * 0.1).to(cuda)
    ops.reset_launches()
    with torch.inference_mode():
        got = ode_step.fused_euler_ode(x, w, b, 10, 0.1, act)
        want = ode_step.euler_ode_plain(x, w, b, 10, 0.1, act)
    torch.testing.assert_close(got, want, **K1_TOL)
    assert ode_step.fused_euler_ode.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["relu", "sigmoid"])
@pytest.mark.parametrize("dim", [1, 100, 128, 384, 512, 600, 1024, 1025,
                                 1536, 2048, 2176, 3072])
def test_k1_kernel_matches_plain_off_the_preset_width(cuda, dim, act):
    """D other than the presets' 256: the resident instance up to 512, the
    grid one up to 2176, the wide one above (3072), D padded to a multiple
    of 128 with zeros (the
    sigmoid moves the padded columns off 0; W's zero rows keep them out of
    the real sums)."""
    g = _gen()
    x = torch.randn(33, dim, generator=g).to(cuda)
    w = (torch.randn(dim, dim, generator=g) / dim ** .5).to(cuda)
    b = (torch.randn(dim, generator=g) * 0.1).to(cuda)
    ops.reset_launches()
    with torch.inference_mode():
        got = ode_step.fused_euler_ode(x, w, b, 10, 0.1, act)
        want = ode_step.euler_ode_plain(x, w, b, 10, 0.1, act)
    assert got.shape == (33, dim)
    torch.testing.assert_close(got, want, **K1_TOL)
    inst = ode_step.ode_instance(33, dim)
    assert ode_step.fused_euler_ode.instances[inst] == 1
    assert ode_step.fused_euler_ode.launches == 1


def _stage0_args(g, b, xy, c1, dev, k0=5, z=4):
    """Occupancy [b, xy, xy, z] as the BEV stage 0's input, conv0 k0 x k0,
    widths Z*C1 -> Zo*C1, from the generator ``g``."""
    mask = (torch.rand(b, xy, xy, z, generator=g) < 0.3).to(dev)
    w0 = fold_w2_stride1(torch.randn(k0, k0, k0, 1, c1, generator=g) * .25, z)
    s0, b0 = _affine(g, c1, z, dev)
    wd = fold_w2_k2s2(torch.randn(2, 2, 2, c1, c1, generator=g) * .09, z)
    return (mask.to(torch.bfloat16), mask, w0.to(dev), s0, b0, wd.to(dev),
            *_affine(g, c1, me_down_align(z)[2], dev))


@pytest.mark.cuda
@pytest.mark.parametrize("b,xy", [(2, 32), (3, 20), (3, 32), (5, 128)])
def test_k2_kernel_matches_plain(cuda, b, xy):
    """KITTI widths (Z*C1 = 256 -> Zo*C2 = 128); 10 x 10 and 16 x 16 output
    cells leave ragged 8 x 16 patches; 5 x 128 x 128 has 160 tiles, more
    than the card's SMs, so persistent blocks walk more than one."""
    z = 4
    args = _stage0_args(_gen(), b, xy, 64, cuda)
    ops.reset_launches()
    with torch.inference_mode():
        got, m1 = bev_down.fused_conv0_down0(*args, z=z)
        want, m2 = bev_down.conv0_down0_plain(*args, z=z)
    assert torch.equal(m1, m2) and got.dtype == torch.bfloat16
    _close_bf16(got, want, STAGE0_FRAC_DIFFER)
    mf = m1.repeat_interleave(64, dim=-1)
    assert bool((got[~mf] == 0).all())
    assert bev_down.fused_conv0_down0.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("z,b,xy", [(8, 3, 20), (8, 2, 64), (16, 2, 32)])
def test_k2_kernel_matches_plain_on_wider_maps(cuda, z, b, xy):
    """The other presets' stage-0 widths, c1 = 64: nuScenes and the default
    config at z = 8 (Z*C1 = 512 -> Zo*C2 = 256, two N tiles), the
    synthetic config at z = 16 (1024 -> 512, four N tiles)."""
    zo = me_down_align(z)[2]
    args = _stage0_args(_gen(), b, xy, 64, cuda, z=z)
    ops.reset_launches()
    with torch.inference_mode():
        got, m1 = bev_down.fused_conv0_down0(*args, z=z)
        want, m2 = bev_down.conv0_down0_plain(*args, z=z)
    assert torch.equal(m1, m2) and got.shape[-1] == zo * 64
    _close_bf16(got, want, STAGE0_FRAC_DIFFER)
    mf = m1.repeat_interleave(64, dim=-1)
    assert bool((got[~mf] == 0).all()) and bool((got != 0).any())
    assert bev_down.fused_conv0_down0.launches == 1


def _conv0(args):
    """conv0's bare output of the stage-0 arguments, as K2's wrapper
    computes it."""
    from agplace_tpu_torch.sparse.bev_grid import bev_conv2d

    k0 = int(args[2].shape[0])
    return bev_conv2d(args[0], args[2], 1, (k0 // 2,) * 2,
                      (k0 // 2,) * 2).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["k2", "k4", "p2"])
def test_stage0_item_with_empty_mask_gives_exact_zeros(cuda, kernel):
    z = 4
    args = _stage0_args(_gen(), 3, 20, 64, cuda)
    mask = args[1].clone()
    mask[1] = False  # item 1: no occupied cell
    args = (mask.to(torch.bfloat16), mask, *args[2:])
    fn = {"k2": bev_down.fused_conv0_down0,
          "k4": bev_head.fused_head,
          "p2": probe_down_v2.fused_down_concat}[kernel]
    with torch.inference_mode():
        out, _ = fn(*args, z=z)
    assert bool((out[1] == 0).all()) and bool((out[0] != 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["k2", "k4"])
@pytest.mark.parametrize("z,c1,k0", [(4, 32, 3), (5, 64, 5), (6, 32, 5),
                                     (3, 8, 3), (1, 8, 5), (32, 16, 3),
                                     (72, 60, 5), (40, 108, 3), (6, 25, 5),
                                     (33, 12, 3)])
def test_stage0_kernels_match_plain_off_their_tiles(cuda, kernel, z, c1,
                                                    k0):
    """Widths off the presets, each on its rule's instance (the z-banded
    down0 wherever the sm90 tiles do not take them): Z*C1 = 128 -> Zo*C2 =
    64 at z = 4, 320 -> 192 at z = 5 (Zo = 3), K4's Z*C0 = 6, 3, 1 and 32,
    C1 = 8, z = 32, 33, 40 and 72, C1 = 60, 108, 25 and 12 (every slab
    padded), Z*C1 = 4320 (K2 at z = 6: 192 -> 128, on the sm90 tiles)."""
    args = _stage0_args(_gen(), 2, 20, c1, cuda, k0, z)
    fn, plain = {"k2": (bev_down.fused_conv0_down0,
                        bev_down.conv0_down0_plain),
                 "k4": (bev_head.fused_head, bev_head.head_plain)}[kernel]
    zc1, zc2 = z * c1, me_down_align(z)[2] * c1
    inst = (bev_down.down0_instance(zc1, zc2, z) if kernel == "k2" else
            bev_head.head_instance(z, k0, zc1, zc2, z))
    assert inst == ("sm90" if (kernel, z, c1) == ("k2", 6, 32) else
                    "zband" if kernel == "k2" else "window+zband")
    ops.reset_launches()
    with torch.inference_mode():
        got, m1 = fn(*args, z=z)
        want, m2 = plain(*args, z=z)
    assert torch.equal(m1, m2) and got.shape == want.shape
    _close_bf16(got, want, STAGE0_FRAC_DIFFER)
    mf = m1.repeat_interleave(c1, dim=-1)
    assert bool((got[~mf] == 0).all()) and bool((got != 0).any())
    assert fn.launches == 1 and fn.instances[inst] == 1


def _block_args(g, cin, c, xy, z, dev, b=3):
    mask = (torch.rand(b, xy, xy, z, generator=g) < 0.4).to(dev)
    x = torch.randn(b, xy, xy, z, cin, generator=g).to(dev)
    x = torch.where(mask[..., None], x, 0).reshape(b, xy, xy, z * cin)
    kw = {}
    if cin != c:
        sd, bd = _affine(g, c, z, dev)
        kw = dict(wd=fold_w2_stride1(torch.randn(1, 1, 1, cin, c,
                                                 generator=g) * (2 / cin) ** .5,
                                     z).to(dev), scale_d=sd, bias_d=bd)
    args = (x.to(torch.bfloat16), mask,
            fold_w2_stride1(torch.randn(3, 3, 3, cin, c, generator=g)
                            * (2 / (27 * cin)) ** .5, z).to(dev),
            fold_w2_stride1(torch.randn(3, 3, 3, c, c, generator=g)
                            * (2 / (27 * c)) ** .5, z).to(dev),
            *_affine(g, c, z, dev), *_affine(g, c, z, dev),
            torch.randn(3 if c == 64 else 5, generator=g).to(dev))
    return mask, args, kw


@pytest.mark.cuda
@pytest.mark.parametrize("cin,c,xy", [(64, 64, 16), (64, 128, 8),
                                      (128, 256, 8)])
def test_k3_kernel_matches_plain(cuda, cin, c, xy):
    z = 2
    mask, args, kw = _block_args(_gen(), cin, c, xy, z, cuda)
    ops.reset_launches()
    with torch.inference_mode():
        got = bev_block_sm.fused_eca_block_sm(*args, z=z, **kw)
        want = bev_block_sm.eca_block_plain(*args, z=z, **kw)
    _close_bf16(got, want, BLOCK_FRAC_DIFFER)
    mf = mask.repeat_interleave(c, dim=-1)
    assert bool((got[~mf] == 0).all())
    assert bev_block_sm.fused_eca_block_sm.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("cin,c,xy", [(64, 64, 16), (64, 128, 8),
                                      (128, 256, 8), (128, 256, 4),
                                      (256, 256, 4), (64, 128, 12)])
def test_k3_conv_phases_match_plain(cuda, cin, c, xy):
    """K3's two conv phases (TMA + wgmma) against the plain conv + BN
    epilogue, at K3's parametrisations and the 8 x 8 and 4 x 4 maps of the
    MM test (smaller than the 8 x 16 patch); 12 x 12 leaves ragged
    patches."""
    z = 2
    _, args, _ = _block_args(_gen(), cin, c, xy, z, cuda)
    x, mask, w1, w2, s1, b1, s2, b2 = args[:8]
    with torch.inference_mode():
        h = bev_block_sm.conv_phase(x, mask, w1, s1, b1, z, pool=False)
        h_want = bev_block_sm.conv_phase_plain(x, mask, w1, s1, b1, z, False)
        g, pool = bev_block_sm.conv_phase(h_want, mask, w2, s2, b2, z,
                                          pool=True)
        g_want, pool_want = bev_block_sm.conv_phase_plain(h_want, mask, w2,
                                                          s2, b2, z, True)
    _close_bf16(h, h_want, CONV_FRAC_DIFFER)
    _close_bf16(g, g_want, CONV_FRAC_DIFFER)
    assert float((pool - pool_want).abs().max()) <= \
        POOL_TOL * float(pool_want.abs().max())


@pytest.mark.cuda
def test_k3_conv_phase_reads_a_strided_x(cuda):
    """The tensor maps assume dense rows: ``conv_phase`` makes a strided x
    dense first, so it gives what the same values give contiguous."""
    z = 2
    _, args, _ = _block_args(_gen(), 64, 128, 8, z, cuda)
    x, mask, w1, _, s1, b1 = args[:6]
    strided = torch.stack([x, -x], dim=-1)[..., 0]
    assert not strided.is_contiguous()
    with torch.inference_mode():
        got = bev_block_sm.conv_phase(strided, mask, w1, s1, b1, z, False)
        want = bev_block_sm.conv_phase(x, mask, w1, s1, b1, z, False)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_k3_item_with_empty_mask_pools_exactly_zero(cuda):
    z = 2
    mask, args, kw = _block_args(_gen(), 64, 128, 8, z, cuda)
    mask[1] = False  # item 1: no occupied cell
    x = torch.where(mask.repeat_interleave(64, dim=-1), args[0], 0)
    args = (x, mask, *args[2:])
    with torch.inference_mode():
        h = bev_block_sm.conv_phase(x, mask, *args[2:3], *args[4:6], z,
                                    pool=False)
        _, pool = bev_block_sm.conv_phase(h, mask, args[3], *args[6:8], z,
                                          pool=True)
        out = bev_block_sm.fused_eca_block_sm(*args, z=z, **kw)
    assert bool((pool[1] == 0).all()) and bool((pool[0] != 0).any())
    assert bool((out[1] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("cin,c,z", [(48, 64, 2), (64, 96, 2), (32, 32, 2),
                                     (64, 64, 3), (8, 16, 5), (256, 256, 1),
                                     (24, 24, 1), (30, 60, 36), (108, 108, 4),
                                     (20, 212, 3), (5, 12, 40)])
def test_k3_kernel_matches_plain_off_its_tiles(cuda, cin, c, z):
    """Zcin = 96 (not a multiple of the 64-channel TMA slab: conv1 on the
    z-banded instance, conv2 sm90), Zcout = 192, 64, 80 (not of the
    128-channel tile: both z-banded), z = 1 (stage 2's voxel block at
    voxfe_dim), C = 24; C not a multiple of 8 (30, 60, 108, 212, 5, 12:
    every slab padded), z = 36 and 40, Z*C past 4096 (C = 212)."""
    mask, args, kw = _block_args(_gen(), cin, c, 8, z, cuda)
    inst = bev_block_sm.block_instance(z * cin, z * c, z)
    ops.reset_launches()
    with torch.inference_mode():
        got = bev_block_sm.fused_eca_block_sm(*args, z=z, **kw)
        want = bev_block_sm.eca_block_plain(*args, z=z, **kw)
    _close_bf16(got, want, BLOCK_FRAC_DIFFER)
    mf = mask.repeat_interleave(c, dim=-1)
    assert bool((got[~mf] == 0).all()) and bool((got != 0).any())
    assert bev_block_sm.fused_eca_block_sm.launches == 1
    assert bev_block_sm.fused_eca_block_sm.instances[inst] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("b,xy,k0,c1", [(2, 32, 5, 64), (3, 20, 3, 64),
                                        (3, 32, 5, 64), (5, 128, 5, 64)])
def test_k4_kernel_matches_plain(cuda, b, xy, k0, c1):
    """KITTI widths (c1=64 at z=4: Z*C1 = 256, Zo*C2 = 128) at k0 = 5 and
    3; 10 x 10 and 16 x 16 output cells leave ragged 8 x 16 patches;
    5 x 128 x 128 has 160 tiles, more than the card's SMs, so persistent
    blocks walk more than one."""
    z = 4
    args = _stage0_args(_gen(), b, xy, c1, cuda, k0)
    ops.reset_launches()
    with torch.inference_mode():
        got, m1 = bev_head.fused_head(*args, z=z)
        want, m2 = bev_head.head_plain(*args, z=z)
        k2, _ = bev_down.conv0_down0_plain(*args, z=z)
    assert torch.equal(m1, m2) and got.dtype == torch.bfloat16
    _close_bf16(got, want, STAGE0_FRAC_DIFFER)
    # K2's rounding points: the share limit above would reject them
    assert _frac_differ(got, k2) >= ROUNDING_MIN_DIFFER
    mf = m1.repeat_interleave(c1, dim=-1)
    assert bool((got[~mf] == 0).all())
    assert bev_head.fused_head.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("z,b,xy,k0,c1", [(8, 3, 20, 5, 64), (8, 2, 64, 3, 64),
                                          (16, 2, 32, 5, 64),
                                          (16, 1, 20, 3, 64),
                                          (4, 2, 32, 5, 128)])
def test_k4_kernel_matches_plain_on_wider_maps(cuda, z, b, xy, k0, c1):
    """The other presets' stage-0 widths with ``bev_pallas_head``: z = 8
    (Z*C0 = 8, Z*C1 = 512 -> Zo*C2 = 256, two N tiles), z = 16 (16, 1024
    -> 512, four N tiles), and Z*C1 = 512 at z = 4: W0 streamed through
    the ring.  K2's rounding points still differ on most outputs."""
    zo = me_down_align(z)[2]
    args = _stage0_args(_gen(), b, xy, c1, cuda, k0, z=z)
    ops.reset_launches()
    with torch.inference_mode():
        got, m1 = bev_head.fused_head(*args, z=z)
        want, m2 = bev_head.head_plain(*args, z=z)
        k2, _ = bev_down.conv0_down0_plain(*args, z=z)
    assert torch.equal(m1, m2) and got.shape[-1] == zo * c1
    _close_bf16(got, want, STAGE0_FRAC_DIFFER)
    assert _frac_differ(got, k2) >= ROUNDING_MIN_DIFFER
    mf = m1.repeat_interleave(c1, dim=-1)
    assert bool((got[~mf] == 0).all()) and bool((got != 0).any())
    assert bev_head.fused_head.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("z,c1,b,xy,k0", [(6, 24, 2, 32, 5),
                                          (40, 108, 1, 32, 5),
                                          (6, 24, 1, 20, 3),
                                          (40, 108, 1, 16, 1)])
def test_k4_window_conv0_matches_plain_at_the_widths(cuda, z, c1, b, xy, k0):
    """K4 off its sm90 tiles at the stage-0 widths of [widths]' W2 (z = 6,
    C1 = 24: every window fits 8 channels, two taps an MMA step) and W5 (z
    = 40, C1 = 108 -> 112: windows of two 8-channel blocks) on smaller
    maps, k0 = 5, 3 and 1: conv0 alone (``head_conv0``, the window GEMM)
    against its plain form, and the whole head against ``head_plain``."""
    from agplace_tpu_torch.sparse import bev_grid as bg

    args = _stage0_args(_gen(), b, xy, c1, cuda, k0, z=z)
    feats, mask = args[:2]
    assert bev_head.head_instance(z, k0, z * c1, me_down_align(z)[2] * c1,
                                  z) == "window+zband"
    w0, s0, b0 = bev_head.pad_head(*args[2:], z=z)[:3]
    ops.reset_launches()
    with torch.inference_mode():
        h = bev_head.head_conv0(feats, mask, w0, s0, b0, z=z)
        hw = bg.bev_conv2d(feats.float(), w0.float(), 1, (k0 // 2,) * 2,
                           (k0 // 2,) * 2, torch.float32)
        hw = bg.mask_bev(torch.relu(hw * s0 + b0), mask, z).to(torch.bfloat16)
        got, m1 = bev_head.fused_head(*args, z=z)
        want, m2 = bev_head.head_plain(*args, z=z)
    c18 = w0.shape[3] // z
    assert not h.reshape(b, xy, xy, z, c18)[..., c1:].any()
    _close_bf16(h, hw, STAGE0_FRAC_DIFFER)
    assert torch.equal(m1, m2)
    _close_bf16(got, want, STAGE0_FRAC_DIFFER)
    assert bev_head.fused_head.instances["window+zband"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["relu", "tanh"])
@pytest.mark.parametrize("batch", [1, 32, 128])
@pytest.mark.parametrize("dim", [520, 1024, 2048])
def test_k1_grid_kernel_matches_plain(cuda, dim, batch, act):
    """K1's grid instance (W across the shared memory of 128 co-resident
    blocks in groups of 4, two barriers a step) against its plain
    version: D = 520 (padded to 640: bands of 20 columns, 5 finished by
    each block), 1024 and 2048, B = 1, 32 and 128 (four row tiles)."""
    g = _gen()
    x = torch.randn(batch, dim, generator=g).to(cuda)
    w = (torch.randn(dim, dim, generator=g) / dim ** .5).to(cuda)
    b = (torch.randn(dim, generator=g) * 0.1).to(cuda)
    assert ode_step.ode_instance(batch, dim) == "grid"
    ops.reset_launches()
    with torch.inference_mode():
        got = ode_step.fused_euler_ode(x, w, b, 10, 0.1, act)
        again = ode_step.fused_euler_ode(x, w, b, 10, 0.1, act)
        want = ode_step.euler_ode_plain(x, w, b, 10, 0.1, act)
    torch.testing.assert_close(got, want, **K1_TOL)
    assert torch.equal(got, again)  # a fixed summation order
    assert ode_step.fused_euler_ode.instances["grid"] == 2


# K5: the stem shapes at b32 and b128 (256 px images), a ragged last band
# (50 output rows in bands of 13 on 132 SMs), rows split into column tiles
# with a one-column halo, C = 8, and the odd item count (3, 14, 12, 8)
@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c", [(2, 64, 64, 64), (3, 14, 12, 8),
                                     (32, 128, 128, 64), (128, 128, 128, 64),
                                     (32, 100, 64, 64), (1, 8, 512, 64),
                                     (2, 16, 16, 8)])
def test_k5_kernel_matches_plain(cuda, b, h, w, c):
    g = _gen()
    x = (torch.randn(b, h, w, c, generator=g) * 2).to(cuda, torch.bfloat16)
    scale = (torch.rand(c, generator=g) * 1.8 + 0.2).to(cuda)
    bias = torch.randn(c, generator=g).to(cuda)
    ops.reset_launches()
    with torch.inference_mode():
        got = stem_pool.fused_affine_relu_maxpool(x, scale, bias)
        want = stem_pool.stem_pool_plain(x, scale, bias)
        # every pre-relu value negative: exactly zero after the pool
        neg = stem_pool.fused_affine_relu_maxpool(-x.abs() - 1, scale,
                                                  -bias.abs())
    # the same fp32 multiply and add, one round, exact max: bit-equal
    assert torch.equal(got, want)
    assert bool((neg == 0).all())
    assert stem_pool.fused_affine_relu_maxpool.launches == 2


@pytest.mark.cuda
def test_k5_tiling_on_the_card_splits_rows_and_leaves_a_ragged_band(cuda):
    """The card tests' shapes above reach a ragged last band and split rows
    at this card's SM count."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    ragged = stem_pool.stem_pool_tiling(32, 100, 64, 64, sms)
    assert ragged.band * ragged.nband != 50, ragged
    assert stem_pool.stem_pool_tiling(1, 8, 512, 64, sms).ntw == 4


@pytest.mark.cuda
def test_k5_reads_a_view_at_an_odd_storage_offset(cuda):
    """A contiguous x at storage offset 1 (2 bytes past 16-byte alignment)
    is copied before the kernel's bulk copies read it."""
    g = _gen()
    b, h, w, c = 2, 32, 32, 64
    base = (torch.randn(1 + b * h * w * c, generator=g) * 2).to(
        cuda, torch.bfloat16)
    x = base[1:].view(b, h, w, c)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    scale = (torch.rand(c, generator=g) + 0.5).to(cuda)
    bias = torch.randn(c, generator=g).to(cuda)
    ops.reset_launches()
    with torch.inference_mode():
        got = stem_pool.fused_affine_relu_maxpool(x, scale, bias)
        want = stem_pool.stem_pool_plain(x, scale, bias)
    assert torch.equal(got, want)
    assert stem_pool.fused_affine_relu_maxpool.launches == 1



@pytest.mark.cuda
@pytest.mark.parametrize("c,xy", [(64, 16), (256, 8), (32, 8), (48, 12)])
def test_k6_kernel_matches_plain(cuda, c, xy, monkeypatch):
    """Z*C = 128 and 512 run the conv phases on the Hopper kernel (two
    launches of ``conv3x3_launch``), Z*C = 64 and 96 on the wmma implicit
    GEMM (none)."""
    z = 2
    mask, args, _ = _block_args(_gen(), c, c, xy, z, cuda)
    hopper = []
    launch = bev_block_sm.conv3x3_launch
    monkeypatch.setattr(bev_block_sm, "conv3x3_launch",
                        lambda *a: hopper.append(a[5]) or launch(*a))
    ops.reset_launches()
    with torch.inference_mode():
        got = bev_block.fused_eca_block(*args, z=z)
        want = bev_block.eca_block_bm_plain(*args, z=z)
        k3 = bev_block_sm.eca_block_plain(*args, z=z)
    _close_bf16(got, want, BLOCK_FRAC_DIFFER)
    # K3's rounding points: the share limit above would reject them
    assert _frac_differ(got, k3) >= ROUNDING_MIN_DIFFER
    mf = mask.repeat_interleave(c, dim=-1)
    assert bool((got[~mf] == 0).all())
    assert bev_block.fused_eca_block.launches == 1
    assert hopper == ([bev_block_sm.EPI_F32_RELU_MASK,
                       bev_block_sm.EPI_F32_POOL] if z * c % 128 == 0
                      else [])


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1, 3, 9])
@pytest.mark.parametrize("cin,c,xy", [(64, 64, 16), (64, 128, 8),
                                      (128, 256, 12), (48, 48, 10)])
def test_p1_kernel_matches_plain(cuda, chunk, cin, c, xy):
    """P1 against its plain version and against K3's plain version (the
    same rounding points); 12 x 12 and 10 x 10 maps leave ragged patches,
    and Z*C = 96 (cin = c = 48) is not a multiple of the 64-channel slab
    or the 128-channel N tile: TMA zero-fills the rest of both."""
    mask, args, kw = _block_args(_gen(), cin, c, xy, 2, cuda)
    ops.reset_launches()
    with torch.inference_mode():
        got = probe_block_sm_v2.fused_eca_block_concat(*args, z=2,
                                                       chunk=chunk, **kw)
        want = probe_block_sm_v2.eca_block_concat_plain(*args, z=2,
                                                        chunk=chunk, **kw)
        k3 = bev_block_sm.eca_block_plain(*args, z=2, **kw)
    _close_bf16(got, want, BLOCK_FRAC_DIFFER)
    _close_bf16(got, k3, BLOCK_FRAC_DIFFER)
    mf = mask.repeat_interleave(c, dim=-1)
    assert bool((got[~mf] == 0).all())
    assert probe_block_sm_v2.fused_eca_block_concat.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1, 3, 9])
@pytest.mark.parametrize("cin,c,xy", [(64, 64, 16), (128, 256, 4),
                                      (16, 16, 12), (48, 48, 10)])
def test_p1_conv_phases_match_plain(cuda, chunk, cin, c, xy):
    """P1's two conv phases (TMA + wgmma) against their plain version at
    main-path widths (Z*C 128 -> 128, 256 -> 512 on a 4 x 4 map smaller
    than the patch) and at Z*C = 32 and 96 (a K slab and an N tile partly
    zero-filled); the pool against the plain masked sum."""
    z = 2
    _, args, _ = _block_args(_gen(), cin, c, xy, z, cuda)
    x, mask, w1, w2, s1, b1, s2, b2 = args[:8]
    with torch.inference_mode():
        h = probe_block_sm_v2.concat_conv_phase(x, mask, w1, s1, b1, z,
                                                False, chunk)
        h_want = probe_block_sm_v2.concat_conv_phase_plain(
            x, mask, w1, s1, b1, z, False, chunk)
        g, pool = probe_block_sm_v2.concat_conv_phase(h_want, mask, w2, s2,
                                                      b2, z, True, chunk)
        g_want, pool_want = probe_block_sm_v2.concat_conv_phase_plain(
            h_want, mask, w2, s2, b2, z, True, chunk)
    _close_bf16(h, h_want, CONV_FRAC_DIFFER)
    _close_bf16(g, g_want, CONV_FRAC_DIFFER)
    assert float((pool - pool_want).abs().max()) <= \
        POOL_TOL * float(pool_want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("tap", range(9))
def test_p1_each_tap_alone_matches_plain(cuda, tap):
    """The weights zero but for one tap: the kernel's rows of that tap (a
    shifted view of the halo tile in shared memory) must be the plain
    conv's, alone; ragged 12 x 20 maps, two K slabs, two N tiles."""
    z = 2
    _, args, _ = _block_args(_gen(), 64, 128, 12, z, cuda)
    g = _gen()
    x = torch.randn(3, 12, 20, 128, generator=g).to(cuda, torch.bfloat16)
    mask = torch.ones(3, 12, 20, z, dtype=torch.bool, device=cuda)
    w = torch.zeros_like(args[2])
    w[tap // 3, tap % 3] = args[2][tap // 3, tap % 3]
    with torch.inference_mode():
        for chunk in (1, 3, 9):
            got = probe_block_sm_v2.concat_conv_phase(x, mask, w, *args[4:6],
                                                      z, False, chunk)
            want = probe_block_sm_v2.concat_conv_phase_plain(
                x, mask, w, *args[4:6], z, False, chunk)
            _close_bf16(got, want, CONV_FRAC_DIFFER)


@pytest.mark.cuda
def test_p1_kernel_raises_on_widths_off_its_tiles(cuda):
    _, args, _ = _block_args(_gen(), 40, 40, 8, 2, cuda)  # Z*C = 80
    with pytest.raises(ValueError, match="multiples of the kernel's tiles"):
        probe_block_sm_v2.fused_eca_block_concat(*args, z=2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,xy,c1", [(2, 32, 64), (3, 20, 8), (5, 128, 64),
                                     (3, 20, 64)])
def test_p2_kernel_matches_plain(cuda, b, xy, c1):
    """P2 against its plain version and against K2 (the same rounding
    points); 3 x 10 x 10 output cells leave a ragged last tile, 5 x 128 x
    128 has more tiles than the card's SMs.  c1 = 64 (Z*C1 = 256 -> 128)
    runs K2's Hopper main loop, c1 = 8 (32 -> 16) the wmma kernel."""
    z = 4
    args = _stage0_args(_gen(), b, xy, c1, cuda)
    ops.reset_launches()
    with torch.inference_mode():
        got, m1 = probe_down_v2.fused_down_concat(*args, z=z)
        want, m2 = probe_down_v2.down_concat_plain(*args, z=z)
        # K2's kernel where its tiles take the widths (c1 = 64), else its
        # plain version (the same rounding points)
        k2_fn = (bev_down.fused_conv0_down0 if c1 == 64
                 else bev_down.conv0_down0_plain)
        k2, m3 = k2_fn(*args, z=z)
    assert torch.equal(m1, m2) and torch.equal(m1, m3)
    assert got.dtype == torch.bfloat16
    _close_bf16(got, want, STAGE0_FRAC_DIFFER)
    _close_bf16(got, k2, STAGE0_FRAC_DIFFER)
    mf = m1.repeat_interleave(c1, dim=-1)
    assert bool((got[~mf] == 0).all())
    assert probe_down_v2.fused_down_concat.launches == 1
    assert bev_down.fused_conv0_down0.launches == int(c1 == 64)


def _offset1(t):
    """``t``'s values in a contiguous view at storage offset 1 (2 bytes
    past 16-byte alignment)."""
    base = torch.zeros(t.numel() + 1, dtype=t.dtype, device=t.device)
    v = base[1:].view(t.shape)
    v.copy_(t)
    assert v.is_contiguous() and v.data_ptr() % 16 != 0
    return v


def _stage0_case(kernel, operand, dev):
    """(kernel output, plain output) of a stage-0 wrapper with ``operand``
    at storage offset 1; bf16 weights, so the wrapper's casts keep them."""
    from agplace_tpu_torch.sparse import bev_grid as bg

    z = 4
    args = list(_stage0_args(_gen(), 2, 32, 64, dev))
    args[2], args[5] = args[2].to(torch.bfloat16), args[5].to(torch.bfloat16)
    mask = args[1]
    lo, hi, _ = me_down_align(z)
    m_out = bg.mask_down(mask, (0, 0), (0, 0), (lo, hi))
    if kernel == "k2_gemm":  # g0: conv0's output, the GEMM's A operand
        g0 = _conv0(args)
        rest = (mask, args[3], args[4], *args[5:])
        return (bev_down.down0_gemm(_offset1(g0), *rest, m_out, z=z),
                bev_down.down0_plain(g0, *rest, z=z)[0])
    if kernel == "p2_gemm":  # plane 0, the A operand's first K steps
        planes = probe_down_v2.parity_planes(args[0], args[2])
        rest = (mask, args[3], args[4], *args[5:], m_out)
        want = probe_down_v2.down_concat_gemm_plain(planes, *rest, z=z)
        planes[0] = _offset1(planes[0])
        return probe_down_v2.down_concat_gemm(planes, *rest, z=z), want
    fn, plain = {"k2": (bev_down.fused_conv0_down0,
                        bev_down.conv0_down0_plain),
                 "k4": (bev_head.fused_head, bev_head.head_plain),
                 "p2": (probe_down_v2.fused_down_concat,
                        probe_down_v2.down_concat_plain)}[kernel]
    want = plain(*args, z=z)[0]
    i = {"feats": 0, "wd": 5}[operand]
    args[i] = _offset1(args[i])
    return fn(*args, z=z)[0], want


def _block_case(kernel, operand, dev):
    """(kernel output, plain output) of an ECA-block wrapper with
    ``operand`` at storage offset 1; bf16 weights."""
    z = 2
    cin, c = {"k3": (64, 64), "k3_ds": (64, 128), "k6": (64, 64),
              "k6_narrow": (32, 32), "p1": (64, 64)}[kernel]
    _, args, kw = _block_args(_gen(), cin, c, 8, z, dev)
    args = [a.to(torch.bfloat16) if i in (2, 3) else a
            for i, a in enumerate(args)]
    kw = {k: v.to(torch.bfloat16) if k == "wd" else v for k, v in kw.items()}
    fn, plain = {"k3": (bev_block_sm.fused_eca_block_sm,
                        bev_block_sm.eca_block_plain),
                 "k3_ds": (bev_block_sm.fused_eca_block_sm,
                           bev_block_sm.eca_block_plain),
                 "k6": (bev_block.fused_eca_block,
                        bev_block.eca_block_bm_plain),
                 "k6_narrow": (bev_block.fused_eca_block,
                               bev_block.eca_block_bm_plain),
                 "p1": (probe_block_sm_v2.fused_eca_block_concat,
                        probe_block_sm_v2.eca_block_concat_plain)}[kernel]
    want = plain(*args, z=z, **kw)
    if operand == "wd":
        kw["wd"] = _offset1(kw["wd"])
    else:
        i = {"x": 0, "w1": 2}[operand]
        args[i] = _offset1(args[i])
    return fn(*args, z=z, **kw), want


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,operand", [
    ("k2", "wd"), ("k2_gemm", "g0"), ("k3", "x"), ("k3", "w1"),
    ("k3_ds", "x"), ("k3_ds", "wd"), ("k4", "feats"), ("k4", "wd"),
    ("k6", "x"), ("k6", "w1"), ("k6_narrow", "w1"), ("p1", "x"),
    ("p1", "w1"), ("p2", "wd"), ("p2_gemm", "g")])
def test_wrapper_reads_operands_at_an_odd_storage_offset(cuda, kernel,
                                                         operand):
    """An operand read by 16-byte vectors, cp.async or TMA, given as a
    contiguous view at storage offset 1, is copied to an aligned one
    (``_build.aligned``): the result is the plain version's, within the
    wrapper's tolerance, and the context stays usable."""
    stage0 = kernel in ("k2", "k2_gemm", "k4", "p2", "p2_gemm")
    with torch.inference_mode():
        got, want = (_stage0_case if stage0 else _block_case)(
            kernel, operand, cuda)
        torch.cuda.synchronize()
    frac = (STAGE0_FRAC_DIFFER if stage0 else BLOCK_FRAC_DIFFER)
    _close_bf16(got, want, frac)


@pytest.mark.cuda
def test_cuda_input_needing_grad_raises(cuda):
    x = torch.randn(4, 256, device=cuda, requires_grad=True)
    w = torch.randn(256, 256, device=cuda)
    with pytest.raises(RuntimeError, match="forward-only"):
        ode_step.fused_euler_ode(x, w, torch.zeros(256, device=cuda))


@pytest.mark.cuda
def test_mm_forward_on_card_counts_kernels_and_matches_cpu(cuda):
    from agplace_tpu_torch.infer import build_towers

    cfg = kitti360_config()
    mm_cfg = dataclasses.replace(cfg.model.mm, vox_grid_extent=(32, 32, 4))
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, mm=mm_cfg, compute_dtype="bfloat16"))
    mm, _ = build_towers(cfg, "cpu", _gen())
    g = _gen()
    img = torch.randn(2, 64, 64, 3, generator=g)
    mask = torch.rand(2, 32, 32, 4, generator=g) < 0.3
    with torch.inference_mode():
        want = mm(img, BEVGrid(feats=mask.float(), mask=mask, z=4))
        mm.to(cuda)
        ops.reset_launches()
        got = mm(img.to(cuda), BEVGrid(feats=mask.float().to(cuda),
                                       mask=mask.to(cuda), z=4))
    assert ops.launches() == {"fused_euler_ode": 3, "fused_conv0_down0": 1,
                              "fused_eca_block_sm": 4, "fused_head": 0,
                              "fused_affine_relu_maxpool": 0,
                              "fused_eca_block": 0,
                              "fused_eca_block_concat": 0,
                              "fused_down_concat": 0}
    for k, v in want.items():
        err = float((got[k].cpu() - v).abs().max())
        assert err <= 5e-2 * float(v.abs().max()), (k, err)


@pytest.mark.cuda
def test_fused_mm_forward_on_card_counts_kernels_and_matches_cpu(cuda):
    """``bev_pallas_head`` + ``stem_pallas``: K4 replaces K2, K5 runs in
    the stem; K1 and K3 as in the default configuration."""
    from agplace_tpu_torch.infer import build_towers

    cfg = kitti360_config()
    mm_cfg = dataclasses.replace(cfg.model.mm, vox_grid_extent=(32, 32, 4),
                                 bev_pallas_head=True, stem_pallas=True)
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, mm=mm_cfg, compute_dtype="bfloat16"))
    mm, _ = build_towers(cfg, "cpu", _gen())
    g = _gen()
    img = torch.randn(2, 64, 64, 3, generator=g)
    mask = torch.rand(2, 32, 32, 4, generator=g) < 0.3
    with torch.inference_mode():
        want = mm(img, BEVGrid(feats=mask.float(), mask=mask, z=4))
        mm.to(cuda)
        ops.reset_launches()
        got = mm(img.to(cuda), BEVGrid(feats=mask.float().to(cuda),
                                       mask=mask.to(cuda), z=4))
    assert ops.launches() == {"fused_euler_ode": 3, "fused_conv0_down0": 0,
                              "fused_eca_block_sm": 4, "fused_head": 1,
                              "fused_affine_relu_maxpool": 1,
                              "fused_eca_block": 0,
                              "fused_eca_block_concat": 0,
                              "fused_down_concat": 0}
    for k, v in want.items():
        err = float((got[k].cpu() - v).abs().max())
        assert err <= 5e-2 * float(v.abs().max()), (k, err)


@pytest.mark.cuda
@pytest.mark.parametrize("head", [False, True])
@pytest.mark.parametrize("preset,z", [("nuscenes", 8), ("synthetic", 16)])
def test_mm_forward_of_other_presets_on_card(cuda, preset, z, head):
    """The MM forward of nuscenes_config() (and the default config's z = 8)
    and synthetic_config() (z = 16) at their full widths, the BEV grid cut
    to 32 x 32 cells: K2 takes their stage 0 (Zo*C2 = 256 and 512), or K4
    with ``bev_pallas_head`` set; every kernel of the path launches as
    often as the forward calls it, and the embeddings match the CPU run of
    the same module."""
    from agplace_tpu_torch.infer import build_towers

    cfg = nuscenes_config() if preset == "nuscenes" else synthetic_config()
    assert cfg.model.mm.vox_grid_extent[2] == z
    mm_cfg = dataclasses.replace(cfg.model.mm, vox_grid_extent=(32, 32, z),
                                 bev_pallas_head=head)
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, mm=mm_cfg, compute_dtype="bfloat16"))
    mm, _ = build_towers(cfg, "cpu", _gen())
    g = _gen()
    img = torch.randn(2, 64, 64, 3, generator=g)
    mask = torch.rand(2, 32, 32, z, generator=g) < 0.3
    with torch.inference_mode():
        want = mm(img, BEVGrid(feats=mask.float(), mask=mask, z=z))
        mm.to(cuda)
        ops.reset_launches()
        got = mm(img.to(cuda), BEVGrid(feats=mask.float().to(cuda),
                                       mask=mask.to(cuda), z=z))
    assert ops.launches() == {"fused_euler_ode": 3,
                              "fused_conv0_down0": int(not head),
                              "fused_eca_block_sm": 4,
                              "fused_head": int(head),
                              "fused_affine_relu_maxpool": 0,
                              "fused_eca_block": 0,
                              "fused_eca_block_concat": 0,
                              "fused_down_concat": 0}
    for k, v in want.items():
        err = float((got[k].cpu() - v).abs().max())
        assert err <= 5e-2 * float(v.abs().max()), (k, err)


@pytest.mark.cuda
def test_nuscenes_fused_mm_forward_at_its_full_grid(cuda):
    """nuscenes_config() with ``bev_pallas_head`` set at its full 128 x 128
    x 8 grid, one query: K4 takes the z = 8 stage 0 on the main path, with
    exact launch counts, and the embedding matches the CPU run."""
    from agplace_tpu_torch.infer import build_towers

    cfg = nuscenes_config()
    mm_cfg = dataclasses.replace(cfg.model.mm, bev_pallas_head=True)
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, mm=mm_cfg, compute_dtype="bfloat16"))
    assert cfg.model.mm.vox_grid_extent == (128, 128, 8)
    mm, _ = build_towers(cfg, "cpu", _gen())
    g = _gen()
    img = torch.randn(1, 64, 64, 3, generator=g)
    mask = torch.rand(1, 128, 128, 8, generator=g) < 0.05
    with torch.inference_mode():
        want = mm(img, BEVGrid(feats=mask.float(), mask=mask, z=8))
        mm.to(cuda)
        ops.reset_launches()
        got = mm(img.to(cuda), BEVGrid(feats=mask.float().to(cuda),
                                       mask=mask.to(cuda), z=8))
    counts = ops.launches()
    assert counts == dict(counts, fused_head=1, fused_conv0_down0=0,
                          fused_eca_block_sm=4, fused_euler_ode=3)
    assert sum(counts.values()) == 8
    for k, v in want.items():
        err = float((got[k].cpu() - v).abs().max())
        assert err <= 5e-2 * float(v.abs().max()), (k, err)


def _integer_world(seed=1):
    """Small-integer rows: every distance and product is an exact integer
    in fp32 whatever the summation order, so ties are exact on any device.
    (queries, gallery, exact sq distances, exact inner products)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    g = rng.integers(-2, 3, (300, 8)).astype(np.float32)
    q = np.concatenate([rng.integers(-2, 3, (13, 8)), g[[3, 3, 17]]]).astype(
        np.float32)
    qi, gi = q.astype(np.int64), g.astype(np.int64)
    return q, g, ((qi[:, None] - gi[None]) ** 2).sum(-1), qi @ gi.T


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 20, 300, 310])
def test_topk_ties_lowest_index_first_on_card(cuda, k):
    """``l2_topk`` / ``ip_topk`` on CUDA tensors: equal values lowest index
    first (``lax.top_k``'s order), also across the k-th place and with
    k > N padding; the same as on the CPU."""
    import numpy as np

    from agplace_tpu_torch.retrieval import knn

    q, g, d2, ip = _integer_world()
    cols = np.arange(g.shape[0])
    kk = min(k, g.shape[0])
    for fn, vals in (("l2_topk", d2), ("ip_topk", -ip)):
        want = np.stack([np.lexsort((cols, r)) for r in vals])[:, :kk]
        d, i = getattr(knn, fn)(torch.from_numpy(q).to(cuda),
                                torch.from_numpy(g).to(cuda), k)
        d_cpu, i_cpu = getattr(knn, fn)(torch.from_numpy(q),
                                        torch.from_numpy(g), k)
        assert d.is_cuda and i.is_cuda
        np.testing.assert_array_equal(i.cpu().numpy()[:, :kk], want)
        np.testing.assert_array_equal(i.cpu().numpy(), i_cpu.numpy())
        np.testing.assert_array_equal(d.cpu().numpy(), d_cpu.numpy())
        assert (i.cpu().numpy()[:, kk:] == -1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 12, 50])
def test_ascending_topk_on_card_equals_cpu(cuda, k):
    """The top-k's two routes on the card: rows whose tie straddles the
    k-th place (row 1 one value throughout, rows 3 and 4 few distinct
    values) and rows where it does not, and k = N; the same indices and
    value bits as on the CPU and as numpy's stable argsort."""
    import numpy as np

    from agplace_tpu_torch.retrieval import knn

    rng = np.random.default_rng(7)
    v = rng.standard_normal((6, 50)).astype(np.float32)
    v[:, :4] = [np.inf, -np.inf, -0.0, 0.0]
    v[1] = 1.0
    v[3] = v[3, rng.integers(0, 8, 50)]
    v[4] = v[4, rng.integers(0, 25, 50)]
    vals, idx = knn._ascending_topk(torch.from_numpy(v.copy()).to(cuda), k)
    vals_cpu, idx_cpu = knn._ascending_topk(torch.from_numpy(v.copy()), k)
    assert vals.is_cuda and idx.is_cuda
    np.testing.assert_array_equal(idx.cpu().numpy(), idx_cpu.numpy())
    np.testing.assert_array_equal(vals.cpu().numpy().view(np.int32),
                                  vals_cpu.numpy().view(np.int32))
    np.testing.assert_array_equal(
        idx_cpu.numpy(),
        np.argsort(v + np.float32(0.0), axis=1, kind="stable")[:, :k])


@pytest.mark.cuda
def test_evaluate_on_card_matches_cpu(cuda):
    """``evaluate`` of ``synthetic_config()`` in bf16 on the card: exact
    launch counts (4 aerial-tower and 2 MM forwards at batch 4), the
    descriptors against the CPU run of the same towers, and the card's
    search against the CPU's on the card's descriptors (the same indices
    wherever neighbouring distances are apart, the same recalls)."""
    import copy

    import numpy as np

    from agplace_tpu_torch.data.synthetic import SyntheticDataset
    from agplace_tpu_torch.evaluate import evaluate, extract_features, \
        search
    from agplace_tpu_torch.infer import build_towers, make_infer_fns
    from agplace_tpu_torch.retrieval.recall import compute_recalls

    cfg = synthetic_config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                compute_dtype="bfloat16"))
    cpu = build_towers(cfg, "cpu", _gen())
    card = [copy.deepcopy(t).to(cuda) for t in cpu]
    ds = SyntheticDataset(n_db=16, n_q=7, n_points=2000, seed=0)
    ops.reset_launches()
    recalls, _ = evaluate(cfg, ds, *make_infer_fns(*card), device=cuda)
    assert ops.launches() == {"fused_euler_ode": 6, "fused_conv0_down0": 2,
                              "fused_eca_block_sm": 8, "fused_head": 0,
                              "fused_affine_relu_maxpool": 0,
                              "fused_eca_block": 0,
                              "fused_eca_block_concat": 0,
                              "fused_down_concat": 0}
    assert np.isfinite(recalls).all() and (np.diff(recalls) >= 0).all()
    q, db = extract_features(cfg, ds, *make_infer_fns(*card), cuda)
    q_cpu, db_cpu = extract_features(cfg, ds, *make_infer_fns(*cpu), "cpu")
    for got, want in ((q, q_cpu), (db, db_cpu)):
        assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max()
    d, i = search(q, db, 16, cuda)
    d_cpu, i_cpu = search(q, db, 16, "cpu")
    tol = 1e-5 * np.abs(d_cpu).max()
    gap = np.diff(d_cpu, axis=1) > tol
    apart = np.ones(i.shape, bool)
    apart[:, 1:] &= gap
    apart[:, :-1] &= gap
    np.testing.assert_array_equal(i[apart], i_cpu[apart])
    assert np.abs(d - d_cpu).max() <= tol
    np.testing.assert_array_equal(
        compute_recalls(i, ds.soft_positives_per_query, (1, 5, 10))[0],
        compute_recalls(i_cpu, ds.soft_positives_per_query, (1, 5, 10))[0])


@pytest.mark.cuda
def test_k2_and_k3_take_fp32_feats_as_their_bf16(cuda):
    """The fp32 model's eval (mining, evaluation) hands K2 and K3 fp32
    feats; they take them in bf16, as JAX's kernels do
    (``ops/pallas/bev_down.py``, ``bev_block_sm.py``: ``x.astype(bf16)``):
    the same outputs as for the bf16 feats."""
    args = _stage0_args(_gen(), 2, 32, 64, cuda)
    _, bargs, kw = _block_args(_gen(), 64, 128, 8, 2, cuda)
    with torch.inference_mode():
        want = bev_down.fused_conv0_down0(*args, z=4)
        got = bev_down.fused_conv0_down0(args[0].float(), *args[1:], z=4)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        want = bev_block_sm.fused_eca_block_sm(*bargs, z=2, **kw)
        got = bev_block_sm.fused_eca_block_sm(bargs[0].float(), *bargs[1:],
                                              z=2, **kw)
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["relu", "tanh", "sigmoid", "id"])
@pytest.mark.parametrize("b", [1, 33])
def test_k1_function_grads_match_autograd_on_card(cuda, act, b):
    """K1's Function (the kernel forward, JAX's backward) against autograd
    through the plain version, fp32 on the card; a direct call still
    counts its forward launch only."""
    g = _gen()
    x = torch.randn(b, 256, generator=g).to(cuda).requires_grad_()
    w = (torch.randn(256, 256, generator=g) / 16).to(cuda).requires_grad_()
    bias = (torch.randn(256, generator=g) * .1).to(cuda).requires_grad_()
    cot = torch.randn(b, 256, generator=g).to(cuda)
    ops.reset_launches()
    y = ode_step.euler_ode(x, w, bias, 10, 0.1, act)
    got = torch.autograd.grad(y, (x, w, bias), cot)
    assert ops.launches()["fused_euler_ode"] == 1
    y_p = ode_step.euler_ode_plain(x, w, bias, 10, 0.1, act)
    want = torch.autograd.grad(y_p, (x, w, bias), cot)
    for a, e in zip((y, *got), (y_p, *want)):
        e = e.detach()
        assert float((a.detach() - e).abs().max()) <= 1e-4 * float(
            e.abs().max())


@pytest.mark.cuda
def test_train_step_on_card_runs_k1_only_and_matches_cpu(cuda):
    """One train step of a small preset on the card: launches K1 3 (one
    MM forward), K2-K6 0; the loss within 5e-3 of the CPU step's with the
    same weights and batch (bf16 BEV convs on both)."""
    import numpy as np

    from agplace_tpu_torch.data.base import collate_train
    from agplace_tpu_torch.data.pipeline import prefetch_to_device
    from agplace_tpu_torch.data.synthetic import SyntheticDataset
    from agplace_tpu_torch.train.mining import TripletMiner
    from agplace_tpu_torch.train.step import init_state, make_train_step

    cfg = synthetic_config(batch_size=2, image_size=32, vox_max_points=128)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, pretrained=False))
    ds = SyntheticDataset(n_db=24, n_q=16, image_size=32, seed=0)
    rng = np.random.default_rng(0)
    host = collate_train(ds, TripletMiner(cfg, ds, "cpu").mine_random(rng, 2),
                         cfg, rng)
    card, cpu = init_state(cfg, cuda), init_state(cfg, "cpu")
    cpu.mm.load_state_dict(card.mm.state_dict())
    cpu.db.load_state_dict(card.db.state_dict())
    step = make_train_step(cfg)
    (batch,) = prefetch_to_device([host], cuda)
    ops.reset_launches()
    loss = float(step(card, batch)["loss"])
    counts = ops.launches()
    assert counts == {**dict.fromkeys(counts, 0), "fused_euler_ode": 3}
    (cbatch,) = prefetch_to_device([host], "cpu")
    want = float(step(cpu, cbatch)["loss"])
    assert np.isfinite(loss) and abs(loss - want) <= 5e-3 * abs(want)


@pytest.mark.cuda
@pytest.mark.parametrize("nq,n,c", [(1, 8, 256), (8, 4096, 256),
                                    (33, 1003, 100)])
def test_int8_search_on_card_equals_cpu(cuda, nq, n, c):
    """``knn.int8_cross`` (cuBLASLt's int8 GEMM behind ``torch._int_mm``,
    the queries padded to > 16 rows) equals the CPU's int32 product, and a
    search-only ``PlaceIndex(quant="int8")`` on the card (its rows and
    columns padded to multiples of 8) returns the CPU index's distances
    and indices."""
    import numpy as np

    from agplace_tpu_torch.retrieval import knn
    from agplace_tpu_torch.serving import PlaceIndex

    rng = np.random.default_rng(nq + n)
    g = rng.standard_normal((n, c)).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    q = g[rng.choice(n, nq)] + 0.05 * rng.standard_normal(
        (nq, c)).astype(np.float32)
    q_i8, _ = knn.quantize_queries(torch.from_numpy(q))
    db_i8 = torch.from_numpy(knn.quantize_rows(g)[0])
    want = knn.int8_cross(q_i8, db_i8) if n % 8 == c % 8 == 0 else None
    if want is not None:
        got = knn.int8_cross(q_i8.to(cuda), db_i8.to(cuda))
        assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)
    card = PlaceIndex(None, device=cuda, quant="int8")
    cpu = PlaceIndex(None, device="cpu", quant="int8")
    for idx in (card, cpu):
        idx.add_descriptors(g)
    for k in (1, 5, n + 2):
        d, i = card.search_descriptors(q, k)
        d_cpu, i_cpu = cpu.search_descriptors(q, k)
        np.testing.assert_array_equal(i, i_cpu)
        np.testing.assert_array_equal(d, d_cpu)


# ---- the MM's option tail: no new kernel, the card against the CPU ------
@pytest.mark.cuda
def test_device_geometry_on_card_is_sync_free_and_equals_cpu(cuda):
    """``quantize`` .. ``build_neighbor_table`` queue no host sync on the
    card, and their integer outputs equal the CPU's."""
    from agplace_tpu_torch.sparse import voxels

    g = _gen()
    pts = (torch.rand(4, 3000, 3, generator=g) - 0.5) * 200.0
    outs = []
    for dev in (cuda, torch.device("cpu")):
        p = pts.to(dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            sv = voxels.quantize(p, 2.0, 1024)
            svs, keys = voxels.sort_by_key(sv)
            oc, om = voxels.downsample_coords(svs, 2)
            table = voxels.build_neighbor_table(
                svs, keys, oc, om, voxels.kernel_offsets(2, 1, dev))
        finally:
            if dev.type == "cuda":
                torch.cuda.set_sync_debug_mode(0)
        outs.append([t.cpu() for t in (sv.coords, sv.mask, keys, oc, om,
                                       table)])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("over", [
    dict(voxfe_backend="dense", voxfe_ntd=1, voxfe_block="basic"),
    dict(voxfe_backend="sparse", voxfe_block="aspp"),
    dict(voxfe_ntd=2, voxfe_block="convnext", drop="pc"),
    dict(ode=dict(method="dopri5"), final_fusetype="cat")])
def test_option_tail_mm_on_card_matches_cpu(cuda, over):
    """The MM of a small preset with an option of the tail: the card's
    embedding within the smoke's SLICE_TOL of the CPU's, no BEV kernel on
    the dense and sparse backends, dopri5's accepted steps equal."""
    from agplace_tpu_torch.data.voxels import prepare_query_vox
    from agplace_tpu_torch.infer import build_towers
    from agplace_tpu_torch.models.fusion import FCODE

    cfg = synthetic_config(image_size=64, vox_max_points=512)
    over = dict(over)
    if "ode" in over:
        over["ode"] = dataclasses.replace(cfg.model.mm.ode, **over["ode"])
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, compute_dtype="bfloat16",
        mm=dataclasses.replace(cfg.model.mm, **over)))
    mm, _ = build_towers(cfg, "cpu", _gen())
    cpu_mm = copy.deepcopy(mm)
    mm.to(cuda)
    g = _gen()
    img = torch.randn(2, 64, 64, 3, generator=g)
    pts = ((torch.rand(2, 2000, 3, generator=g) - 0.5) * 40.0).numpy()
    with torch.inference_mode():
        ops.reset_launches()
        got = mm(img.to(cuda), prepare_query_vox(cfg, pts, cuda))
        torch.cuda.synchronize()
        counts = ops.launches()
        want = cpu_mm(img, prepare_query_vox(cfg, pts, "cpu"))
    e, w = got["embedding"].float().cpu(), want["embedding"]
    assert float((e - w).abs().max()) <= 5e-2 * float(w.abs().max())
    if cfg.model.mm.voxfe_backend != "bev":
        assert counts["fused_conv0_down0"] == counts[
            "fused_eca_block_sm"] == 0
    steps = [[int(f.accepted_steps) for f in m.modules()
              if isinstance(f, FCODE) and f.accepted_steps is not None]
             for m in (mm, cpu_mm)]
    assert steps[0] == steps[1]


# ---- the ResNet epilogue kernel (ops/bn_act.py) ---------------------------

def _bn_act_maps():
    """Each embed cell of the benchmark: its batch and its ResNet-18
    trunk's maps [H, W, C] (``resnet18_epilogues`` at its image size), the
    stem conv's, then layer1-3's."""
    from agplace_tpu_torch.ops import bn_act
    from portbench.harness import cell as cells

    out = {}
    for w in cells.benchmark()["workloads"]:
        c = cells.load(w["name"])
        if c.mix == "embed":
            epis = bn_act.resnet18_epilogues(*c.params["image_hw"])
            out[c.name] = (c.params["batch"],
                           list(dict.fromkeys(m for m, _ in epis)))
    return out


BN_ACT_MAPS = _bn_act_maps()


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _bn_act_operands(shape, dtype, dev, seed=0):
    """A conv map and a residual with NaN, -0.0 and +0.0 planted, and two
    fp32 affines, a third of the scales negative."""
    g = torch.Generator(device=dev).manual_seed(seed)
    c = shape[-1]

    def fmap():
        x = (torch.randn(shape, generator=g, device=dev) * 3).to(dtype)
        flat = x.view(-1)
        if flat.numel():
            idx = torch.randint(0, flat.numel(), (300,), generator=g,
                                device=dev)
            flat[idx[:100]] = float("nan")
            flat[idx[100:200]] = -0.0
            flat[idx[200:]] = 0.0
        return x

    def affine():
        return (torch.rand(c, generator=g, device=dev) * 2 - 0.7,
                torch.randn(c, generator=g, device=dev))

    return fmap(), affine(), fmap(), affine()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("level", ["stem", "layer1", "layer2", "layer3"])
@pytest.mark.parametrize("cell", list(BN_ACT_MAPS))
def test_bn_act_is_bit_equal_to_the_eager_chain(cuda, cell, level, dtype):
    """Each instance against the eager chain (``bn_act_plain``, PyTorch's
    own kernels on the card), raw bits, at the cells' full maps; written
    into a new tensor and over the conv's map."""
    from agplace_tpu_torch.ops import bn_act

    batch, maps = BN_ACT_MAPS[cell]
    h, w, c = maps[["stem", "layer1", "layer2", "layer3"].index(level)]
    x, (s, b), r, raff = _bn_act_operands((batch, h, w, c), dtype, cuda)
    bn_act.fused_bn_act.launches = 0
    with torch.inference_mode():
        for res, ra in ((None, None), (r, None), (r, raff)):
            want = bn_act.bn_act_plain(x, s, b, res, ra)
            assert torch.equal(_bits(bn_act.fused_bn_act(x, s, b, res, ra)),
                               _bits(want))
            y = x.clone()
            bn_act.fused_bn_act(y, s, b, res, ra, out=y)
            assert torch.equal(_bits(y), _bits(want))
            del want, y
    assert bn_act.fused_bn_act.launches == 6


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bn_act_at_ragged_widths(cuda, dtype):
    """C = 24 / 264 (3 and 33 vectors a pixel in bf16: the grid rounds up
    to a whole channel stride) on maps too small to fill the card, and an
    empty map (no launch)."""
    from agplace_tpu_torch.ops import bn_act

    bn_act.fused_bn_act.launches = 0
    with torch.inference_mode():
        for shape in ((3, 17, 9, 64), (2, 33, 7, 24), (1, 5, 3, 264),
                      (0, 4, 4, 64)):
            x, (s, b), r, raff = _bn_act_operands(shape, dtype, cuda, 1)
            for res, ra in ((None, None), (r, None), (r, raff)):
                got = bn_act.fused_bn_act(x, s, b, res, ra)
                want = bn_act.bn_act_plain(x, s, b, res, ra)
                assert torch.equal(_bits(got), _bits(want)), shape
    assert bn_act.fused_bn_act.launches == 9


def _misaligned(x):
    """A dense view of x one element past 16-byte alignment."""
    flat = torch.cat([x.new_zeros(1), x.flatten()])
    return flat[1:].view(x.shape)


# (case, the conv's map, the residual): maps the kernel does not take
BN_ACT_REFUSED = {
    "not dense": lambda x, r: (x.transpose(1, 2), r.transpose(1, 2)),
    "misaligned": lambda x, r: (_misaligned(x), r),
    "misaligned residual": lambda x, r: (x, _misaligned(r)),
    "C % 8": lambda x, r: (x[..., :12].contiguous(),
                           r[..., :12].contiguous()),
    "fp16": lambda x, r: (x.half(), r.half()),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(BN_ACT_REFUSED))
def test_bn_act_raises_on_maps_it_cannot_take(cuda, case):
    """The wrapper, and an eval block's epilogue through it, raise on the
    card: no eager chain runs there behind the gate's back."""
    from agplace_tpu_torch.models.norm import BatchNorm2D
    from agplace_tpu_torch.models.resnet import epilogue
    from agplace_tpu_torch.ops import bn_act

    x, _, r, _ = _bn_act_operands((2, 6, 6, 16), torch.bfloat16, cuda)
    x, r = BN_ACT_REFUSED[case](x, r)
    bn = BatchNorm2D(x.shape[-1]).to(cuda).eval()
    bn_act.fused_bn_act.launches = 0
    with torch.inference_mode():
        with pytest.raises(ValueError, match="must be dense, 16-byte"):
            bn_act.fused_bn_act(x, *bn.affine(), r)
        with pytest.raises(ValueError, match="must be dense, 16-byte"):
            epilogue(False, x, bn, r)
    assert bn_act.fused_bn_act.launches == 0


def _random_trunk(arch, dtype, dev):
    from agplace_tpu_torch.models.norm import BatchNorm2D
    from agplace_tpu_torch.models.resnet import ResNetFeatures

    g = _gen()
    m = ResNetFeatures(arch, 3, dtype)
    with torch.no_grad():
        for p in m.parameters():
            if p.dim() == 4:
                p.copy_(torch.randn(p.shape, generator=g)
                        * (2.0 / p[0].numel()) ** 0.5)
        for mod in m.modules():
            if isinstance(mod, BatchNorm2D):
                c = mod.weight.numel()
                mod.weight.copy_(torch.rand(c, generator=g) * 2 - 0.7)
                mod.bias.copy_(torch.randn(c, generator=g))
                mod.running_mean.copy_(torch.randn(c, generator=g) * 0.3)
                mod.running_var.copy_(torch.rand(c, generator=g) + 0.5)
    return m.to(dev).eval()


# (arch, input batch and size): resnet18 at the KITTI-360 query's size,
# resnet50 (the Bottleneck's three epilogues) at a smaller one
BN_ACT_TRUNKS = {"resnet18": (8, 256, 959), "resnet50": (4, 128, 160)}
BN_ACT_EPILOGUES = {"resnet18": 1 + 6 * 2, "resnet50": 1 + 13 * 3}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("arch", list(BN_ACT_TRUNKS))
def test_eval_trunk_is_identical_with_the_gate_open_and_shut(cuda, arch,
                                                             dtype,
                                                             monkeypatch):
    """A whole eval trunk's maps, bit for bit, with every epilogue on the
    kernel and with the gate forced shut (the wrapper swapped for the
    eager chain, written where the kernel writes)."""
    from agplace_tpu_torch.ops import bn_act

    m = _random_trunk(arch, dtype, cuda)
    n, h, w = BN_ACT_TRUNKS[arch]
    x = torch.randn(n, h, w, 3, generator=_gen()).to(cuda)
    k = bn_act.fused_bn_act
    k.launches = 0
    with torch.inference_mode():
        got, maps = m(x)
    assert k.launches == BN_ACT_EPILOGUES[arch]
    monkeypatch.setattr(bn_act, "fused_bn_act",
                        lambda x, *a, out: out.copy_(
                            bn_act.bn_act_plain(x, *a)))
    with torch.inference_mode():
        want, wmaps = m(x)
    assert k.launches == BN_ACT_EPILOGUES[arch]
    for a, b in zip([got, *maps], [want, *wmaps]):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
def test_bn_act_kernel_names_land_in_no_class_of_the_profile_reader(cuda):
    """The instances as the profiler names them on the card: each holds
    ``KERNEL_NAME`` and matches none of the benchmark's hand-kernel or conv
    patterns, so its time reads as ``other``."""
    import re

    from torch.profiler import ProfilerActivity, profile

    from agplace_tpu_torch.ops import bn_act
    from portbench.harness import profiling
    from portbench.mixes.embed import CONV_KERNELS

    names = set()
    for _ in range(4):  # the tracer on the card may drop events
        for dtype in (torch.bfloat16, torch.float32):
            x, (s, b), r, raff = _bn_act_operands((2, 8, 8, 64), dtype,
                                                  cuda)
            with torch.inference_mode(), profile(
                    activities=[ProfilerActivity.CUDA]) as prof:
                for res, ra in ((None, None), (r, None), (r, raff)):
                    bn_act.fused_bn_act(x, s, b, res, ra)
                torch.cuda.synchronize()
            names |= {e.name for e in prof.events()
                      if bn_act.KERNEL_NAME in e.name}
        if len(names) == 6:
            break
    assert len(names) == 6, names
    for name in names:
        assert not profiling.HAND.search(name)
        assert not any(re.search(p, name) for p in profiling.KERNEL.values())
        assert not re.search(CONV_KERNELS, name)
        assert profiling.classify(name) == "other", name


# ---- CCT's attention kernel (ops/attention.py; its check's shapes, margins
# and row error are that module's) -------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("b,n", attention.CHECK_SHAPES)
def test_attention_kernel_is_as_near_fp32_as_the_eager_chain(cuda, b, n):
    g = torch.Generator(device=cuda).manual_seed(b * 1000 + n)
    qkv = (torch.randn(b, n, 3, 6, 64, generator=g, device=cuda)
           * 1.5).to(torch.bfloat16)
    with torch.inference_mode():
        before = attention.fused_attention.launches
        got = attention.fused_attention(qkv)
        assert attention.fused_attention.launches == before + 1
        chain = attention.attention_plain(qkv)
        exact = attention.attention_plain(qkv.float())
    torch.cuda.synchronize()
    assert got.shape == (b, n, 6, 64) and got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got).all())
    k_err, c_err = (attention.row_err(got, exact),
                    attention.row_err(chain, exact))
    assert k_err[0] <= attention.ERR_MARGIN * c_err[0], (k_err, c_err)
    assert k_err[1] <= attention.ERR_MARGIN * c_err[1], (k_err, c_err)
    assert attention.row_err(got, chain.float())[0] < attention.ERR_APART


@pytest.mark.cuda
def test_attention_kernel_reads_each_image_alone(cuda):
    """A batch row's output does not change with its neighbours: TMA stops
    at N, so no key of the next image leaks into a ragged tail."""
    qkv = torch.randn(4, 100, 3, 6, 64, device=cuda).to(torch.bfloat16)
    with torch.inference_mode():
        whole = attention.fused_attention(qkv)
        for i in range(4):
            alone = attention.fused_attention(qkv[i:i + 1].clone())
            assert torch.equal(alone, whole[i:i + 1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fp32", "fp16", "d = 32", "not dense"])
def test_attention_wrapper_raises_on_the_card(cuda, case):
    qkv = torch.randn(2, 9, 3, 6, 64, device=cuda)
    qkv = {"fp32": qkv, "fp16": qkv.half(),
           "d = 32": qkv[..., :32].contiguous().to(torch.bfloat16),
           "not dense": qkv.to(torch.bfloat16).transpose(0, 1)}[case]
    before = attention.fused_attention.launches
    with torch.inference_mode(), pytest.raises(ValueError,
                                               match="must be bf16"):
        attention.fused_attention(qkv)
    assert attention.fused_attention.launches == before


@pytest.mark.cuda
def test_cct_bf16_inference_launches_the_kernel_once_a_layer(cuda):
    from agplace_tpu_torch.models.cct import CCT

    m = CCT((64, 64), dtype=torch.bfloat16).to(cuda).eval()
    with torch.no_grad():
        for p in m.parameters():
            p.normal_(0.0, 0.02)
    x = torch.randn(2, 64, 64, 3, device=cuda)
    before = attention.fused_attention.launches
    with torch.inference_mode():
        tokens, pooled = m(x)
    torch.cuda.synchronize()
    assert attention.fused_attention.launches == before + 14
    assert bool(torch.isfinite(pooled).all())
    m2 = CCT((64, 64)).to(cuda).eval()  # fp32: the eager einsums
    m2.load_state_dict(m.state_dict())
    with torch.inference_mode():
        m2(x)
    assert attention.fused_attention.launches == before + 14
