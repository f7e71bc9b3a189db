"""K5's and K6's launch geometry, replayed on the CPU, and K5's entry checks.

The kernels themselves run only on the card (``test_torch_port_cuda.py``).
What surrounds them is Python that runs here:

* ``stem_pool_tiling`` / ``stem_pool_unit`` (K5): the units' bands, halo
  rows, column tiles (with their one-column left halo) and channel tiles,
  replayed row by row through a ring slot as the kernel streams them, with
  the kernel's arithmetic (the affine once per loaded element, the left tap
  from the neighbour's odd column, the vertical max over rows 2r-1, 2r,
  2r+1), reproduce ``stem_pool_plain`` bit for bit; each input row is read
  once per band and tile, the band's top halo row twice, and each output
  is written once;
* ``conv3x3_tiling`` / ``conv3x3_coords`` (the TMA boxes of the Hopper conv
  kernel) replay K6's two conv phases, with K6's fp32 epilogues, at K6's
  widths;
* K5's wrapper rejects a ``scale`` or ``bias`` that is not [C] before any
  dispatch, and ``_build.aligned`` copies what a kernel would read
  misaligned.
"""

import numpy as np
import pytest
import torch

from agplace_tpu_torch.ops import _build, bev_block, bev_block_sm, stem_pool
from tests.test_torch_port_ops import _tma_box

_BF16 = torch.bfloat16


def _stem_inputs(b, h, w, c, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, h, w, c)) * 2.0).to(_BF16)
    # negative scales too: the kernel's arithmetic does not depend on them
    scale = torch.from_numpy(rng.uniform(-1.0, 2.0, c).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(c).astype(np.float32))
    return x, scale, bias


def _replay_stem(x, scale, bias, t):
    """K5 as the kernel runs it, unit by unit and row by row, through a
    NaN-filled ring slot: a read of anything the unit did not load shows."""
    b, h, w, c = x.shape
    s, bi = scale.to(_BF16).float(), bias.to(_BF16).float()
    out = torch.full((b, h // 2, w // 2, c), float("nan"))
    writes = torch.zeros(b, h // 2, w // 2, c, dtype=torch.int32)
    reads = torch.zeros(b, h, dtype=torch.int32)
    slot_cols = t.slot // (t.ct * 16)
    for u in range(t.units):
        n = stem_pool.stem_pool_unit(t, h, w, c, u)
        tw, ct, halo = n["tw"], n["ct"], n["halo"]
        ncols = n["c_hi"] - n["c_lo"] + 1
        col0 = n["c_lo"] - (2 * n["ow0"] - halo)
        assert 0 <= n["i0"] <= n["i1"] < h and 0 <= n["c_lo"] <= n["c_hi"] < w
        assert col0 >= 0 and col0 + ncols <= slot_cols
        assert tw * ct <= stem_pool.ROW_POSITIONS
        ch = slice(n["cv0"] * 8, (n["cv0"] + ct) * 8)

        def affine(v):  # bf16(relu(x*s + b)): an fp32 multiply, an add
            return torch.relu(v.float() * s[ch] + bi[ch]).to(_BF16).float()

        carry = torch.zeros(tw, ct * 8)  # the zero pad above row 0
        cur = torch.zeros(tw, ct * 8)
        for i in range(n["i0"], n["i1"] + 1):
            reads[n["b"], i] += 1
            slot = torch.full((slot_cols, t.ct * 8), float("nan"),
                              dtype=_BF16)
            slot[col0:col0 + ncols, :ct * 8] = x[n["b"], i,
                                                 n["c_lo"]:n["c_hi"] + 1, ch]
            cols = halo + 2 * torch.arange(tw)  # input column 2 ow
            ye = affine(slot[cols, :ct * 8])
            yo = affine(slot[cols + 1, :ct * 8])
            left0 = (affine(slot[0, :ct * 8]) if n["ow0"] > 0
                     else torch.zeros(ct * 8))  # halo column or pad
            left = torch.cat([left0[None], yo[:-1]])  # neighbours' odd
            hm = torch.maximum(torch.maximum(ye, yo), left)
            if i % 2:
                if i > 2 * n["r0"]:
                    r = (i - 1) // 2
                    out[n["b"], r, n["ow0"]:n["ow0"] + tw, ch] = \
                        torch.maximum(cur, hm)
                    writes[n["b"], r, n["ow0"]:n["ow0"] + tw, ch] += 1
                carry = hm
            else:
                cur = torch.maximum(carry, hm)
    return out, writes, reads


# (B, H, W, C, SMs): the b32 main path at an eighth of its batch on 16
# SMs (the same 16-row bands), a ragged last band (50 output rows in bands
# of 15), rows split into column tiles (with a ragged last tile), the card
# test's shape, C = 8 split rows, channel tiles, both at once
STEM_SHAPES = [(4, 128, 128, 64, 16), (3, 100, 64, 64, 10),
               (1, 8, 512, 64, 132), (1, 8, 260, 64, 2),
               (3, 14, 12, 8, 132), (2, 6, 1030, 8, 2),
               (2, 6, 6, 2056, 1), (1, 4, 20, 4104, 1)]


@pytest.mark.parametrize("b,h,w,c,sms", STEM_SHAPES)
def test_k5_tiling_replay_matches_plain(b, h, w, c, sms):
    x, scale, bias = _stem_inputs(b, h, w, c)
    t = stem_pool.stem_pool_tiling(b, h, w, c, sms)
    got, writes, reads = _replay_stem(x, scale, bias, t)
    want = stem_pool.stem_pool_plain(x, scale, bias)
    assert torch.equal(got.to(_BF16), want)
    assert bool((writes == 1).all())
    # every input row once per column and channel tile; the top halo row
    # of every band but the first twice
    halo = torch.zeros(h, dtype=torch.int32)
    halo[2 * t.band * torch.arange(1, t.nband) - 1] = 1
    assert torch.equal(reads, ((1 + halo) * t.ntw * t.nct).expand(b, h))


def test_k5_tiling_at_the_main_path_shapes():
    """On 132 SMs: b32 in 128 bands of 16 rows (one block each), b128 in
    512 bands of 16 over 264 blocks, one query in 64 bands of one row;
    whole 16 KB rows, no column tiles."""
    t32 = stem_pool.stem_pool_tiling(32, 128, 128, 64, 132)
    t128 = stem_pool.stem_pool_tiling(128, 128, 128, 64, 132)
    assert t32.args() == (8, 1, 64, 1, 16, 4, 128, 16384, 128)
    assert stem_pool.stem_pool_tiling(1, 128, 128, 64, 132).units == 64
    assert t128.args() == (8, 1, 64, 1, 16, 4, 512, 16384, 264)
    # the kernel's C entry: 4 pointers, B H W C, the fields, the stream
    assert len(_build._SIGNATURES["agp_stem_pool"]) == 4 + 4 + 9 + 1
    split = stem_pool.stem_pool_tiling(1, 8, 512, 64, 132)
    assert (split.tw, split.ntw, split.slot) == (64, 4, 129 * 8 * 16)


@pytest.mark.parametrize("which,shape", [("scale", (63,)), ("bias", (65,)),
                                         ("scale", (1, 64)), ("bias", ())])
def test_k5_raises_on_scale_or_bias_not_of_width_c(which, shape):
    x = torch.zeros(1, 8, 8, 64, dtype=_BF16)
    args = {"scale": torch.ones(64), "bias": torch.zeros(64)}
    args[which] = torch.ones(shape)
    with pytest.raises(ValueError, match="must be \\[64\\]"):
        stem_pool.fused_affine_relu_maxpool(x, args["scale"], args["bias"])


def test_aligned_copies_a_misaligned_view():
    base = torch.arange(1 + 2 * 8 * 8, dtype=torch.float32).to(_BF16)
    view = base[1:].view(2, 8, 8)  # contiguous, at storage offset 1
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    got = _build.aligned(view)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, view)
    dense = torch.zeros(4, 8)
    assert _build.aligned(dense) is dense
    strided = dense.t()
    assert _build.aligned(strided).is_contiguous()


def _replay_conv(x, w, t):
    """The Hopper conv kernel's accumulator, block by block and K step by K
    step from its TMA boxes (``conv3x3_coords``), in float64."""
    b, xd, yd, zci = x.shape
    zco = int(w.shape[3])
    wm = w.double().reshape(9 * zci, zco)
    xd64 = x.double()
    acc = torch.full((b, xd, yd, zco), float("nan"), dtype=torch.float64)
    for blk in range(t.grid):
        tile = torch.zeros(128, 128, dtype=torch.float64)
        for step in range(t.steps):
            xc, wcs = bev_block_sm.conv3x3_coords(t, blk, step)
            a = _tma_box(xd64, xc, t.x_box).reshape(128, 64)
            tile += a @ torch.cat([_tma_box(wm, wc, t.w_box) for wc in wcs],
                                  dim=1)
        (_, y0, x0, bb), ((n0, _), _) = bev_block_sm.conv3x3_coords(t, blk,
                                                                    0)
        x0, y0 = x0 + 1, y0 + 1
        nx, ny = min(8, xd - x0), min(16, yd - y0)
        acc[bb, x0:x0 + nx, y0:y0 + ny, n0:n0 + 128] = \
            tile.reshape(8, 16, 128)[:nx, :ny]
    return acc


# K6's two shapes at a reduced batch ([32,64,64,128] and [32,16,16,512]),
# and Z*C = 128 on a map smaller than a patch
@pytest.mark.parametrize("b,xy,zc", [(1, 64, 128), (1, 16, 512),
                                     (2, 8, 128)])
def test_k6_conv_tiling_replays_both_phases(b, xy, zc):
    """K6's conv phases on the Hopper kernel (instances 2 and 3): the
    replayed accumulator through K6's fp32 epilogues (the affine on the
    unrounded sum with unrounded scale and bias) gives
    ``bm_conv_phase_plain`` exactly; small-integer inputs keep every sum
    exact in any order, so only the epilogue's rounding is compared."""
    z = 2
    g = torch.Generator().manual_seed(0)
    x = torch.randint(-2, 3, (b, xy, xy, zc), generator=g).to(_BF16)
    mask = torch.rand(b, xy, xy, z, generator=g) < 0.5
    w1, w2 = (torch.randint(-2, 3, (3, 3, zc, zc), generator=g).float()
              for _ in range(2))
    s = torch.rand(zc, generator=g) + 0.5
    bi = torch.randn(zc, generator=g) * 0.1
    t = bev_block_sm.conv3x3_tiling(b, xy, xy, zc, zc)
    assert t.grid == b * -(-xy // 8) * -(-xy // 16) * (zc // 128)
    mzc = mask.repeat_interleave(zc // z, dim=-1).float()
    # phase 1 (STORE_F32_RELU_MASK): bf16(relu(acc*s + b) * mask)
    acc = _replay_conv(x, w1, t).float()
    h = (torch.relu(acc * s + bi) * mzc).to(_BF16)
    assert torch.equal(h, bev_block.bm_conv_phase_plain(x, mask, w1, s, bi,
                                                        z, pool=False))
    # phase 2 (STORE_F32_POOL): g = bf16(acc*s + b), the pool sums the
    # rounded g over the mask (the kernel's atomics add in another order)
    acc = _replay_conv(x, w2, t).float()
    g2 = (acc * s + bi).to(_BF16)
    want_g, want_sums = bev_block.bm_conv_phase_plain(x, mask, w2, s, bi, z,
                                                      pool=True)
    assert torch.equal(g2, want_g)
    torch.testing.assert_close((g2.float() * mzc).sum(dim=(1, 2)),
                               want_sums, rtol=1e-5, atol=1e-3)
    assert bev_block_sm.EPI_F32_RELU_MASK == 2
    assert bev_block_sm.EPI_F32_POOL == 3
