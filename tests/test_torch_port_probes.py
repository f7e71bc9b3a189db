"""The probe kernels of the port, P1 and P2, and their A/B entry points, on
the CPU.

* P2 (``ops/probe_down_v2.py``): the plain version against the JAX probe
  kernel (``scripts/probe_down_v2.py:make_v2``, Pallas in interpret mode),
  and against K2's plain version; the four parity convs against the strided
  slices of the full-resolution conv0;
* P1 (``ops/probe_block_sm_v2.py``): the plain version against the JAX
  probe kernel (``scripts/probe_block_sm_v2.py:make_v2(chunk)``) at chunks
  1, 3 and 9 with both residuals, and against K3's plain version;
* the entry points ``scripts/probe_torch_{down,block_sm}_v2.py``: ``run()``
  on the CPU at a small batch, and their JSON record.

The JAX probe scripts are loaded by path and run unedited.  The kernels
against their plain versions on the card are in ``test_torch_port_cuda.py``.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from agplace_tpu.sparse import bev_grid as jax_bev
from agplace_tpu_torch import ops
from agplace_tpu_torch.data.voxels import me_down_align
from agplace_tpu_torch.ops import (bev_block_sm, bev_down, probe_block_sm_v2,
                                   probe_down_v2)
from agplace_tpu_torch.sparse import bev_grid as bg
from tests.test_torch_port_ops import _k2_inputs, _k3_inputs, _t

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
# P1 and K3 round at the same points; only the conv's fp32 sum order
# differs (nine per-tap products against chunked ones), so isolated bf16
# ulp flips remain, and a flip in conv1's output moves many conv2 sums
# (0.02-0.05 of the non-zero outputs at these sizes; the card's limit for
# the ECA blocks is 0.15).
BLOCK_FRAC_DIFFER = 0.15
# P1 against its JAX probe kernel: the same products in the same groups,
# each summed in fp32 (bit-equal was seen at every case below); at most
# 1e-3 of the elements may differ, by at most 1e-2 of the output's scale.
PROBE_FRAC_DIFFER = 1e-3


def _load_jax_probe(name):
    """``scripts/<name>.py`` as a module (loading it only defines
    constants and functions)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _probe_entry(name):
    if SCRIPTS not in sys.path:
        sys.path.insert(0, SCRIPTS)
    return importlib.import_module(name)


def _frac_differ(got, want):
    """Share of the outputs either leaves non-zero on which they differ."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    live = (got != 0) | (want != 0)
    return float((got != want).sum()) / max(int(live.sum()), 1)


def _close_ulp(got, want, frac_differ):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert _frac_differ(got, want) <= frac_differ
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


# --------------------------------------------------------------------- P2
def _p2_args(xy, z, c0, c1, k0, b=2):
    feats, mask, k0w, kdw, s0, b0, sd, bd = _k2_inputs(xy, z, c0, c1, k0, b)
    targs = (_t(feats, torch.bfloat16), torch.from_numpy(mask),
             bg.fold_w2_stride1(_t(k0w), z), _t(s0), _t(b0),
             bg.fold_w2_k2s2(_t(kdw), z), _t(sd), _t(bd))
    jargs = (jnp.asarray(feats, jnp.bfloat16), jnp.asarray(mask),
             jax_bev.fold_w2_stride1(jnp.asarray(k0w), z), jnp.asarray(s0),
             jnp.asarray(b0), jax_bev.fold_w2_k2s2(jnp.asarray(kdw), z),
             jnp.asarray(sd), jnp.asarray(bd))
    return targs, jargs


@pytest.mark.parametrize("xy,z,c0,c1,k0", [(16, 4, 1, 8, 5),
                                           (16, 3, 2, 8, 3)])
def test_p2_plain_matches_jax_probe(xy, z, c0, c1, k0):
    targs, jargs = _p2_args(xy, z, c0, c1, k0)
    want, m_want = _load_jax_probe("probe_down_v2").make_v2()(*jargs, z=z)
    ops.reset_launches()
    got, m_got = probe_down_v2.fused_down_concat(*targs, z=z)
    assert got.dtype == torch.bfloat16
    assert probe_down_v2.fused_down_concat.launches == 0
    np.testing.assert_array_equal(m_got.numpy(), np.asarray(m_want))
    # conv0 is exact (bf16 weights over a bf16 grid, one term per tap),
    # the wide affine rounds where the probe's does, and the one K=4*Z*C1
    # product sums the same terms: bit-equal
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    mf = np.repeat(m_got.numpy(), got.shape[-1] // me_down_align(z)[2],
                   axis=-1)
    assert np.all(got.float().numpy()[~mf] == 0)


@pytest.mark.parametrize("xy,z,c0,c1,k0", [(16, 4, 1, 8, 5),
                                           (12, 2, 3, 8, 3),
                                           (16, 3, 1, 16, 5)])
def test_p2_parity_planes_are_strided_full_conv(xy, z, c0, c1, k0):
    """Plane 2*px + py is the 'same' stride-1 conv0 at the cells
    (2*xo + px, 2*yo + py), bit for bit: an off-by-one in the asymmetric
    padding would shift a parity and keep every shape."""
    targs, _ = _p2_args(xy, z, c0, c1, k0)
    feats, w0 = targs[0], targs[2]
    h = k0 // 2
    full = bg.bev_conv2d(feats, w0, 1, (h, h), (h, h))
    planes = probe_down_v2.parity_planes(feats, w0)
    assert len(planes) == 4
    for p, plane in enumerate(planes):
        px, py = divmod(p, 2)
        assert plane.shape == (2, xy // 2, xy // 2, z * c1)
        assert torch.equal(plane, full[:, px::2, py::2])


@pytest.mark.parametrize("xy,z,c0,c1,k0", [(16, 4, 1, 8, 5),
                                           (16, 2, 3, 16, 3)])
def test_p2_plain_matches_k2_plain(xy, z, c0, c1, k0):
    """Same rounding points as K2, and conv0 is exact: equal on the CPU."""
    targs, _ = _p2_args(xy, z, c0, c1, k0)
    got, m_got = probe_down_v2.down_concat_plain(*targs, z=z)
    want, m_want = bev_down.conv0_down0_plain(*targs, z=z)
    assert torch.equal(m_got, m_want)
    assert torch.equal(got, want)


def test_jax_probe_conv0_kernel_is_one_z_tap_short():
    """``probe_down_v2.py:185`` draws conv0 as [5, 5, z0=4, 1, C1]; the
    fold reads z tap 4, which JAX clamps to tap 3 and torch refuses.  The
    port's entry point draws the model's [5, 5, 5, 1, C1] instead."""
    k = np.random.default_rng(0).standard_normal((5, 5, 4, 1, 8)) \
        .astype(np.float32)
    w0 = np.asarray(jax_bev.fold_w2_stride1(jnp.asarray(k), 4))
    # output z 0 reads input z 2 through tap 4 (zi = zo + t - 2)
    np.testing.assert_array_equal(w0[:, :, 2, 0:8], k[:, :, 3, 0])
    with pytest.raises(IndexError):
        bg.fold_w2_stride1(_t(k), 4)


# --------------------------------------------------------------------- P1
def _p1_args(ds, z=2, xy=8, b=2):
    cin, c = (32, 64) if ds else (32, 32)
    x, mask, k1, k2, kd, w_eca, aff = _k3_inputs(z, cin, c, xy, b)
    (s1, b1), (s2, b2), (sd, bd) = aff
    targs = (_t(x, torch.bfloat16), torch.from_numpy(mask),
             bg.fold_w2_stride1(_t(k1), z), bg.fold_w2_stride1(_t(k2), z),
             _t(s1), _t(b1), _t(s2), _t(b2), _t(w_eca))
    jargs = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(mask),
             jax_bev.fold_w2_stride1(jnp.asarray(k1), z),
             jax_bev.fold_w2_stride1(jnp.asarray(k2), z), jnp.asarray(s1),
             jnp.asarray(b1), jnp.asarray(s2), jnp.asarray(b2),
             jnp.asarray(w_eca))
    tkw, jkw = {}, {}
    if ds:
        tkw = dict(wd=bg.fold_w2_stride1(_t(kd), z), scale_d=_t(sd),
                   bias_d=_t(bd))
        jkw = dict(wd=jax_bev.fold_w2_stride1(jnp.asarray(kd), z),
                   scale_d=jnp.asarray(sd), bias_d=jnp.asarray(bd))
    return targs, tkw, jargs, jkw, mask, c


@pytest.mark.parametrize("ds", [False, True], ids=["identity", "downsample"])
@pytest.mark.parametrize("chunk", [1, 3, 9])
def test_p1_plain_matches_jax_probe(chunk, ds):
    targs, tkw, jargs, jkw, mask, c = _p1_args(ds)
    want = _load_jax_probe("probe_block_sm_v2").make_v2(chunk)(
        *jargs, z=2, **jkw)
    ops.reset_launches()
    got = probe_block_sm_v2.fused_eca_block_concat(*targs, z=2, chunk=chunk,
                                                   **tkw)
    assert got.dtype == torch.bfloat16
    assert probe_block_sm_v2.fused_eca_block_concat.launches == 0
    _close_ulp(got.float().numpy(), want, PROBE_FRAC_DIFFER)
    mf = np.repeat(mask, c, axis=-1)
    assert np.all(got.float().numpy()[~mf] == 0)


@pytest.mark.parametrize("ds", [False, True], ids=["identity", "downsample"])
@pytest.mark.parametrize("chunk", [1, 3, 9])
def test_p1_plain_matches_k3_plain(chunk, ds):
    targs, tkw, _, _, _, _ = _p1_args(ds, xy=12, b=3)
    got = probe_block_sm_v2.eca_block_concat_plain(*targs, z=2, chunk=chunk,
                                                   **tkw)
    want = bev_block_sm.eca_block_plain(*targs, z=2, **tkw)
    assert got.shape == want.shape and got.dtype == want.dtype
    _close_ulp(got.float().numpy(), want.float().numpy(), BLOCK_FRAC_DIFFER)


def test_p1_chunks_agree_closely():
    """The chunk changes only how the nine fp32 tap products are grouped
    before they are summed."""
    targs, tkw, _, _, _, _ = _p1_args(True)
    outs = [probe_block_sm_v2.eca_block_concat_plain(*targs, z=2, chunk=ch,
                                                     **tkw).float().numpy()
            for ch in (1, 3, 9)]
    for o in outs[1:]:
        _close_ulp(o, outs[0], BLOCK_FRAC_DIFFER)


@pytest.mark.parametrize("chunk", [0, 2, 4])
def test_p1_raises_on_chunk_outside_1_3_9(chunk):
    targs, tkw, _, _, _, _ = _p1_args(False)
    with pytest.raises(ValueError, match="chunk"):
        probe_block_sm_v2.fused_eca_block_concat(*targs, z=2, chunk=chunk,
                                                 **tkw)


# ------------------------------------------------------------ entry points
KEYS = {"v1_shipped", "v2_concat", "max_abs", "frac_differ", "card",
        "calls"}


@pytest.mark.parametrize("chunk", [None, 1, 3, 9], ids=["down", "block-1",
                                                        "block-3",
                                                        "block-9"])
def test_probe_entry_point_runs_on_cpu(chunk):
    """``run()`` on the CPU: the plain versions, small batch, no times."""
    if chunk is None:
        rec = _probe_entry("probe_torch_down_v2").run("cpu", batch=2,
                                                      n_points=3000)
        keys, limit = KEYS, 1e-3
    else:
        rec = _probe_entry("probe_torch_block_sm_v2").run(
            "cpu", chunk=chunk, batch=2, n_points=3000)
        keys, limit = KEYS | {"chunk"}, BLOCK_FRAC_DIFFER
        assert rec["chunk"] == chunk
    assert set(rec) == keys
    assert rec["v1_shipped"] is None and rec["v2_concat"] is None
    assert rec["card"] == "cpu" and rec["calls"] == {"v1": 1, "v2": 1}
    assert np.isfinite(rec["max_abs"]) and rec["frac_differ"] <= limit
    assert json.loads(json.dumps(rec)) == rec


@pytest.mark.parametrize("name,argv", [("probe_torch_down_v2", []),
                                       ("probe_torch_block_sm_v2",
                                        ["--chunk", "9"])])
def test_probe_entry_point_refuses_without_card(name, argv, monkeypatch,
                                                capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", [name, *argv])
    with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
        _probe_entry(name).main()
    assert capsys.readouterr().out == ""
