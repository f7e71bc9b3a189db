"""The fused-stem / fused-head serving configuration of the port, on the CPU.

Three config flags select it: ``bev_pallas_head`` (K4, ``ops/bev_head.py``,
in place of K2 at the BEV stage-0 site), ``stem_pallas`` and
``db.stem_pallas`` (K5, ``ops/stem_pool.py``, in the MM and aerial ResNet
stems).  K6 (``ops/bev_block.py``) has no model path, as in JAX.

* op tests: each plain version against the JAX Pallas kernel, run as the
  JAX tests run it on the CPU (interpret mode), from the same numpy inputs;
* routing: each flag sends its module to the new wrapper (a spy), with
  JAX's gates; the parameter tree and the weight bridge do not change;
* the slice: the bf16 MM (7 keys) and DBVanilla2D with the flags set
  against JAX's fused configuration, with ``_pallas_backend_ok`` patched to
  True as the JAX package's own tests do (that turns on JAX's K3 too).

The kernels against their plain versions on the card are in
``test_torch_port_cuda.py``.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from agplace_tpu.models.dbvanilla2d import DBVanilla2D as JaxDB
from agplace_tpu.models.mm import MM as JaxMM
from agplace_tpu.ops.pallas import bev_block as jax_block
from agplace_tpu.ops.pallas import bev_head as jax_head
from agplace_tpu.ops.pallas import stem_pool as jax_stem
from agplace_tpu.sparse import bev_grid as jax_bev
from agplace_tpu_torch import ops
from agplace_tpu_torch.data.voxels import me_down_align
from agplace_tpu_torch.models.dbvanilla2d import DBVanilla2D
from agplace_tpu_torch.models.mm import MM
from agplace_tpu_torch.ops import bev_block, bev_down, bev_head, stem_pool
from agplace_tpu_torch.sparse import bev_grid as bg
from agplace_tpu_torch.utils.convert import (jax_to_state_dict,
                                             load_jax_variables)
from tests.test_torch_port_ops import _affine, _grid
from tests.test_torch_port_slice import (KEYS, TOL_BF16, _cfg, _close,
                                         _points, _randomize, _tgrid)

torch.set_num_threads(1)

B, IMG = 2, 64


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _close_ulp(got, want, frac_differ):
    """Same rounding points, fp32 sums in another order: any difference is
    an isolated bf16 ulp flip.  At most ``frac_differ`` of the elements may
    differ, by at most 1e-2 of the output's scale.  (K2's rounding, held
    against K4's, differs in ~30 % of the elements: this bound tells the
    two apart, a plain elementwise tolerance would not.)"""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    diff = got != want
    assert diff.mean() <= frac_differ, diff.mean()
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


# --------------------------------------------------------------------- K4
def _k4_inputs(xy, z, c0, c1, k0):
    rng = np.random.default_rng(xy + z + k0)
    feats, mask = _grid(rng, 2, xy, z, c0)
    k0w = (rng.standard_normal((k0, k0, k0, c0, c1)) * 0.2).astype(np.float32)
    kdw = (rng.standard_normal((2, 2, 2, c1, c1)) * 0.2).astype(np.float32)
    zo = me_down_align(z)[2]
    return (feats, mask, k0w, kdw, *_affine(rng, c1, z),
            *_affine(rng, c1, zo))


@pytest.mark.parametrize("xy,z,c0,c1,k0",
                         [(32, 4, 1, 16, 5), (16, 2, 3, 8, 3),
                          (32, 3, 1, 16, 5), (32, 1, 2, 8, 3)])
def test_k4_head_plain_matches_pallas(xy, z, c0, c1, k0):
    feats, mask, k0w, kdw, s0, b0, sd, bd = _k4_inputs(xy, z, c0, c1, k0)
    jargs = (jnp.asarray(feats, jnp.bfloat16), jnp.asarray(mask),
             jax_bev.fold_w2_stride1(jnp.asarray(k0w), z), jnp.asarray(s0),
             jnp.asarray(b0), jax_bev.fold_w2_k2s2(jnp.asarray(kdw), z),
             jnp.asarray(sd), jnp.asarray(bd))
    want, m_want = jax_head.fused_head(*jargs, z=z)
    targs = (_t(feats, torch.bfloat16), torch.from_numpy(mask),
             bg.fold_w2_stride1(_t(k0w), z), _t(s0), _t(b0),
             bg.fold_w2_k2s2(_t(kdw), z), _t(sd), _t(bd))
    ops.reset_launches()
    got, m_got = bev_head.fused_head(*targs, z=z)
    assert got.dtype == torch.bfloat16 and bev_head.fused_head.launches == 0
    # the output mask is the ME z pairing zp = (zi + lo_z) // 2
    np.testing.assert_array_equal(m_got.numpy(), np.asarray(m_want))
    _close_ulp(got.float().numpy(), want, frac_differ=1e-3)
    zo = me_down_align(z)[2]
    mf = np.repeat(m_got.numpy(), got.shape[-1] // zo, axis=-1)
    assert np.all(got.float().numpy()[~mf] == 0)
    # K2's plain version rounds elsewhere: it would fail the bound above
    k2, _ = bev_down.conv0_down0_plain(*targs, z=z)
    assert (k2.float().numpy() != np.asarray(want, np.float32)).mean() > 0.05


def test_k4_gate_raises():
    feats, mask, k0w, kdw, s0, b0, sd, bd = _k4_inputs(16, 2, 3, 8, 3)
    args = [_t(feats, torch.bfloat16), torch.from_numpy(mask),
            bg.fold_w2_stride1(_t(k0w), 2), _t(s0), _t(b0),
            bg.fold_w2_k2s2(_t(kdw), 2), _t(sd), _t(bd)]
    with pytest.raises(ValueError, match="need ME padding"):
        bev_head.fused_head(args[0][:, :14, :14], args[1][:, :14, :14],
                            *args[2:], z=2)  # 14 / 2 = 7 is odd: padded
    k7 = bg.fold_w2_stride1(torch.zeros(7, 7, 7, 3, 8), 2)
    with pytest.raises(ValueError, match="odd and <= 5"):
        bev_head.fused_head(args[0], args[1], k7, *args[3:], z=2)


# --------------------------------------------------------------------- K5
@pytest.mark.parametrize("b,h,w,c", [(4, 32, 32, 64), (2, 16, 16, 128),
                                     (3, 16, 16, 64), (1, 8, 8, 32),
                                     (2, 14, 12, 8), (16, 16, 16, 8)])
def test_k5_stem_pool_plain_matches_pallas(b, h, w, c):
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((b, h, w, c)) * 2.0, jnp.bfloat16)
    scale = rng.uniform(0.2, 2.0, (c,)).astype(np.float32)
    bias = rng.standard_normal((c,)).astype(np.float32)
    want = jax_stem.fused_affine_relu_maxpool(x, jnp.asarray(scale),
                                              jnp.asarray(bias))
    ops.reset_launches()
    got = stem_pool.fused_affine_relu_maxpool(
        _t(x, torch.bfloat16), _t(scale), _t(bias))
    assert got.shape == (b, h // 2, w // 2, c) and got.dtype == torch.bfloat16
    # identical taps, one fp32 affine, one round: bit-equal
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    assert stem_pool.fused_affine_relu_maxpool.launches == 0


def test_k5_negative_bias_pools_to_zero():
    """Every pre-relu value negative: each real tap clamps to 0, so the
    zero pad standing in for -inf must leave exactly 0 everywhere."""
    x = np.full((2, 8, 8, 32), -3.0, np.float32)
    scale = np.ones(32, np.float32)
    bias = np.full(32, -1.0, np.float32)
    want = jax_stem.fused_affine_relu_maxpool(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale), jnp.asarray(bias))
    got = stem_pool.stem_pool_plain(_t(x, torch.bfloat16), _t(scale),
                                    _t(bias))
    assert np.all(np.asarray(want, np.float32) == 0)
    assert bool((got == 0).all())


@pytest.mark.parametrize("h,w", [(7, 8), (8, 9)])
def test_k5_odd_size_raises(h, w):
    with pytest.raises(ValueError, match="must be even"):
        stem_pool.fused_affine_relu_maxpool(
            torch.zeros(1, h, w, 32, dtype=torch.bfloat16), torch.ones(32),
            torch.zeros(32))


# --------------------------------------------------------------------- K6
@pytest.mark.parametrize("z,c,xy", [(2, 64, 16), (4, 32, 8), (1, 128, 16),
                                    (2, 32, 8), (2, 48, 8)])
def test_k6_block_plain_matches_pallas(z, c, xy):
    """Z*C = 128 (the widths of the Hopper conv instances) and 64, 96 (the
    wmma implicit GEMM's) on the card."""
    rng = np.random.default_rng(0)
    b = 2
    mask = rng.random((b, xy, xy, z)) < 0.3
    x = np.where(mask[..., None], rng.standard_normal((b, xy, xy, z, c)),
                 0).reshape(b, xy, xy, z * c).astype(np.float32)
    k1, k2 = ((rng.standard_normal((3, 3, 3, c, c)) * np.sqrt(2 / (27 * c)))
              .astype(np.float32) for _ in range(2))
    w_eca = rng.standard_normal(3 if c < 128 else 5).astype(np.float32)
    (s1, b1), (s2, b2) = _affine(rng, c, z), _affine(rng, c, z)
    want = jax_block.fused_eca_block(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(mask),
        jax_bev.fold_w2_stride1(jnp.asarray(k1), z),
        jax_bev.fold_w2_stride1(jnp.asarray(k2), z), jnp.asarray(s1),
        jnp.asarray(b1), jnp.asarray(s2), jnp.asarray(b2),
        jnp.asarray(w_eca), z=z)
    ops.reset_launches()
    got = bev_block.fused_eca_block(
        _t(x, torch.bfloat16), torch.from_numpy(mask),
        bg.fold_w2_stride1(_t(k1), z), bg.fold_w2_stride1(_t(k2), z),
        _t(s1), _t(b1), _t(s2), _t(b2), _t(w_eca), z=z)
    assert got.dtype == torch.bfloat16
    # measured: <= 8 of 65,536 elements differ, by <= 2e-3 of scale
    _close_ulp(got.float().numpy(), want, frac_differ=1e-3)
    mf = np.repeat(mask, c, axis=-1)
    assert np.all(got.float().numpy()[~mf] == 0)
    assert bev_block.fused_eca_block.launches == 0


def test_k6_identity_residual_only():
    x = torch.zeros(1, 4, 4, 64, dtype=torch.bfloat16)
    mask = torch.zeros(1, 4, 4, 2, dtype=torch.bool)
    w1 = torch.zeros(3, 3, 64, 128)
    w2 = torch.zeros(3, 3, 128, 128)
    with pytest.raises(ValueError, match="identity residual only"):
        bev_block.fused_eca_block(x, mask, w1, w2, *[torch.ones(128)] * 4,
                                  torch.ones(3), z=2)


# ----------------------------------------------------------------- routing
def _fused(cfg, on=True):
    mm = dataclasses.replace(cfg.model.mm, bev_pallas_head=on,
                             stem_pallas=on)
    db = dataclasses.replace(cfg.model.db, stem_pallas=on)
    return cfg.replace(model=dataclasses.replace(cfg.model, mm=mm, db=db))


@pytest.fixture
def spies(monkeypatch):
    """Count calls of the stage-0 and stem wrappers (the real ones run)."""
    calls = {}
    for mod, name in ((bev_head, "fused_head"),
                      (bev_down, "fused_conv0_down0"),
                      (stem_pool, "fused_affine_relu_maxpool")):
        real = getattr(mod, name)
        calls[name] = 0

        def spy(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    return calls


def _run_mm(cfg, dtype):
    rng = np.random.default_rng(1)
    img = torch.from_numpy(rng.standard_normal((B, IMG, IMG, 3)).astype(
        np.float32))
    mask = torch.from_numpy(rng.random((B, *cfg.model.mm.vox_grid_extent))
                            < 0.3)
    mm = MM(cfg.model.mm, dtype=dtype).eval()
    from agplace_tpu_torch.infer import init_weights

    init_weights(mm, torch.Generator().manual_seed(0))
    with torch.inference_mode():
        return mm(img, bg.BEVGrid(feats=mask.float(), mask=mask,
                                  z=mask.shape[-1]))


@pytest.mark.parametrize("on", [True, False])
def test_flags_route_mm_to_the_fused_kernels(spies, on):
    out = _run_mm(_fused(_cfg(), on), torch.bfloat16)
    assert sorted(out) == sorted(KEYS)
    assert spies == {"fused_head": int(on), "fused_conv0_down0": int(not on),
                     "fused_affine_relu_maxpool": int(on)}


def test_fp32_model_keeps_the_unfused_stem(spies):
    """JAX's stem gate needs bf16 activations (resnet.py:136); the head's
    gate has no dtype condition, so K4 still runs."""
    _run_mm(_fused(_cfg()), torch.float32)
    assert spies == {"fused_head": 1, "fused_conv0_down0": 0,
                     "fused_affine_relu_maxpool": 0}


def test_odd_grid_gates_the_head_off(spies):
    cfg = _cfg()
    mm = dataclasses.replace(cfg.model.mm, vox_grid_extent=(30, 30, 4))
    _run_mm(_fused(cfg.replace(model=dataclasses.replace(cfg.model, mm=mm))),
            torch.bfloat16)
    # 30 / 2 = 15 is odd: ME padding, so neither stage-0 fusion runs
    assert spies["fused_head"] == 0 and spies["fused_conv0_down0"] == 0


@pytest.mark.parametrize("on", [True, False])
def test_db_stem_flag_routes_the_aerial_tower(spies, on):
    cfg = _fused(_cfg(), on)
    db = DBVanilla2D(cfg.model.db, dim=cfg.model.features_dim,
                     dtype=torch.bfloat16).eval()
    from agplace_tpu_torch.infer import init_weights

    init_weights(db, torch.Generator().manual_seed(0))
    maps = torch.randn(B, 1, IMG, IMG, 3, generator=torch.Generator()
                       .manual_seed(2))
    with torch.inference_mode():
        assert db(maps).shape == (B, cfg.model.features_dim)
    assert spies["fused_affine_relu_maxpool"] == int(on)


# ------------------------------------------------------------- the slice
@pytest.fixture(scope="module")
def fused_world():
    cfg = _fused(_cfg())
    rng = np.random.default_rng(0)
    img = rng.standard_normal((B, IMG, IMG, 3)).astype(np.float32)
    from agplace_tpu.data.base import prepare_query_vox as jax_prep

    vox = jax_prep(cfg, _points(rng, B))
    mm_j = JaxMM(config=cfg.model.mm, train=False)
    v = _randomize(jax.jit(mm_j.init)(jax.random.PRNGKey(0), img, vox), rng)
    return cfg, img, vox, v


def test_converter_unchanged_with_the_flags(fused_world):
    """The JAX holder modules declare the same scopes on the fused path
    (bev_grid.py:690-699, bn1 read with return_affine): every leaf of the
    flagged model's tree is consumed exactly once by the same bridge."""
    cfg, _, _, v = fused_world
    mm = MM(cfg.model.mm)
    sd = jax_to_state_dict(v, mm)
    n_leaves = sum(len(jax.tree_util.tree_leaves(v[c])) for c in v)
    assert len(sd) == n_leaves == len(mm.state_dict())
    plain = MM(_fused(cfg, False).model.mm)
    assert sorted(plain.state_dict()) == sorted(mm.state_dict())


def test_fused_mm_matches_jax_fused_configuration(fused_world, monkeypatch):
    cfg, img, vox, v = fused_world
    monkeypatch.setattr(jax_bev, "_pallas_backend_ok", lambda: True)
    mm_j = JaxMM(config=cfg.model.mm, train=False, dtype=jnp.bfloat16)
    want = jax.jit(mm_j.apply)(v, img, vox)
    mm = load_jax_variables(MM(cfg.model.mm, dtype=torch.bfloat16), v).eval()
    ops.reset_launches()
    with torch.inference_mode():
        got = mm(torch.from_numpy(img), _tgrid(vox))
    assert sorted(got) == sorted(KEYS) == sorted(want)
    for k in KEYS:
        _close(got[k].float().numpy(), want[k], TOL_BF16, k)
    assert set(ops.launches().values()) == {0}  # CPU: plain versions only


def test_fused_db_tower_matches_jax(monkeypatch):
    cfg = _fused(_cfg())
    monkeypatch.setattr(jax_bev, "_pallas_backend_ok", lambda: True)
    rng = np.random.default_rng(3)
    maps = rng.standard_normal((B, 1, IMG, IMG, 3)).astype(np.float32)
    db_j = JaxDB(config=cfg.model.db, dim=cfg.model.features_dim,
                 dtype=jnp.bfloat16)
    v = _randomize(jax.jit(db_j.init)(jax.random.PRNGKey(1), maps), rng)
    want = jax.jit(db_j.apply)(v, maps)
    db = DBVanilla2D(cfg.model.db, dim=cfg.model.features_dim,
                     dtype=torch.bfloat16)
    load_jax_variables(db, v)
    with torch.inference_mode():
        got = db.eval()(torch.from_numpy(maps))
    _close(got.float().numpy(), want, TOL_BF16, "db embedding")
