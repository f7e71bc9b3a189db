"""The port's three kernel modules against the JAX Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; here those are held
against the JAX Pallas functions run as the JAX tests run them on the CPU
(interpret mode), at small shapes, from the same numpy inputs.  CPU calls
must leave the launch counters at 0.  The kernels themselves are compared
with their plain versions on the card in ``test_torch_port_cuda.py``.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from agplace_tpu.ops.pallas import bev_block_sm as jax_block
from agplace_tpu.ops.pallas import bev_down as jax_down
from agplace_tpu.ops.pallas import ode_step as jax_ode
from agplace_tpu.sparse import bev_grid as jax_bev
from agplace_tpu_torch import ops
from agplace_tpu_torch.data.voxels import me_down_align
from agplace_tpu_torch.ops import _build, bev_block_sm, bev_down, ode_step
from agplace_tpu_torch.sparse import bev_grid as bg

torch.set_num_threads(1)

TOL_FP32 = dict(rtol=1e-5, atol=1e-5)  # K1: fp32 throughout
# K2/K3: bf16 activations with fp32 accumulation; the existing Pallas
# parity tests hold the kernels to the XLA path at the same 2e-2
TOL_BF16 = dict(rtol=2e-2, atol=2e-2)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _f32(a):
    return np.asarray(a, np.float32)


# --------------------------------------------------------------------- K1
@pytest.mark.parametrize("act", ["relu", "tanh", "sigmoid", "id"])
def test_k1_plain_matches_pallas(act):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 64)) / 8).astype(np.float32)
    b = (rng.standard_normal(64) * 0.1).astype(np.float32)
    want = jax_ode.fused_euler_ode(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b), 10, 0.1, act)
    ops.reset_launches()
    got = ode_step.fused_euler_ode(_t(x), _t(w), _t(b), 10, 0.1, act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_FP32)
    assert ode_step.fused_euler_ode.launches == 0


# --------------------------------------------------------------------- K2
def _grid(rng, b, xy, z, c0, density=0.3):
    mask = rng.uniform(size=(b, xy, xy, z)) < density
    feats = rng.standard_normal((b, xy, xy, z, c0)).astype(np.float32)
    feats = np.where(mask[..., None], feats, 0.0).reshape(b, xy, xy, z * c0)
    return feats, mask


def _affine(rng, c, z):
    inv = 1.0 / np.sqrt(rng.uniform(0.5, 1.5, c) + 1e-5)
    scale = rng.uniform(0.5, 1.5, c)
    s = inv * scale
    b = rng.normal(0, 0.1, c) - rng.normal(0, 0.1, c) * s
    return np.tile(s, z).astype(np.float32), np.tile(b, z).astype(np.float32)


def _k2_inputs(xy, z, c0, c1, k0, b=2, seed=0):
    rng = np.random.default_rng(seed)
    feats, mask = _grid(rng, b, xy, z, c0)
    k0w = (rng.standard_normal((k0, k0, k0, c0, c1)) * 0.2).astype(np.float32)
    kdw = (rng.standard_normal((2, 2, 2, c1, c1)) * 0.2).astype(np.float32)
    zo = me_down_align(z)[2]
    s0, b0 = _affine(rng, c1, z)
    sd, bd = _affine(rng, c1, zo)
    return feats, mask, k0w, kdw, s0, b0, sd, bd


@pytest.mark.parametrize("xy,z,c0,c1,k0",
                         [(32, 4, 1, 16, 5), (16, 2, 3, 8, 3),
                          (32, 3, 1, 16, 5)])
def test_k2_plain_matches_pallas(xy, z, c0, c1, k0):
    feats, mask, k0w, kdw, s0, b0, sd, bd = _k2_inputs(xy, z, c0, c1, k0)
    w0_j = jax_bev.fold_w2_stride1(jnp.asarray(k0w), z)
    wd_j = jax_bev.fold_w2_k2s2(jnp.asarray(kdw), z)
    want, m_want = jax_down.fused_conv0_down0(
        jnp.asarray(feats, jnp.bfloat16), jnp.asarray(mask), w0_j,
        jnp.asarray(s0), jnp.asarray(b0), wd_j, jnp.asarray(sd),
        jnp.asarray(bd), z=z)

    w0 = bg.fold_w2_stride1(_t(k0w), z)
    wd = bg.fold_w2_k2s2(_t(kdw), z)
    np.testing.assert_array_equal(w0.numpy(), np.asarray(w0_j))
    np.testing.assert_array_equal(wd.numpy(), np.asarray(wd_j))
    ops.reset_launches()
    got, m_got = bev_down.fused_conv0_down0(
        _t(feats, torch.bfloat16), torch.from_numpy(mask), w0, _t(s0),
        _t(b0), wd, _t(sd), _t(bd), z=z)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(m_got.numpy(), np.asarray(m_want))
    np.testing.assert_allclose(got.float().numpy(), _f32(want), **TOL_BF16)
    assert bev_down.fused_conv0_down0.launches == 0


# --------------------------------------------------------------------- K3
def _k3_inputs(z, cin, c, xy, b, seed=0):
    rng = np.random.default_rng(seed)
    mask = rng.random((b, xy, xy, z)) < 0.3
    x = rng.standard_normal((b, xy, xy, z, cin)).astype(np.float32)
    x = np.where(mask[..., None], x, 0).reshape(b, xy, xy, z * cin)
    k1 = (rng.standard_normal((3, 3, 3, cin, c))
          * np.sqrt(2 / (27 * cin))).astype(np.float32)
    k2 = (rng.standard_normal((3, 3, 3, c, c))
          * np.sqrt(2 / (27 * c))).astype(np.float32)
    kd = (rng.standard_normal((1, 1, 1, cin, c))
          * np.sqrt(2 / cin)).astype(np.float32)
    k_eca = 3 if c < 128 else 5
    w_eca = rng.standard_normal(k_eca).astype(np.float32)
    aff = [_affine(rng, c, z) for _ in range(3)]
    return x, mask, k1, k2, kd, w_eca, aff


@pytest.mark.parametrize("z,cin,c,xy,b", [(2, 64, 64, 16, 2),
                                          (4, 32, 32, 8, 3),
                                          (2, 32, 64, 16, 2),
                                          (2, 64, 128, 8, 3)])
def test_k3_plain_matches_pallas(z, cin, c, xy, b):
    x, mask, k1, k2, kd, w_eca, aff = _k3_inputs(z, cin, c, xy, b)
    (s1, b1), (s2, b2), (sd, bd) = aff
    ds = cin != c
    jkw = {}
    tkw = {}
    if ds:
        jkw = dict(wd=jax_bev.fold_w2_stride1(jnp.asarray(kd), z),
                   scale_d=jnp.asarray(sd), bias_d=jnp.asarray(bd))
        tkw = dict(wd=bg.fold_w2_stride1(_t(kd), z), scale_d=_t(sd),
                   bias_d=_t(bd))
    want = jax_block.fused_eca_block_sm(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(mask),
        jax_bev.fold_w2_stride1(jnp.asarray(k1), z),
        jax_bev.fold_w2_stride1(jnp.asarray(k2), z), jnp.asarray(s1),
        jnp.asarray(b1), jnp.asarray(s2), jnp.asarray(b2),
        jnp.asarray(w_eca), z=z, **jkw)
    ops.reset_launches()
    got = bev_block_sm.fused_eca_block_sm(
        _t(x, torch.bfloat16), torch.from_numpy(mask),
        bg.fold_w2_stride1(_t(k1), z), bg.fold_w2_stride1(_t(k2), z),
        _t(s1), _t(b1), _t(s2), _t(b2), _t(w_eca), z=z, **tkw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _f32(want), **TOL_BF16)
    # masked structure: exactly zero at unoccupied cells
    mf = np.repeat(mask, c, axis=-1)
    assert np.all(got.float().numpy()[~mf] == 0)
    assert bev_block_sm.fused_eca_block_sm.launches == 0


# ----------------------------------------------------------- dispatch rule
def test_dispatch_rule():
    cpu = torch.zeros(2)
    assert _build.on_cuda(cpu, cpu) is False
    with pytest.raises(ValueError, match="mixed or unsupported"):
        _build.on_cuda(cpu, torch.zeros(2, device="meta"))
    with pytest.raises(ValueError, match="unsupported activation"):
        ode_step.fused_euler_ode(cpu[None], torch.zeros(2, 2), cpu, act="gelu")


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(_build.os.path, "exists",
                        lambda p: False)  # no toolkit, no built library
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
