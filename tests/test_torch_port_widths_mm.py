"""The port's MM against JAX's at the widths of ``chip_smoke.py``'s
[widths] configurations (W1-W5), on the CPU.

Each configuration is KITTI-360's with the flags of
``chip_smoke.WIDTHS_CONFIGS`` (W1 and W2 carry their own image branch and
voxel planes: JAX's MM adds the last image and voxel vectors to the
fusion width with no projection, ``fusion.py:136-146``), its grid cut to
16 x 16 x z at batch 2 (W4 and W5, at z = 72 and 40 with Z*C1 = 4320: 8 x
8 x z at batch 1); both packages run in bf16 on the same seeded
weights and clouds.  JAX's Pallas kernels (K1-K4) run in interpret mode
(``_pallas_backend_ok`` patched, as the JAX tests do), the port's
wrappers take their plain versions.  The weights are drawn over the
port's own parameter tree and handed to JAX as a flax tree (the converter
``utils.convert`` maps it back, strictly), which spares JAX's init trace.
"""

import dataclasses
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from agplace_tpu.config import kitti360_config as jax_kitti360
from agplace_tpu.data.base import prepare_query_vox as jax_prepare_query_vox
from agplace_tpu.models.mm import MM as JaxMM
from agplace_tpu.sparse import bev_grid as jax_bev
from agplace_tpu_torch import ops
from agplace_tpu_torch.config import kitti360_config
from agplace_tpu_torch.data.voxels import prepare_query_vox
from agplace_tpu_torch.models.mm import MM
from agplace_tpu_torch.utils.convert import flax_path, load_jax_variables
from chip_smoke import WIDTHS_CONFIGS
from tests.test_torch_port_mm_options import KEYS, close, cloud

# two threads, as the train test files sorted before this one set them:
# every xdist worker imports every test file, the last setting wins, and
# the parallel train tests hold their two-thread worker processes
# bit-equal to the pytest process
torch.set_num_threads(2)

B, IMG, XY, CAP = 2, 32, 16, 512
# the batch and grid side of the configurations whose folded maps are wide
SMALL = {"W4": (1, 8), "W5": (1, 8)}
# bf16 activations in both packages: the rounding points agree, the conv
# accumulation orders do not, and 1-ulp bf16 flips propagate through the
# FPN and the fusion (``test_torch_port_slice.TOL_BF16``, the fused MM's
# bound): every key within 2e-2 of its largest magnitude
TOL_BF16 = 2e-2


def widths_cfg(make, name, xy=XY):
    """``make()`` (a KITTI-360 config of either package) with [widths]
    configuration ``name`` of ``chip_smoke.WIDTHS_CONFIGS`` on
    ``model.mm``, the grid cut to xy x xy x z, in bf16,
    ``vox_max_points`` at CAP."""
    over = dict(dict((label, flags) for label, _, flags in
                     WIDTHS_CONFIGS)[name])
    over["vox_grid_extent"] = (xy, xy, over["vox_grid_extent"][2])
    cfg = make()
    mm = dataclasses.replace(cfg.model.mm, **over)
    return cfg.replace(
        model=dataclasses.replace(cfg.model, mm=mm,
                                  compute_dtype="bfloat16"),
        data=dataclasses.replace(cfg.data, vox_max_points=CAP))


def flax_variables(module, rng):
    """A flax variable tree for ``module``'s parameters and statistics
    (paths by ``utils.convert.flax_path``, kernels in flax's layout) drawn
    from ``rng``: kernels at 1 / sqrt(fan-in), BN affines and statistics
    away from the identity, GeM's p at 3."""
    tree = {"params": {}, "batch_stats": {}}
    for key, t in module.state_dict().items():
        *scope, leaf = flax_path(key, t)
        shape = tuple(t.shape)
        if leaf in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, shape)
        elif leaf in ("bias", "mean", "fc_bias"):
            a = rng.normal(0.0, 0.1, shape)
        elif leaf == "p":
            a = np.full(shape, 3.0)
        elif key.endswith("weight"):  # torch [out, in, ...] -> flax
            a = rng.standard_normal(shape, np.float32) / np.float32(
                math.sqrt(np.prod(shape[1:])))
            a = a.transpose(2, 3, 1, 0) if len(shape) == 4 else a.T
        else:  # flax-layout kernels [..., in, out], ECA [k, 1, 1]
            a = rng.standard_normal(shape, np.float32) / np.float32(
                math.sqrt(np.prod(shape[:-1]) if len(shape) > 1
                          else shape[0]))
        node = tree["batch_stats" if leaf in ("mean", "var") else "params"]
        for s in scope:
            node = node.setdefault(s, {})
        node[leaf] = np.asarray(a, np.float32)
    return tree


@pytest.mark.parametrize("name", [label for label, _, _ in WIDTHS_CONFIGS])
def test_mm_matches_jax_at_the_widths(name, monkeypatch):
    """The port's bf16 MM (plain versions on the CPU) against JAX's bf16
    MM with its Pallas kernels interpreted: every output key within
    TOL_BF16 of its scale."""
    b, xy = SMALL.get(name, (B, XY))
    cfg_j, cfg = (widths_cfg(jax_kitti360, name, xy),
                  widths_cfg(kitti360_config, name, xy))
    monkeypatch.setattr(jax_bev, "_pallas_backend_ok", lambda: True)
    rng = np.random.default_rng(0)
    img = rng.standard_normal((b, IMG, IMG, 3)).astype(np.float32)
    pts = cloud(rng, b)
    mm = MM(cfg.model.mm, dtype=torch.bfloat16)
    v = flax_variables(mm, rng)
    mm_j = JaxMM(config=cfg_j.model.mm, train=False, dtype=jnp.bfloat16)
    want = jax.jit(mm_j.apply)(v, img, jax_prepare_query_vox(cfg_j, pts))
    load_jax_variables(mm, v).eval()
    ops.reset_launches()
    with torch.inference_mode():
        got = mm(torch.from_numpy(img), prepare_query_vox(cfg, pts, "cpu"))
    assert sorted(got) == sorted(KEYS) == sorted(want)
    for k in KEYS:
        close(got[k].float().numpy(), want[k], TOL_BF16, k)
    assert set(ops.launches().values()) == {0}  # CPU: plain versions only
