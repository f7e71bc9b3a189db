"""The port's sparse voxel backend held against the JAX package on the CPU:
the device geometry (``sparse/voxels.py``: integer outputs exactly equal,
with a cloud that overflows the capacity and one beyond +-63), the
gather-GEMM layers and blocks (``sparse/modules.py``), the sparse FPN
(``sparse/minkfpn.py``) and the MM on ``voxfe_backend='sparse'`` in eval
and training mode (helpers and tolerances of
``test_torch_port_mm_options.py``).

Layer tolerances, fractions of the output's largest magnitude: fp32
compute, summation order only (1e-5); bf16 compute, the rounded operands
multiplied exactly in both and summed in fp32 in another order (1e-4).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from agplace_tpu.sparse import minkfpn as jax_fpn
from agplace_tpu.sparse import modules as jax_mod
from agplace_tpu.sparse import voxels as jax_vox
from agplace_tpu_torch.data.voxels import SparseVoxels
from agplace_tpu_torch.sparse import minkfpn, modules, voxels
from agplace_tpu_torch.utils.convert import load_jax_variables

from test_torch_port_mm_options import (check_eval, check_train, close,
                                        fp32_twin, make_world,
                                        random_variables)

torch.set_num_threads(1)

FP32_TOL, BF16_TOL = 1e-5, 1e-4


def _sv(rng, b=2, n=96, span=6, c=3, fill=0.5):
    """Random voxel sets: ``fill`` of the rows valid, distinct coordinates
    in [-span, span), shuffled among the padding."""
    coords = np.zeros((b, n, 3), np.int32)
    mask = np.zeros((b, n), bool)
    cells = np.stack(np.meshgrid(*[np.arange(-span, span)] * 3,
                                 indexing="ij"), -1).reshape(-1, 3)
    for i in range(b):
        k = int(n * fill)
        rows = rng.permutation(n)[:k]
        coords[i, rows] = cells[rng.choice(len(cells), k, replace=False)]
        mask[i, rows] = True
    feats = rng.standard_normal((b, n, c)).astype(np.float32)
    feats[~mask] = 0
    return coords, feats, mask


def _pair(coords, feats, mask, stride=1):
    return (jax_vox.SparseVoxels(coords=jnp.asarray(coords),
                                 feats=jnp.asarray(feats),
                                 mask=jnp.asarray(mask), stride=stride),
            SparseVoxels(coords=torch.from_numpy(coords),
                         feats=torch.from_numpy(feats),
                         mask=torch.from_numpy(mask), stride=stride))


def _eq(got, want, what=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), what)


def _eq_sv(got, want):
    for f in ("coords", "feats", "mask"):
        _eq(getattr(got, f).numpy(), getattr(want, f), f)
    assert got.stride == want.stride


# ----------------------------------------------------------- geometry
def test_pack_unpack_exactly_equal():
    rng = np.random.default_rng(0)
    coords = rng.integers(-511, 512, (3, 50, 3)).astype(np.int32)
    mask = rng.random((3, 50)) < 0.7
    want = jax_vox.pack_coords(jnp.asarray(coords), jnp.asarray(mask))
    got = voxels.pack_coords(torch.from_numpy(coords), torch.from_numpy(mask))
    assert got.dtype == torch.int32
    _eq(got.numpy(), want)
    _eq(voxels.unpack_coords(got).numpy(), jax_vox.unpack_coords(want))
    assert voxels.INVALID_KEY == int(jax_vox.INVALID_KEY)


@pytest.mark.parametrize("case", ["overflow", "beyond-63", "masked",
                                  "sparse"])
def test_quantize_exactly_equal(case):
    rng = np.random.default_rng(1)
    pts = rng.uniform(-40, 40, (3, 600, 3)).astype(np.float32)
    mask, cap = None, 256
    if case == "overflow":  # ~600 distinct voxels into 256 rows
        cap = 256
    elif case == "beyond-63":  # clamped to the grid's +-63
        pts[:, :200] *= 400.0
        cap = 1024
    elif case == "masked":  # a masked tail and one empty sample
        mask = np.ones((3, 600), bool)
        mask[0, 300:] = False
        mask[2] = False
        cap = 1024
    else:  # duplicates: fewer distinct voxels than the capacity
        pts = np.round(pts / 8.0) * 8.0
        cap = 1024
    want = jax_vox.quantize(jnp.asarray(pts), 2.0, cap,
                            None if mask is None else jnp.asarray(mask))
    got = voxels.quantize(torch.from_numpy(pts), 2.0, cap,
                          None if mask is None else torch.from_numpy(mask))
    _eq_sv(got, want)
    if case == "overflow":
        assert got.mask.all()
    if case == "beyond-63":
        assert int(got.coords.abs().max()) == 63
    if case == "masked":
        assert not got.mask[2].any()


def test_kernel_offsets_equal():
    for k in (1, 2, 3, 5, 7):
        for s in (1, 2, 4):
            _eq(voxels.kernel_offsets(k, s).numpy(),
                jax_vox.kernel_offsets(k, s))


def test_sort_by_key_and_lookup_exactly_equal():
    rng = np.random.default_rng(2)
    sv_j, sv = _pair(*_sv(rng))
    want, keys_j = jax_vox.sort_by_key(sv_j)
    got, keys = voxels.sort_by_key(sv)
    _eq_sv(got, want)
    _eq(keys.numpy(), keys_j)
    # queries: present keys, absent ones, padding
    q = np.concatenate([np.asarray(keys_j)[:, ::3],
                        rng.integers(0, 2 ** 30 - 1, (2, 20)).astype(
                            np.int32),
                        np.full((2, 4), 2 ** 30 - 1, np.int32)], axis=1)
    want = jax_vox.lookup(keys_j, jnp.asarray(q))
    got = voxels.lookup(keys, torch.from_numpy(q))
    assert got.dtype == torch.int32
    _eq(got.numpy(), want)
    assert (got >= 0).any() and (got < 0).any()


def test_point_grid_and_lookup_exactly_equal():
    rng = np.random.default_rng(3)
    coords, _, mask = _sv(rng, span=8)
    coords[0, :5] = [[70, 0, 0], [-64, 1, 1], [63, 63, -63], [0, 0, 64],
                     [-63, -63, -63]]  # two outside the grid
    mask[0, :5] = True
    want = jax_vox.build_point_grid(jnp.asarray(coords), jnp.asarray(mask))
    got = voxels.build_point_grid(torch.from_numpy(coords),
                                  torch.from_numpy(mask))
    _eq(got.numpy(), want)
    qc = rng.integers(-70, 70, (2, 40, 3)).astype(np.int32)
    qc[:, :10] = coords[:, :10]
    qv = rng.random((2, 40)) < 0.8
    _eq(voxels.grid_lookup(got, torch.from_numpy(qc),
                           torch.from_numpy(qv)).numpy(),
        jax_vox.grid_lookup(want, jnp.asarray(qc), jnp.asarray(qv)))


@pytest.mark.parametrize("k,stride", [(3, 1), (5, 1), (3, 2), (2, 2)])
def test_neighbor_table_and_downsample_exactly_equal(k, stride):
    rng = np.random.default_rng(4)
    coords, feats, mask = _sv(rng, n=128, span=7, fill=0.75)
    coords = coords * stride
    sv_j, sv = _pair(coords, feats, mask, stride)
    svs_j, keys_j = jax_vox.sort_by_key(sv_j)
    svs, keys = voxels.sort_by_key(sv)
    if k == 2:  # a k2s2 down: the coarser set and its table
        oc_j, om_j = jax_vox.downsample_coords(svs_j, 2)
        oc, om = voxels.downsample_coords(svs, 2)
        _eq(oc.numpy(), oc_j)
        _eq(om.numpy(), om_j)
    else:
        oc_j, om_j, oc, om = svs_j.coords, svs_j.mask, svs.coords, svs.mask
    off = jax_vox.kernel_offsets(k, stride)
    want = jax_vox.build_neighbor_table(svs_j, keys_j, oc_j, om_j, off)
    got = voxels.build_neighbor_table(svs, keys, oc, om, off)
    assert got.dtype == torch.int32
    _eq(got.numpy(), want)
    assert (got >= 0).sum() > int(om.sum())  # real neighbours beyond self


def test_downsample_coords_at_full_capacity():
    rng = np.random.default_rng(5)
    coords, feats, mask = _sv(rng, n=64, span=6, fill=1.0)
    for factor, stride in ((2, 1), (2, 2), (4, 1)):
        sv_j, sv = _pair(coords * stride, feats, mask, stride)
        want = jax_vox.downsample_coords(sv_j, factor)
        got = voxels.downsample_coords(sv, factor)
        for g, w in zip(got, want):
            _eq(g.numpy(), w)


def test_masked_pools_match():
    rng = np.random.default_rng(6)
    sv_j, sv = _pair(*_sv(rng))
    np.testing.assert_allclose(voxels.masked_global_avg(sv).numpy(),
                               jax_vox.masked_global_avg(sv_j), rtol=1e-6)
    _eq(voxels.masked_global_max(sv).numpy(),
        jax_vox.masked_global_max(sv_j))


# -------------------------------------------------------------- layers
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_sparse_conv_apply_chunked_matches(compute, monkeypatch):
    """JAX's chunking of the offsets (a small budget: 4 offsets per chunk
    here) with fp32 accumulation across chunks."""
    rng = np.random.default_rng(7)
    coords, feats, mask = _sv(rng, n=64, c=8)
    sv_j, sv = _pair(coords, feats, mask)
    svs_j, keys_j = jax_vox.sort_by_key(sv_j)
    table = jax_vox.build_neighbor_table(svs_j, keys_j, svs_j.coords,
                                         svs_j.mask,
                                         jax_vox.kernel_offsets(3, 1))
    kern = rng.standard_normal((27, 8, 5)).astype(np.float32)
    budget = 4 * 2 * 64 * 8
    monkeypatch.setattr(jax_mod, "_GATHER_BUDGET_ELEMS", budget)
    monkeypatch.setattr(modules, "_GATHER_BUDGET_ELEMS", budget)
    jdt, tdt = ((jnp.float32, torch.float32) if compute == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    want = jax_mod.sparse_conv_apply(svs_j.feats, table, jnp.asarray(kern),
                                     compute_dtype=jdt)
    got = modules.sparse_conv_apply(
        torch.from_numpy(np.asarray(svs_j.feats)),
        torch.from_numpy(np.asarray(table)), torch.from_numpy(kern), tdt)
    close(got.numpy(), want, FP32_TOL if compute == "float32" else BF16_TOL)
    k = 13
    _eq(modules.gather_neighbors(torch.from_numpy(np.asarray(svs_j.feats)),
                                 torch.from_numpy(np.asarray(table)),
                                 k).numpy(),
        jax_mod.gather_neighbors(svs_j.feats, table, k))


@pytest.mark.parametrize("k,stride", [(1, 1), (3, 1), (5, 1), (2, 2)])
def test_sparse_conv_matches(k, stride):
    rng = np.random.default_rng(8)
    sv_j, sv = _pair(*_sv(rng, c=4))
    svs_j, keys_j = jax_vox.sort_by_key(sv_j)
    svs, keys = voxels.sort_by_key(sv)
    conv_j = jax_mod.SparseConv(6, kernel_size=k, stride=stride)
    v = random_variables(conv_j, rng, svs_j, keys_j)
    want, wkeys = conv_j.apply(v, svs_j, keys_j)
    conv = modules.SparseConv(4, 6, k, stride)
    load_jax_variables(conv, v)
    got, gkeys = conv(svs, keys)
    for f in ("coords", "mask"):
        _eq(getattr(got, f).numpy(), getattr(want, f), f)
    assert got.stride == want.stride
    _eq(gkeys.numpy(), wkeys)
    close(got.feats.detach().numpy(), want.feats, BF16_TOL)


def test_sparse_conv_transpose_matches():
    rng = np.random.default_rng(9)
    sv_j, sv = _pair(*_sv(rng, c=4))
    fine_j, _ = jax_vox.sort_by_key(sv_j)
    fine, _ = voxels.sort_by_key(sv)
    cc_j, cm_j = jax_vox.downsample_coords(fine_j, 2)
    feats = rng.standard_normal(cc_j.shape[:2] + (4,)).astype(np.float32)
    feats[~np.asarray(cm_j)] = 0
    coarse_j = jax_vox.SparseVoxels(coords=cc_j, feats=jnp.asarray(feats),
                                    mask=cm_j, stride=2)
    coarse = SparseVoxels(coords=torch.from_numpy(np.asarray(cc_j)),
                          feats=torch.from_numpy(feats),
                          mask=torch.from_numpy(np.asarray(cm_j)), stride=2)
    keys_j = jax_vox.pack_coords(cc_j, cm_j)
    tc_j = jax_mod.SparseConvTranspose(5)
    args = (coarse_j, keys_j, fine_j.coords, fine_j.mask, 1)
    v = random_variables(tc_j, rng, *args)
    want = tc_j.apply(v, *args)
    tc = modules.SparseConvTranspose(4, 5)
    load_jax_variables(tc, v)
    got = tc(coarse, None, fine.coords, fine.mask, 1)
    _eq(got.mask.numpy(), want.mask)
    close(got.feats.detach().numpy(), want.feats, FP32_TOL)


@pytest.mark.parametrize("train", [False, True])
def test_masked_batchnorm_matches(train):
    rng = np.random.default_rng(10)
    _, feats, mask = _sv(rng, c=6)
    bn_j = jax_mod.MaskedBatchNorm(use_running_average=not train)
    v = random_variables(bn_j, rng, jnp.asarray(feats), jnp.asarray(mask))
    bn = modules.MaskedBatchNorm(6)
    load_jax_variables(bn, v)
    bn.train(train)
    if train:
        want, upd = bn_j.apply(v, feats, mask, mutable=["batch_stats"])
        got = bn(torch.from_numpy(feats), torch.from_numpy(mask))
        close(bn.running_mean.numpy(), upd["batch_stats"]["mean"], 1e-6)
        close(bn.running_var.numpy(), upd["batch_stats"]["var"], 1e-6)
    else:
        want = bn_j.apply(v, feats, mask)
        got = bn(torch.from_numpy(feats), torch.from_numpy(mask))
    close(got.detach().numpy(), want, FP32_TOL)
    assert not got[~torch.from_numpy(mask)].any()


@pytest.mark.parametrize("block", ["eca", "basic", "aspp", "convnext"])
def test_sparse_fpn_blocks_match(block):
    """MinkFPN with each block and a top-down level, eval mode, the convs
    in fp32 (the fp32-conv twins): every stage's map and the final map,
    exactly the same coordinates, masks and keys."""
    rng = np.random.default_rng(11)
    coords, feats, mask = _sv(rng, n=128, span=8, c=1, fill=0.6)
    feats[mask] = 1.0
    sv_j, sv = _pair(coords, feats, mask)
    kw = dict(out_channels=16, planes=(8, 16, 16), layers=(1, 1, 1),
              num_top_down=1, block=block)
    with pytest.MonkeyPatch.context() as mp:
        fp32_twin(mp)
        fpn_j = jax_fpn.MinkFPN(**kw)
        v = random_variables(fpn_j, rng, sv_j)
        want, wkeys, wmaps = fpn_j.apply(v, sv_j)
    fpn = minkfpn.MinkFPN(**kw)
    load_jax_variables(fpn, v)
    for m in fpn.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float32
    with torch.no_grad():
        got, gkeys, gmaps = fpn.eval()(sv)
    _eq(gkeys.numpy(), wkeys)
    for (g, _), (w, _) in zip(gmaps, wmaps):
        _eq(g.mask.numpy(), w.mask)
        _eq(g.coords.numpy(), w.coords)
        close(g.feats.numpy(), w.feats, FP32_TOL * 10)
    close(got.feats.numpy(), want.feats, FP32_TOL * 10)


def test_refusals_match_jax():
    with pytest.raises(NotImplementedError, match="blocks"):
        minkfpn.MinkFPN(block="bogus")
    # JAX's FPNs fail at num_top_down == n_stages; the port refuses it
    with pytest.raises(NotImplementedError, match="num_top_down"):
        minkfpn.MinkFPN(planes=(8, 16), layers=(1, 1), num_top_down=2)


# ------------------------------------------------------ the MM, sparse
SPARSE_VARIANTS = {
    "eca": {},
    "ntd1-basic-noproj-droppc": dict(voxfe_ntd=1, voxfe_block="basic",
                                     stg2_useproj=False, drop="pc"),
    "ntd2-aspp": dict(voxfe_ntd=2, voxfe_block="aspp"),
    "convnext-midpoint": dict(voxfe_block="convnext",
                              ode={"method": "midpoint"}),
}


@pytest.fixture(scope="module")
def sparse_world(request):
    return make_world(voxfe_backend="sparse",
                      **SPARSE_VARIANTS[request.param])


@pytest.mark.parametrize("sparse_world", list(SPARSE_VARIANTS),
                         indirect=True)
def test_sparse_mm_eval_match(sparse_world):
    check_eval(sparse_world)


@pytest.mark.parametrize("sparse_world", list(SPARSE_VARIANTS),
                         indirect=True)
def test_sparse_mm_train_match(sparse_world, request):
    # the eca variant's check also holds the gradients
    check_train(sparse_world,
                grads=request.node.callspec.params["sparse_world"] == "eca")

