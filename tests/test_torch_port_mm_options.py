"""The MM's option tail in the PyTorch port held against the JAX package on
the CPU: every option value JAX's ``MM`` builds, on the three voxel
backends, with all 7 output keys in eval mode and in training mode (batch
statistics, the updated running statistics), and the gradients of a
scalar of the embedding.  This file covers the BEV backend's options (the
FPN blocks, the top-down pass, the integrators, ``drop``, ``addorg``,
``final_fusetype``, ``stg2_useproj``), the refusals the port shares with
JAX, and training with the new options; ``test_torch_port_dense.py`` and
``test_torch_port_sparse.py`` hold the other two backends with the helpers
defined here.

Inputs and weights are made with numpy from a seed: JAX's parameter tree
comes from ``jax.eval_shape`` of its ``init`` (no compile), every leaf
filled with non-trivial values (BN affines and running statistics away
from the identity), and the port loads it through ``utils.convert``.
The clouds lie inside the grid extent (16 x 16 x 4 cells at 2 m).

Tolerances are fractions of each output's largest magnitude.  Eval mode,
the model as configured: the voxel convs take bf16 operands and round to
bf16 in both packages, so a last-ulp fp32 difference upstream can flip
one bf16 rounding (``test_torch_port_slice.py``: 1e-2 on the voxel-
dependent outputs, measured up to 6.0e-3 here; the image vector 1e-4).
Training mode: batch statistics of a few occupied cells amplify those
flips (measured up to 0.39 with ``drop='pc'``, where every sample holds
one voxel), so each package runs its fp32-conv twin (the voxel convs in
fp32: the port's modules get ``compute_dtype`` fp32, JAX's classes are
patched while they trace) and the twins are held with no allowance for
bf16 noise.
"""

import dataclasses
import functools
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from agplace_tpu.config import kitti360_config as jax_kitti360
from agplace_tpu.data.base import prepare_query_vox as jax_prepare_query_vox
from agplace_tpu.models.mm import MM as JaxMM
from agplace_tpu_torch import ops
from agplace_tpu_torch.config import kitti360_config
from agplace_tpu_torch.data.voxels import prepare_query_vox
from agplace_tpu_torch.models.mm import MM
from agplace_tpu_torch.utils.convert import (jax_to_state_dict,
                                             load_jax_variables)

torch.set_num_threads(1)

B, IMG, GRID, CAP = 2, 32, (16, 16, 4), 512
KEYS = ("imagevec_org", "voxvec_org", "shallowvec_org", "stg2fusevec",
        "stg2imagevec", "stg2voxvec", "embedding")
EVAL_TOL = {"imagevec_org": 1e-4}
EVAL_TOL_VOX = 1e-2
# fp32 twins: summation order only (measured up to 1.5e-4 on the outputs,
# 1.8e-5 on the running statistics, 6.4e-4 on a gradient leaf)
TWIN_TOL = 2e-3
STATS_TOL = 1e-3
GRAD_TOL = 5e-3
# a gradient leaf zero in exact arithmetic (the bias of a conv before a
# train-mode BN): JAX's below ZERO_REL of its tower's largest leaf, and the
# port's must be too
ZERO_REL = 1e-6


# ------------------------------------------------------------- helpers
def configs(**over):
    """(JAX config, port config) of KITTI-360 with the grid cut to GRID,
    ``vox_max_points`` to CAP, and ``over`` on ``model.mm`` (``ode`` as a
    dict of ODEConfig fields)."""
    out = []
    for make in (jax_kitti360, kitti360_config):
        cfg = make()
        mm_over = dict(over)
        ode = mm_over.pop("ode", None)
        if ode:
            mm_over["ode"] = dataclasses.replace(cfg.model.mm.ode, **ode)
        mm = dataclasses.replace(cfg.model.mm, vox_grid_extent=GRID,
                                 **mm_over)
        cfg = cfg.replace(
            model=dataclasses.replace(cfg.model, mm=mm),
            data=dataclasses.replace(cfg.data, vox_max_points=CAP))
        out.append(cfg)
    return tuple(out)


def cloud(rng, b, n=1500, r_max=15.0):
    """LiDAR-like clouds (HDL-64 elevations, log-uniform range) inside the
    grid extent: |x|, |y| < 16 m, z within +-4 m."""
    az = rng.uniform(0, 2 * np.pi, (b, n))
    elev = np.deg2rad(rng.uniform(-24.9, 2.0, (b, n)))
    r = np.exp(rng.uniform(np.log(2.0), np.log(r_max), (b, n)))
    return np.stack([r * np.cos(elev) * np.cos(az),
                     r * np.cos(elev) * np.sin(az),
                     np.maximum(r * np.sin(elev), -1.73)],
                    axis=-1).astype(np.float32)


def random_variables(module, rng, *args):
    """A flax variable tree of ``module`` for ``args`` (shapes from
    ``jax.eval_shape`` of its init) filled from ``rng``: kernels at their
    initialisers' scales, BN affines and statistics away from identity."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)

    def leaf(path, s):
        name, shape = path[-1].key, s.shape
        if name in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, shape)
        elif name in ("bias", "mean", "fc_bias"):
            a = rng.normal(0.0, 0.1, shape)
        elif name == "p":
            a = np.full(shape, 3.0)
        else:
            if name == "kernel" and len(shape) == 5:  # [k,k,k,cin,cout]
                std = math.sqrt(2.0 / (np.prod(shape[:4])))
            elif name == "kernel" and len(shape) == 3:  # sparse [K,cin,cout]
                std = math.sqrt(2.0 / (shape[0] * shape[1]))
            elif len(shape) == 4:  # HWIO
                std = 1.0 / math.sqrt(np.prod(shape[:3]))
            else:  # [in, out], ECA [k, 1, 1]
                std = 1.0 / math.sqrt(shape[0])
            a = rng.standard_normal(shape) * std
        return np.asarray(a, np.float32)

    tree = jax.tree_util.tree_map_with_path(leaf, shapes)
    return {c: jax.tree_util.tree_map(np.asarray, tree[c]) for c in tree}


def make_world(seed=0, **over):
    cfg_j, cfg = configs(**over)
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((B, IMG, IMG, 3)).astype(np.float32)
    pts = cloud(rng, B)
    vox_j = jax_prepare_query_vox(cfg_j, pts)
    v = random_variables(JaxMM(config=cfg_j.model.mm, train=False), rng,
                         img, vox_j)
    return dict(cfg_j=cfg_j, cfg=cfg, img=img, pts=pts, vox_j=vox_j, v=v,
                r=rng.standard_normal((B, 1)).astype(np.float32))


def port_mm(world, twin=False):
    mm = MM(world["cfg"].model.mm)
    load_jax_variables(mm, world["v"])
    if twin:
        for m in mm.modules():
            if hasattr(m, "compute_dtype"):
                m.compute_dtype = torch.float32
    return mm


def port_vox(world):
    return prepare_query_vox(world["cfg"], world["pts"], "cpu")


def close(got, want, frac, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= frac * np.abs(want).max(), (what, err, np.abs(want).max())


def fp32_twin(mp):
    """JAX's voxel convs in fp32 while ``mp`` holds (the tracing of a
    forward): the classes each module looks up when it is called."""
    import agplace_tpu.models.fusion as fusion_mod
    import agplace_tpu.models.mm as mm_mod
    import agplace_tpu.sparse.bev_grid as bev_mod
    import agplace_tpu.sparse.dense_grid as dense_mod
    import agplace_tpu.sparse.minkfpn as fpn_mod
    import agplace_tpu.sparse.modules as sparse_mod

    def f32(owner, name, base=None):
        cls = getattr(base or owner, name)
        mp.setattr(owner, name, functools.partial(
            cls, compute_dtype=jnp.float32))

    for name in ("BEVMinkFPN", "BEVECABasicBlock", "BEVConv"):
        f32(bev_mod, name)
    f32(mm_mod, "DenseMinkFPN", dense_mod)
    for name in ("GridConv", "GridECABasicBlock"):
        f32(fusion_mod, name, dense_mod)
    for owner in (sparse_mod, fpn_mod, fusion_mod):
        f32(owner, "SparseConv", sparse_mod)


def check_eval(world):
    """The configured model in eval mode: all 7 keys against JAX."""
    mm_j = JaxMM(config=world["cfg_j"].model.mm, train=False)
    want = jax.jit(mm_j.apply)(world["v"], world["img"], world["vox_j"])
    mm = port_mm(world).eval()
    with torch.inference_mode():
        got = mm(torch.from_numpy(world["img"]), port_vox(world))
    assert sorted(got) == sorted(KEYS) == sorted(want)
    for k in KEYS:
        assert got[k].dtype == torch.float32, k
        close(got[k].numpy(), want[k], EVAL_TOL.get(k, EVAL_TOL_VOX), k)
    return mm, got


def check_train(world, grads=False):
    """The fp32-conv twins in training mode: all 7 keys, the running
    statistics after the forward, and with ``grads`` the gradient of
    sum(embedding * r) leaf by leaf."""
    v, img, vox_j, r = (world[k] for k in ("v", "img", "vox_j", "r"))
    with pytest.MonkeyPatch.context() as mp:
        fp32_twin(mp)
        mm_j = JaxMM(config=world["cfg_j"].model.mm, train=True)

        def fwd(params, stats):
            out, upd = mm_j.apply({"params": params, "batch_stats": stats},
                                  img, vox_j, mutable=["batch_stats"])
            return jnp.sum(out["embedding"] * r), (out, upd)

        if grads:
            g_j, (want, upd) = jax.jit(jax.grad(fwd, has_aux=True))(
                v["params"], v["batch_stats"])
        else:
            _, (want, upd) = jax.jit(fwd)(v["params"], v["batch_stats"])
    mm = port_mm(world, twin=True).train()
    got = mm(torch.from_numpy(img), port_vox(world))
    assert sorted(got) == sorted(KEYS) == sorted(want)
    for k in KEYS:
        close(got[k].detach().numpy(), want[k], TWIN_TOL, k)
    stats = jax_to_state_dict({"params": v["params"],
                               "batch_stats": upd["batch_stats"]}, mm)
    mine = mm.state_dict()
    for k, w in stats.items():
        if "running" in k:
            close(mine[k].numpy(), w.numpy(), STATS_TOL, k)
    if grads:
        (got["embedding"] * torch.from_numpy(r)).sum().backward()
        want_g = jax_to_state_dict({"params": g_j,
                                    "batch_stats": upd["batch_stats"]}, mm)
        top = max(float(np.abs(w.numpy()).max()) for k, w in want_g.items()
                  if "running" not in k)
        for name, p in mm.named_parameters():
            w = want_g[name].numpy()
            g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
            if np.abs(w).max() <= ZERO_REL * top:
                assert np.abs(g).max() <= ZERO_REL * top, name
            else:
                close(g, w, GRAD_TOL, name)
    return mm, got


# ------------------------------------------------ the BEV backend's options
BEV_VARIANTS = {
    "ntd1-basic-midpoint-cat": dict(voxfe_ntd=1, voxfe_block="basic",
                                    ode={"method": "midpoint"},
                                    final_fusetype="cat"),
    "ntd2-aspp-rk4-catadd": dict(voxfe_ntd=2, voxfe_block="aspp",
                                 ode={"method": "rk4"},
                                 final_fusetype="catadd",
                                 final_type=("shalloworg", "stg2vox")),
    "convnext-dopri5-noproj-dropimage": dict(
        voxfe_block="convnext", ode={"method": "dopri5"},
        stg2_useproj=False, drop="image"),
    "addorg-droppc": dict(output_type=("image", "vox", "addorg"),
                          drop="pc"),
    "euler-step0.3": dict(ode={"step_size": 0.3}),
}


# the variants whose training check also holds the gradients
BEV_GRADS = ("ntd2-aspp-rk4-catadd", "convnext-dopri5-noproj-dropimage")


@pytest.fixture(scope="module")
def bev_world(request):
    return make_world(**BEV_VARIANTS[request.param])


@pytest.mark.parametrize("bev_world", list(BEV_VARIANTS), indirect=True)
def test_bev_options_eval_match(bev_world):
    check_eval(bev_world)


@pytest.mark.parametrize("bev_world", list(BEV_VARIANTS), indirect=True)
def test_bev_options_train_match(bev_world, request):
    check_train(bev_world,
                grads=request.node.callspec.params["bev_world"] in BEV_GRADS)


# ------------------------------------------------------------ refusals
def test_refusals_match_jax():
    """What JAX's MM refuses the port refuses: a host-rasterized grid on
    the dense or sparse backend, an unknown block, ``num_top_down`` equal
    to the stage count (JAX's FPNs fail on their out_maps write there)."""
    world = make_world()
    grid = port_vox(world)  # a BEVGrid (the bev backend's host raster)
    for backend in ("dense", "sparse"):
        _, cfg = configs(voxfe_backend=backend)
        with pytest.raises(TypeError, match="BEVGrid"):
            MM(cfg.model.mm)(torch.from_numpy(world["img"]), grid)
    _, cfg = configs(voxfe_backend="sparse", voxfe_block="bogus")
    with pytest.raises(NotImplementedError, match="blocks"):
        MM(cfg.model.mm)
    for backend in ("bev", "dense", "sparse"):
        _, cfg = configs(voxfe_backend=backend, voxfe_ntd=3)
        with pytest.raises(NotImplementedError, match="num_top_down"):
            MM(cfg.model.mm)
        cfg_j, _ = configs(voxfe_backend=backend, voxfe_ntd=3)
        vox_j = jax_prepare_query_vox(cfg_j, world["pts"])
        with pytest.raises(IndexError):
            jax.eval_shape(JaxMM(config=cfg_j.model.mm).init,
                           jax.random.PRNGKey(0), world["img"], vox_j)


@pytest.mark.parametrize("over", [
    dict(voxfe_backend="sparse", voxfe_ntd=2, voxfe_block="convnext"),
    dict(voxfe_backend="dense", voxfe_ntd=1, voxfe_block="aspp",
         stg2_useproj=False)])
def test_converter_carries_every_new_leaf(over):
    """Every flax leaf lands on one port entry and every entry is filled:
    the sparse kernels [K, cin, cout] and 1x1 [cin, cout], the transposed
    convs, the ConvNeXt and ASPP convs, unchanged."""
    cfg_j, cfg = configs(**over)
    world = make_world(**over)
    mm = MM(cfg.model.mm)
    sd = jax_to_state_dict(world["v"], mm)
    v = world["v"]
    n_leaves = sum(len(jax.tree_util.tree_leaves(v[c])) for c in v)
    assert len(sd) == n_leaves == len(mm.state_dict())
    fe = v["params"]["vox_fe"]
    for path in ("tconv0", "block1_0/conv1", "lateral0", "lateral_top"):
        leaf = fe
        for part in path.split("/"):
            leaf = leaf[part]
        key = "vox_fe." + path.replace("/", ".") + ".kernel"
        np.testing.assert_array_equal(sd[key].numpy(), leaf["kernel"])


# -------------------------------------------------- training, new options
def test_train_step_takes_the_new_options():
    """The train step builds the MM from the config: the sparse backend
    with rk4 and ASPP blocks trains (finite losses, every MM parameter
    with a gradient moves), K1 never launches its Function (rk4 goes
    through ``odeint``), and no eval-only kernel is called."""
    from agplace_tpu_torch.config import synthetic_config
    from agplace_tpu_torch.data.base import collate_train
    from agplace_tpu_torch.data.pipeline import prefetch_to_device
    from agplace_tpu_torch.data.synthetic import SyntheticDataset
    from agplace_tpu_torch.ops import ode_step
    from agplace_tpu_torch.train.mining import TripletMiner
    from agplace_tpu_torch.train.step import init_state, make_train_step

    cfg = synthetic_config(batch_size=2, image_size=32, vox_max_points=128)
    mm_cfg = dataclasses.replace(
        cfg.model.mm, voxfe_backend="sparse", voxfe_block="aspp",
        voxfe_ntd=1, ode=dataclasses.replace(cfg.model.mm.ode,
                                             method="rk4"))
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, mm=mm_cfg,
                                                pretrained=False))
    ds = SyntheticDataset(n_db=24, n_q=16, image_size=32, seed=0)
    rng = np.random.default_rng(0)
    rows = TripletMiner(cfg, ds, "cpu").mine_random(rng, 2)
    batch = next(prefetch_to_device([collate_train(ds, rows, cfg, rng)],
                                    "cpu"))
    assert type(batch["vox"]).__name__ == "SparseVoxels"
    state = init_state(cfg, "cpu")
    before = {n: p.detach().clone() for n, p in state.mm.named_parameters()}
    k1 = []
    real = ode_step.EulerODE.apply
    step = make_train_step(cfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ode_step.EulerODE, "apply",
                   lambda *a: k1.append(1) or real(*a))
        ops.reset_launches()
        losses = [float(step(state, batch)["loss"]) for _ in range(2)]
    assert all(np.isfinite(losses)) and not k1
    assert set(ops.launches().values()) == {0}
    moved = [n for n, p in state.mm.named_parameters()
             if p.grad is not None and not torch.equal(p, before[n])]
    with_grad = [n for n, p in state.mm.named_parameters()
                 if p.grad is not None and p.grad.abs().sum() > 0]
    assert set(with_grad) <= set(moved)
    assert any(n.startswith("vox_fe.tconv0") for n in with_grad)
    assert any(n.startswith("vox_fe.block0_0.conv3") for n in with_grad)
