"""The port's training parts held against the JAX package on the CPU:
train-mode BN (dense and masked BEV), K1's autograd Function against
``jax.vjp`` of JAX's ``fused_euler_ode`` (Pallas in interpret mode), every
loss and its gradient, the optimizer's group labels on the full MM + DB
tree, two group-Adam steps and the SGD steps, ``collate_train``, the
prefetchers, and the folded-weight cache after an in-place update.  Inputs
come from numpy seeds; each tolerance is stated with the error measured
here beside it."""

import dataclasses
import threading
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from agplace_tpu.config import TrainConfig as JaxTrainConfig
from agplace_tpu.config import synthetic_config as jax_synthetic_config
from agplace_tpu.data.base import collate_train as jax_collate_train
from agplace_tpu.data.synthetic import SyntheticDataset as JaxSynthetic
from agplace_tpu.models.norm import BatchNorm2D as JaxBN
from agplace_tpu.ops.pallas.ode_step import fused_euler_ode as jax_ode
from agplace_tpu.sparse.bev_grid import BEVBatchNorm as JaxBEVBN
from agplace_tpu.sparse.bev_grid import BEVGrid as JaxGrid
from agplace_tpu.train import losses as jl
from agplace_tpu.train import optim as jax_optim
from agplace_tpu_torch.config import LossConfig, TrainConfig, synthetic_config
from agplace_tpu_torch.data.base import collate_train
from agplace_tpu_torch.data.pipeline import Prefetcher, prefetch_to_device
from agplace_tpu_torch.data.synthetic import SyntheticDataset
from agplace_tpu_torch.models.norm import BatchNorm2D
from agplace_tpu_torch.ops import ode_step
from agplace_tpu_torch.sparse.bev_grid import BEVConv, BEVGrid, bn_apply
from agplace_tpu_torch.train import losses as tl
from agplace_tpu_torch.train import optim
from agplace_tpu_torch.utils.convert import flax_path

torch.set_num_threads(2)


def _rel(got, want):
    """max |got - want| over max |want|."""
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# ------------------------------------------------------------ train-mode BN
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_mode_bn_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 6, 5, 16)) * 2 + 0.5).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    bias = rng.normal(0, 0.1, 16).astype(np.float32)
    mean0 = rng.normal(0, 0.1, 16).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    y_j, mut = JaxBN(use_running_average=False).apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean0, "var": var0}},
        jnp.asarray(x, jdt), mutable=["batch_stats"])
    bn = BatchNorm2D(16).train()
    with torch.no_grad():
        for t, a in ((bn.weight, scale), (bn.bias, bias),
                     (bn.running_mean, mean0), (bn.running_var, var0)):
            t.copy_(torch.from_numpy(a))
    y = bn(torch.from_numpy(x).to(tdt))
    assert y.dtype == tdt
    # fp32: measured 1.7e-7 (output), 2.4e-7 / 7.1e-8 (statistics); bf16:
    # the affine is applied in bf16 in both: outputs equal, statistics
    # 4.8e-8 / 7.1e-8
    tol = 1e-5 if dtype == "float32" else 1e-2
    assert _rel(y, np.asarray(y_j, np.float32)) <= tol
    bs = mut["batch_stats"]
    assert _rel(bn.running_mean.numpy(), bs["mean"]) <= 1e-5
    assert _rel(bn.running_var.numpy(), bs["var"]) <= 1e-5


def test_masked_bev_bn_matches_jax():
    rng = np.random.default_rng(1)
    b, x, y, z, c = 2, 8, 6, 4, 8
    mask = rng.uniform(size=(b, x, y, z)) < 0.3
    feats = (rng.standard_normal((b, x, y, z * c)) + 0.3).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(0, 0.1, c).astype(np.float32)
    mean0 = rng.normal(0, 0.1, c).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, c).astype(np.float32)
    out_j, mut = JaxBEVBN(use_running_average=False, mask_output=False).apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean0, "var": var0}},
        JaxGrid(feats=jnp.asarray(feats), mask=jnp.asarray(mask), z=z),
        mutable=["batch_stats"])
    bn = BatchNorm2D(c).train()
    with torch.no_grad():
        for t, a in ((bn.weight, scale), (bn.bias, bias),
                     (bn.running_mean, mean0), (bn.running_var, var0)):
            t.copy_(torch.from_numpy(a))
    g = BEVGrid(feats=torch.from_numpy(feats), mask=torch.from_numpy(mask),
                z=z)
    out = bn_apply(g, bn)
    # measured 2.5e-7 (output), 3.1e-8 / 4.3e-8 (statistics): fp32 sum
    # order
    assert _rel(out, out_j.feats) <= 1e-5
    bs = mut["batch_stats"]
    assert _rel(bn.running_mean.numpy(), bs["mean"]) <= 1e-5
    assert _rel(bn.running_var.numpy(), bs["var"]) <= 1e-5
    # the statistics are the occupied cells' only: unoccupied features do
    # not move them
    g2 = g.replace(feats=torch.where(g.mask.repeat_interleave(c, -1),
                                     g.feats, 1e3))
    bn2 = BatchNorm2D(c).train()
    bn_apply(g2, bn2)
    bn3 = BatchNorm2D(c).train()
    bn_apply(g, bn3)
    torch.testing.assert_close(bn2.running_mean, bn3.running_mean)


def test_masked_bev_bn_empty_grid_counts_one():
    """No occupied cell: the count clamps to 1, the statistics are 0 and
    the variance clamps at 0 (no NaN), as in JAX."""
    bn = BatchNorm2D(4).train()
    g = BEVGrid(feats=torch.ones(1, 2, 2, 8), mask=torch.zeros(1, 2, 2, 2,
                                                               dtype=bool),
                z=2)
    out = bn_apply(g, bn)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(bn.running_mean, torch.zeros(4))
    torch.testing.assert_close(bn.running_var, torch.full((4,), 0.9))


# -------------------------------------------------------- K1's autograd Fn
@pytest.mark.parametrize("act", ["relu", "tanh", "sigmoid", "id"])
@pytest.mark.parametrize("batch", [1, 4, 33])
def test_k1_function_grads_match_jax_vjp(act, batch):
    rng = np.random.default_rng(batch)
    d = 256
    x = rng.standard_normal((batch, d)).astype(np.float32)
    w = (rng.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32)
    b = rng.normal(0, 0.1, d).astype(np.float32)
    g = rng.standard_normal((batch, d)).astype(np.float32)
    y_j, vjp = jax.vjp(lambda x, w, b: jax_ode(x, w, b, 10, 0.1, act),
                       jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    want = vjp(jnp.asarray(g))
    xt, wt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    y = ode_step.euler_ode(xt, wt, bt, 10, 0.1, act)
    got = torch.autograd.grad(y, (xt, wt, bt), torch.from_numpy(g))
    # fp32 on both sides, another matmul summation order: measured <= 2.9e-7
    # of scale (y, gx, gw, gb; every case)
    assert _rel(y, y_j) <= 1e-5
    for name, gt, gj in zip(("gx", "gw", "gb"), got, want):
        assert _rel(gt.numpy(), gj) <= 2e-5, name


def test_k1_function_counts_forward_launches_only(monkeypatch):
    calls = []
    real = ode_step.fused_euler_ode

    def spy(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(ode_step, "fused_euler_ode", spy)
    x = torch.randn(3, 256, requires_grad=True)
    w = torch.randn(256, 256, requires_grad=True)
    b = torch.zeros(256, requires_grad=True)
    ode_step.euler_ode(x, w, b).sum().backward()
    assert len(calls) == 1 and x.grad is not None


def test_direct_cuda_call_needing_a_gradient_raises(monkeypatch):
    """``_build.on_cuda`` refuses a CUDA input that needs a gradient under
    grad mode (only the Function routes gradients); a CPU stand-in for
    the device check shows the rule without a card."""
    from agplace_tpu_torch.ops import _build

    class FakeCuda:
        device = torch.device("cuda", 0)
        requires_grad = True

    with pytest.raises(RuntimeError, match="forward-only"):
        _build.on_cuda(FakeCuda(), FakeCuda())
    with torch.no_grad():
        assert _build.on_cuda(FakeCuda()) is True


# ------------------------------------------------------------------ losses
def _loss_inputs(seed=0, b=3, nneg=4, c=16):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((b * (2 + nneg), c)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    group = 2 + nneg
    tri = np.array([(i * group, i * group + 1, i * group + 2 + j)
                    for i in range(b) for j in range(nneg)], np.int32)
    return feats, tri, b, nneg


def _grad_pair(jfn, tfn, *arrays):
    """(value, grads) of a scalar loss in JAX and in the port."""
    val_j, grads_j = jax.value_and_grad(jfn, argnums=tuple(
        range(len(arrays))))(*map(jnp.asarray, arrays))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    val = tfn(*ts)
    grads = torch.autograd.grad(val, ts)
    return (float(val_j), [np.asarray(g) for g in grads_j],
            float(val.detach()), [g.numpy() for g in grads])


@pytest.mark.parametrize("criterion", ["triplet", "sare_ind", "sare_joint",
                                       "infonce"])
def test_metric_losses_match_jax(criterion):
    feats, tri, b, nneg = _loss_inputs()
    tri_j, tri_t = jnp.asarray(tri), torch.from_numpy(tri)
    fns = {
        "triplet": (lambda f: jl.compute_triplet_loss(f, tri_j, b, nneg, 0.1),
                    lambda f: tl.compute_triplet_loss(f, tri_t, b, nneg,
                                                      0.1)),
        "sare_ind": (lambda f: jl.compute_sare_loss(f, tri_j, b, nneg),
                     lambda f: tl.compute_sare_loss(f, tri_t, b, nneg)),
        "sare_joint": (lambda f: jl.compute_sare_loss(f, tri_j, b, nneg,
                                                      joint=True),
                       lambda f: tl.compute_sare_loss(f, tri_t, b, nneg,
                                                      joint=True)),
        "infonce": (lambda f: jl.infonce_loss(f, tri_j, b, nneg),
                    lambda f: tl.infonce_loss(f, tri_t, b, nneg)),
    }
    vj, gj, vt, gt = _grad_pair(*fns[criterion], feats)
    # fp32, the same formulas: measured <= 8.6e-8 (value), <= 1.9e-7 of
    # the gradient's scale
    assert abs(vt - vj) <= 1e-5 * max(1.0, abs(vj))
    assert _rel(gt[0], gj[0]) <= 1e-5


@pytest.mark.parametrize("name", ["sare_ind", "sare_joint"])
def test_sare_terms_match_jax(name):
    """JAX's single-query form: query / positive [1, C], negatives
    [N, C]; the port returns the one term as a [1] tensor."""
    feats, _, _, nneg = _loss_inputs()
    q, p, n = feats[:1], feats[1:2], feats[2:2 + nneg]
    vj, gj, vt, gt = _grad_pair(
        lambda *a: getattr(jl, name)(*a),
        lambda *a: getattr(tl, name)(*a).sum(), q, p, n)
    # fp32, the same formula: within 1e-5 as compute_sare_loss above
    assert abs(vt - vj) <= 1e-5 * max(1.0, abs(vj))
    for g_t, g_j in zip(gt, gj):
        assert _rel(g_t, g_j) <= 1e-5


def test_triplet_loss_has_eps_inside_the_sqrt():
    a = torch.zeros(1, 4)
    got = float(tl.triplet_margin_loss(a, a, a, margin=0.1))
    assert got == pytest.approx(0.1)  # sqrt(0 + eps) - sqrt(0 + eps) + m
    want = float(torch.nn.TripletMarginLoss(margin=0.1, p=2,
                                            reduction="sum")(
        a + 1, a + 0.5, a - 2))
    assert float(tl.triplet_margin_loss(a + 1, a + 0.5, a - 2)) == \
        pytest.approx(want, rel=1e-6, abs=1e-6)


@pytest.mark.parametrize("kind", ["bce", "mse", "l1"])
def test_other_loss_matches_jax(kind):
    rng = np.random.default_rng(2)
    b, ndb, c = 3, 4, 16
    # unit rows, as the towers give them
    g = rng.standard_normal((3, b, c)).astype(np.float32)
    g /= np.linalg.norm(g, axis=-1, keepdims=True)
    aerial = rng.standard_normal((b, ndb, c)).astype(np.float32)
    aerial /= np.linalg.norm(aerial, axis=-1, keepdims=True)
    # UTM magnitudes, distances straddling the 10 / 25 m thresholds
    base = np.array([500000.0, 4000000.0])
    q_en = (base + rng.uniform(0, 40, (b, 2))).astype(np.float32)
    db_en = (base + rng.uniform(0, 40, (b, ndb, 2))).astype(np.float32)
    cfg_t = LossConfig(otherloss_type=kind)
    cfg_j = jl.LossConfig(otherloss_type=kind)

    def jfn(g, aerial):
        return jl.compute_other_loss(
            {"embedding": g[0], "imagevec_org": g[1], "voxvec_org": g[2]},
            aerial, jnp.asarray(q_en), jnp.asarray(db_en), cfg_j, 10.0, 25.0)

    def tfn(g, aerial):
        return tl.compute_other_loss(
            {"embedding": g[0], "imagevec_org": g[1], "voxvec_org": g[2]},
            aerial, torch.from_numpy(q_en), torch.from_numpy(db_en), cfg_t,
            10.0, 25.0)

    vj, gj, vt, gt = _grad_pair(jfn, tfn, g, aerial)
    # The descriptor distances take the expanded form |a|^2 + |b|^2 - 2ab
    # (as JAX's ``pairwise_l2``): a row's distance to itself is the sqrt of
    # fp32 rounding noise (~3e-4 at unit rows), and the two matmuls make
    # other noise.  Measured: value 9.7e-6 to 1.8e-5 relative, gradients
    # 1.6e-5 to 2.8e-4 of their scale.
    assert abs(vt - vj) <= 1e-4 * abs(vj)
    for a, w in zip(gt, gj):
        assert _rel(a, w) <= 2e-3
    mat = tl.compute_bcemat(torch.tensor([[5.0, 15.0, 30.0]]), 10, 25)
    assert mat.tolist() == [[0.0, -1.0, 1.0]]


# ----------------------------------------------------------- group labels
def test_label_params_on_the_full_tree():
    """The labels of every leaf of both towers' trees (JAX's traced with
    ``jax.eval_shape``: only the tree's paths matter)."""
    from agplace_tpu.train.mining import TripletMiner
    from agplace_tpu.train.step import build_models
    from agplace_tpu_torch.train.step import init_state

    cfg_j = jax_synthetic_config(batch_size=2, image_size=32,
                                 vox_max_points=128)
    ds = JaxSynthetic(n_db=8, n_q=4, image_size=32, seed=0)
    rng = np.random.default_rng(0)
    batch = jax_collate_train(ds, TripletMiner(cfg_j, ds).mine_random(rng, 2),
                              cfg_j, rng)
    mm_j, db_j = build_models(cfg_j, train=False)
    key = jax.random.PRNGKey(0)
    params_j = {
        "mm": jax.eval_shape(mm_j.init, key, batch["query_image"],
                             batch["vox"])["params"],
        "db": jax.eval_shape(db_j.init, key, batch["db_map"])["params"]}
    labels_j = {tuple(str(k.key) for k in path): lab for path, lab in
                jax.tree_util.tree_flatten_with_path(
                    jax_optim.label_params(params_j))[0]}
    cfg = synthetic_config(batch_size=2, image_size=32, vox_max_points=128)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, pretrained=False))
    named = list(init_state(cfg, "cpu").named_parameters())
    labels = optim.label_params(named)
    by_path = {flax_path(n, p): labels[n] for n, p in named}
    assert by_path == labels_j
    assert set(labels.values()) == {"base", "pc", "db"}


def test_label_of_crn_and_frozen_match_jax():
    tree = {"mm": {"backbone": {"encoder_1": {"w": 0.0},
                                "encoder_5": {"w": 0.0},
                                "embed": {"w": 0.0}},
                   "crn": {"w": 0.0}, "vox_fe": {"w": 0.0},
                   "vox_weight": 0.0, "head": {"w": 0.0}},
            "db": {"net": {"backbone": {"encoder_0": {"w": 0.0}}},
                   "fc": {"w": 0.0}}}
    for crn, freeze in ((False, None), (True, 2), (False, -1)):
        want = jax.tree_util.tree_flatten_with_path(
            jax_optim.label_params(tree, crn=crn, freeze_te=freeze))[0]
        for path, lab in want:
            keys = [str(k.key) for k in path]
            assert optim.label_of(keys, crn, freeze) == lab, (keys, crn)


# ---------------------------------------------------------------- optimizer
# Port parameters whose flax path keeps their layout (the update is
# elementwise, so layouts only have to agree between the two trees).
_NAMED = {"mm.image_fe.fe.bn1.weight": (8,),
          "mm.image_fe.fe.bn1.bias": (8,),
          "mm.vox_fe.conv0.kernel": (3, 3, 3, 1, 4),
          "mm.vox_weight": (),
          "mm.fuseblocktoshallow.diff_0.fcode_0.kernel": (6, 6),
          "db.fe_0.fe.conv1.bias": (5,),
          "db.mlp_0.ln.weight": (7,)}


def _named_params(rng):
    return [(n, torch.nn.Parameter(torch.from_numpy(
        rng.standard_normal(s).astype(np.float32))))
        for n, s in _NAMED.items()]


def _flax_tree(named, arrays):
    tree = {}
    for (n, p), a in zip(named, arrays):
        *scope, leaf = flax_path(n, p)
        node = tree
        for k in scope:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(a)
    return tree


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


@pytest.mark.parametrize("train_modeldb", [True, False])
def test_group_adam_two_steps_match_jax(train_modeldb):
    rng = np.random.default_rng(3)
    named = _named_params(rng)
    cfg = dataclasses.replace(TrainConfig(), lr=1e-2, lrpc=3e-2, lrdb=5e-3,
                              train_modeldb=train_modeldb)
    cfg_j = dataclasses.replace(JaxTrainConfig(), lr=1e-2, lrpc=3e-2,
                                lrdb=5e-3, train_modeldb=train_modeldb)
    params_j = _flax_tree(named, [p.detach().numpy().copy()
                                  for _, p in named])
    tx = jax_optim.make_optimizer(cfg_j)
    opt_state = tx.init(params_j)
    opt = optim.make_optimizer(cfg, named)
    for _ in range(2):
        grads = [rng.standard_normal(p.shape).astype(np.float32)
                 for _, p in named]
        for (_, p), g in zip(named, grads):
            p.grad = torch.from_numpy(g)
        opt.step()
        upd, opt_state = tx.update(_flax_tree(named, grads), opt_state,
                                   params_j)
        params_j = jax.tree_util.tree_map(lambda a, u: a + u, params_j, upd)
    assert opt.count == int(opt_state.count) == 2
    paths = [tuple(str(k.key) for k in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(params_j)[0]]
    sizes = [int(np.prod(_leaf(params_j, pa).shape)) for pa in paths]
    offs = np.cumsum([0] + sizes)
    mu_j = {pa: np.asarray(opt_state.mu)[o:o + s] for pa, o, s in
            zip(paths, offs, sizes)}
    nu_j = {pa: np.asarray(opt_state.nu)[o:o + s] for pa, o, s in
            zip(paths, offs, sizes)}
    moments = opt.moments()
    for n, p in named:
        path = flax_path(n, p)
        # fp32 elementwise, the same order of operations: measured equal
        # (params and moments)
        np.testing.assert_allclose(p.detach().numpy(), _leaf(params_j, path),
                                   rtol=1e-6, atol=1e-7, err_msg=n)
        mu, nu = moments[n]
        np.testing.assert_allclose(mu.numpy().ravel(), mu_j[path],
                                   rtol=1e-6, atol=1e-8, err_msg=n)
        np.testing.assert_allclose(nu.numpy().ravel(), nu_j[path],
                                   rtol=1e-6, atol=1e-8, err_msg=n)
        if not train_modeldb and n.startswith("db."):
            assert float(mu.abs().max()) > 0  # lr 0: moments still move


@pytest.mark.parametrize("crn", [False, True])
def test_group_sgd_step_matches_jax(crn):
    rng = np.random.default_rng(4)
    named = _named_params(rng)
    cfg = dataclasses.replace(TrainConfig(), optim="sgd", lr=1e-1,
                              lrpc=2e-1, lrdb=5e-2, lr_crn_net=3e-2)
    cfg_j = dataclasses.replace(JaxTrainConfig(), optim="sgd", lr=1e-1,
                                lrpc=2e-1, lrdb=5e-2, lr_crn_net=3e-2)
    params_j = _flax_tree(named, [p.detach().numpy().copy()
                                  for _, p in named])
    tx = jax_optim.make_optimizer(cfg_j, crn=crn)
    opt_state = tx.init(params_j)
    opt = optim.make_optimizer(cfg, named, crn=crn)
    grads = [rng.standard_normal(p.shape).astype(np.float32)
             for _, p in named]
    for (_, p), g in zip(named, grads):
        p.grad = torch.from_numpy(g)
    opt.step()
    upd, _ = tx.update(_flax_tree(named, grads), opt_state, params_j)
    for n, p in named:
        want = _leaf(params_j, flax_path(n, p)) + _leaf(upd, flax_path(n, p))
        # measured equal
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-6,
                                   atol=1e-7, err_msg=n)


# ------------------------------------------------------------------ collate
def test_collate_train_equals_jax_array_for_array():
    cfg_j = jax_synthetic_config(batch_size=3, image_size=32,
                                 vox_max_points=128, negs=3)
    cfg = synthetic_config(batch_size=3, image_size=32, vox_max_points=128,
                           negs=3)
    ds_j = JaxSynthetic(n_db=20, n_q=8, image_size=32, seed=5)
    ds = SyntheticDataset(n_db=20, n_q=8, image_size=32, seed=5)
    rows = np.array([[0, 1, 4, 5, 6], [3, 2, 7, 8, 9], [5, 0, 10, 11, 12]])
    rng_j, rng = np.random.default_rng(7), np.random.default_rng(7)
    want = jax_collate_train(ds_j, rows, cfg_j, rng_j)
    got = collate_train(ds, rows, cfg, rng)
    for k in ("query_image", "query_eastnorth", "db_map", "db_eastnorth",
              "triplets_local"):
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), k)
    np.testing.assert_array_equal(got["vox"].mask.numpy(),
                                  np.asarray(want["vox"].mask))
    np.testing.assert_array_equal(got["vox"].feats.numpy(),
                                  np.asarray(want["vox"].feats))
    assert got["vox"].z == want["vox"].z
    assert rng.uniform() == rng_j.uniform()  # the same draws were made


# ---------------------------------------------------------------- pipeline
@pytest.mark.parametrize("workers", [1, 3])
def test_prefetcher_keeps_order(workers):
    rng = np.random.default_rng(0)
    delays = rng.uniform(0, 0.01, 24)
    seen_threads = set()

    def make(i):
        time.sleep(delays[i])
        seen_threads.add(threading.get_ident())
        return i * 10

    out = list(Prefetcher(range(24), make, num_workers=workers,
                          buffer_size=2))
    assert out == [i * 10 for i in range(24)]
    assert len(seen_threads) <= workers


def test_prefetcher_raises_a_workers_error_in_order():
    def make(i):
        if i == 5:
            raise ValueError("bad item 5")
        return i

    it = iter(Prefetcher(range(10), make, num_workers=3))
    assert [next(it) for _ in range(5)] == list(range(5))
    with pytest.raises(ValueError, match="bad item 5"):
        next(it)


def test_prefetch_to_device_on_the_cpu():
    batches = [{"a": np.full((2, 3), i, np.float32),
                "vox": BEVGrid(feats=torch.ones(1, 2, 2, 4),
                               mask=torch.ones(1, 2, 2, 4, dtype=bool), z=4),
                "n": i} for i in range(5)]
    out = list(prefetch_to_device(iter(batches), "cpu"))
    assert [int(b["a"][0, 0]) for b in out] == list(range(5))
    assert isinstance(out[0]["a"], torch.Tensor)
    assert isinstance(out[0]["vox"], BEVGrid) and out[3]["n"] == 3
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        next(prefetch_to_device(iter(batches), "cpu", sharding=object()))


# ------------------------------------------------------ folded-weight cache
def test_folded_cache_follows_in_place_updates():
    """A fold cached in inference mode is not served after an in-place
    optimizer update or a state-dict load (both bump the version)."""
    torch.manual_seed(0)
    conv = BEVConv(2, 4, 3)
    with torch.no_grad():
        conv.kernel.normal_()
    with torch.inference_mode():
        first = conv.folded(4, "s1", torch.bfloat16).clone()
    named = [("mm.vox_fe.conv.kernel", conv.kernel)]
    opt = optim.make_optimizer(dataclasses.replace(TrainConfig(), lrpc=0.5),
                               named)
    conv.kernel.grad = torch.ones_like(conv.kernel)
    opt.step()
    with torch.inference_mode():
        after = conv.folded(4, "s1", torch.bfloat16)
    from agplace_tpu_torch.sparse.bev_grid import fold_w2_stride1

    want = fold_w2_stride1(conv.kernel.detach().to(torch.bfloat16), 4)
    assert torch.equal(after, want) and not torch.equal(after, first)
    conv.load_state_dict({"kernel": torch.zeros_like(conv.kernel)})
    with torch.inference_mode():
        assert not conv.folded(4, "s1", torch.bfloat16).any()
