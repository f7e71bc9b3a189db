"""The port's train step held against JAX's ``make_train_step`` on the CPU,
in the world of ``tests/test_train.py`` (``synthetic_config(batch_size=2,
image_size=32, vox_max_points=128)``, two negatives): the same weights
(converted from JAX's ``init_state``), the same collated batches, two
steps, each framework threading its own state.  Compared: the loss, every
gradient leaf, the parameters after each update, the BN running
statistics and the Adam moments.  Also: random and partial_sep mining
give JAX's triplets, the train step never calls the eval-only kernels
(K2-K5) and routes K1 through its Function, and the eval embed after a
step uses the new weights.

JAX's step returns no gradients: a debug callback in its optimizer's
update hands them to the test (``_capturing_step``)."""

import copy
import dataclasses
import functools

import numpy as np
import pytest

import jax
import torch

from agplace_tpu.config import synthetic_config as jax_synthetic_config
from agplace_tpu.data.base import collate_train as jax_collate_train
from agplace_tpu.data.synthetic import SyntheticDataset as JaxSynthetic
from agplace_tpu.train.mining import TripletMiner as JaxMiner
from agplace_tpu.train.step import (init_state as jax_init,
                                    make_infer_fns as jax_infer_fns,
                                    make_train_step as jax_step)
from agplace_tpu_torch.config import synthetic_config
from agplace_tpu_torch.data.base import collate_train
from agplace_tpu_torch.data.pipeline import prefetch_to_device
from agplace_tpu_torch.data.synthetic import SyntheticDataset
from agplace_tpu_torch.infer import make_infer_fns
from agplace_tpu_torch.ops import (bev_block_sm, bev_down, bev_head,
                                   ode_step, stem_pool)
from agplace_tpu_torch.train.mining import TripletMiner
from agplace_tpu_torch.train.step import init_state, make_train_step
from agplace_tpu_torch.utils.convert import (jax_to_state_dict,
                                             load_jax_variables)

torch.set_num_threads(2)

# Tolerances, each a fraction of the compared leaf's largest magnitude,
# one per step.  Each framework runs twice from the same weights: as
# configured (the BEV convs take bf16 operands and round to bf16) and as
# a twin with those convs in fp32.  The fp32 twins are held to each other
# leaf by leaf with no allowance for noise.  Each framework threads its
# own state, so in step 2 a few elements of a leaf sit on the other side
# of a ReLU or a max-pool after the first update (one element of a
# 590k-element conv weight off by 10 % of the leaf's scale, 99.9 % of
# its elements within 1.3 %), hence the second, wider tolerance.
LOSS_TOL = 1e-3  # measured 1.6e-4 / 5.3e-4 (steps 1 / 2)
FP32_GRAD_TOL = (2e-3, 0.15)  # measured 1.9e-4 / 0.104
FP32_MOMENT_TOL = (2e-3, 0.15)  # measured 3.8e-4 / 0.068
STATS_TOL = 1e-2  # measured up to 4.7e-3
# Leaves that are zero in exact arithmetic (the biases of the convs before
# a train-mode BN): JAX's fp32 gradient below ZERO_REL of the largest in
# its tower (measured <= 7e-8; the least other leaf 3e-5).  The port's
# must be as small.
ZERO_REL = 1e-6
# The configured (bf16) model.  A weight gradient of a conv followed by a
# train-mode BN sums many terms that cancel (the BN takes out their mean),
# so the bf16 roundings of its cotangent leave a noise of up to ~55 % of
# its scale.  That noise is the reference's: JAX's bf16 leaf against JAX's
# fp32 twin.  A leaf whose noise is at most NOISE_CAP is held within
# BF16_TOL plus NOISE_FACTOR times it; the rest are held by the fp32 twins
# alone.
NOISE_CAP = 0.05  # 133 / 129 of the 172 non-zero gradient leaves
# (err - BF16_TOL) / noise measured up to 1.24 (gradients) and 2.68 (nu,
# which squares the gradient's noise), both in step 1
NOISE_FACTOR = 3.0
BF16_TOL = (2e-2, 0.15)


def _cfgs():
    kw = dict(batch_size=2, image_size=32, vox_max_points=128)
    cj, ct = jax_synthetic_config(**kw), synthetic_config(**kw)
    return (cj.replace(model=dataclasses.replace(cj.model, pretrained=False)),
            ct.replace(model=dataclasses.replace(ct.model, pretrained=False)))


def _capturing_step(cfg_j, captured):
    """JAX's ``make_train_step``, its optimizer wrapped so that each step
    hands the gradients it computed to ``captured`` (a debug callback
    inside the jitted step)."""
    import optax

    import agplace_tpu.train.step as step_mod

    real = step_mod._make_tx

    def make_tx(cfg):
        tx = real(cfg)

        def update(grads, state, params=None):
            jax.debug.callback(lambda g: captured.append(_copy(g)), grads)
            return tx.update(grads, state, params)
        return optax.GradientTransformation(tx.init, update)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(step_mod, "_make_tx", make_tx)
        return jax_step(cfg_j)


def _as_state_dict(tree, stats, module):
    """A flax tree shaped like the parameters (gradients, moments) in the
    port's layout, by the weight bridge."""
    return jax_to_state_dict({"params": tree, "batch_stats": stats}, module)


def _leaf_err(got, want, ref=None):
    """max |got - want| over the largest magnitude of ``ref`` (default
    ``want``)."""
    scale = float(np.abs(want if ref is None else ref).max())
    diff = float(np.abs(got - want).max())
    return diff / scale if scale > 0 else diff


@pytest.fixture(scope="module")
def world():
    return _build_world()


def _fp32_bev(mp):
    """JAX's MM with its BEV convs in fp32 while ``mp`` holds (the
    tracing of a step): the backbone's and the fusion block's, which
    import these modules when they are called."""
    import jax.numpy as jnp

    import agplace_tpu.sparse.bev_grid as bev_mod
    for name in ("BEVMinkFPN", "BEVECABasicBlock", "BEVConv"):
        mp.setattr(bev_mod, name, functools.partial(
            getattr(bev_mod, name), compute_dtype=jnp.float32))


def _build_world():
    cfg_j, cfg = _cfgs()
    ds_j = JaxSynthetic(n_db=24, n_q=16, image_size=32, seed=0)
    ds = SyntheticDataset(n_db=24, n_q=16, image_size=32, seed=0)
    rng_j, rng = np.random.default_rng(0), np.random.default_rng(0)
    miner_j, miner = JaxMiner(cfg_j, ds_j), TripletMiner(cfg, ds, "cpu")
    rows, batches_j, batches = [], [], []
    for _ in range(2):
        r = miner_j.mine_random(rng_j, 2)
        rows.append((r, miner.mine_random(rng, 2)))
        batches_j.append(jax_collate_train(ds_j, r, cfg_j, rng_j))
        batches.append(next(prefetch_to_device(
            [collate_train(ds, r, cfg, rng)], "cpu")))

    # each framework twice: as configured (BEV convs in bf16) and with
    # the BEV convs in fp32 (the twin), from the same weights
    states_j = [jax_init(cfg_j, jax.random.PRNGKey(0), batches_j[0])
                for _ in range(2)]
    states = [init_state(cfg, "cpu") for _ in range(2)]
    for st in states:
        _load(st, states_j[0].params, states_j[0].batch_stats)
    eval_mm = copy.deepcopy(states[0].mm)
    for mod in states[1].mm.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = torch.float32

    captured = ([], [])
    steps_j = [_capturing_step(cfg_j, c) for c in captured]
    step = make_train_step(cfg)
    out = []
    for b_j, b in zip(batches_j, batches):
        o = {}
        for twin, tag in ((0, ""), (1, "_fp32")):
            with pytest.MonkeyPatch.context() as mp:
                if twin:
                    _fp32_bev(mp)
                states_j[twin], m_j = steps_j[twin](states_j[twin], b_j)
                jax.effects_barrier()
            st = states[twin]
            m = step(st, b)
            o.update({
                "loss_j" + tag: float(m_j["loss"]),
                "loss" + tag: float(m["loss"]),
                "grads_j" + tag: captured[twin][-1],
                "grads" + tag: {n: (None if p.grad is None
                                    else p.grad.clone())
                                for n, p in st.named_parameters()},
                "params_j" + tag: _copy(states_j[twin].params),
                "stats_j" + tag: _copy(states_j[twin].batch_stats),
                "mu_j" + tag: np.array(states_j[twin].opt_state.mu),
                "nu_j" + tag: np.array(states_j[twin].opt_state.nu),
                "state" + tag: copy.deepcopy(st.state_dict()),
                "moments" + tag: {n: (mu.clone(), nu.clone()) for n, (mu, nu)
                                  in st.opt.moments().items()},
            })
        out.append(o)
    return {"cfg": cfg, "cfg_j": cfg_j, "ds": ds, "ds_j": ds_j,
            "rows": rows, "state": states[0], "out": out,
            "eval_mm": eval_mm, "batches": batches}


def _copy(tree):
    # copies: JAX's step donates the state it is given
    return jax.tree_util.tree_map(np.array, tree)


def _load(state, params_j, stats_j):
    for tower, mod in (("mm", state.mm), ("db", state.db)):
        load_jax_variables(mod, {"params": _copy(params_j[tower]),
                                 "batch_stats": _copy(stats_j[tower])})


def _flat_layout(params_j):
    """(flax path, offset, size) of each leaf of JAX's flat Adam vector."""
    offs, out = 0, []
    for path, leaf in jax.tree_util.tree_flatten_with_path(params_j)[0]:
        out.append((tuple(str(k.key) for k in path), offs, leaf.size))
        offs += leaf.size
    return out


def _tower_trees(flat, params_j):
    """JAX's flat moment vector as {'mm': tree, 'db': tree}."""
    leaves = [flat[o:o + n].reshape(np.shape(leaf)) for (_, o, n), leaf in
              zip(_flat_layout(params_j),
                  jax.tree_util.tree_leaves(params_j))]
    treedef = jax.tree_util.tree_structure(params_j)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def test_random_mining_draws_jax_rows(world):
    for r_j, r in world["rows"]:
        np.testing.assert_array_equal(r, r_j)


@pytest.mark.parametrize("k", [0, 1])
def test_loss_matches_jax(world, k):
    o = world["out"][k]
    assert abs(o["loss"] - o["loss_j"]) <= LOSS_TOL * abs(o["loss_j"])


def _grad_pairs(world, k, tag):
    """{key: (port's leaf or None, JAX's leaf)} of step ``k``'s gradients,
    ``tag`` "" (as configured) or "_fp32" (the twins)."""
    o, state, out = world["out"][k], world["state"], {}
    for tower, mod in (("mm", state.mm), ("db", state.db)):
        want = _as_state_dict(o["grads_j" + tag][tower],
                              o["stats_j" + tag][tower], mod)
        for name, _ in mod.named_parameters():
            got = o["grads" + tag][f"{tower}.{name}"]
            out[f"{tower}.{name}"] = (None if got is None else got.numpy(),
                                      want[name].numpy())
    return out


def _moment_pairs(world, k, tag):
    """{(key, 0 for mu / 1 for nu): (port's, JAX's)} after step ``k``."""
    o, state, out = world["out"][k], world["state"], {}
    for flat_j, which in ((o["mu_j" + tag], 0), (o["nu_j" + tag], 1)):
        tree = _tower_trees(flat_j, o["params_j" + tag])
        for tower, mod in (("mm", state.mm), ("db", state.db)):
            want = _as_state_dict(tree[tower], o["stats_j" + tag][tower], mod)
            for name, _ in mod.named_parameters():
                key = f"{tower}.{name}"
                out[key, which] = (o["moments" + tag][key][which].numpy(),
                                   want[name].numpy())
    return out


def _zero_floor(world, k):
    """({keys of the leaves zero in exact arithmetic}, {tower: the
    magnitude below which a leaf counts as zero})."""
    pairs = _grad_pairs(world, k, "_fp32")
    floor = {}
    for key, (_, w) in pairs.items():
        tower = key.split(".")[0]
        floor[tower] = max(floor.get(tower, 0.0), float(np.abs(w).max()))
    floor = {t: ZERO_REL * m for t, m in floor.items()}
    return ({key for key, (_, w) in pairs.items()
             if np.abs(w).max() < floor[key.split(".")[0]]}, floor)


@pytest.mark.parametrize("k", [0, 1])
def test_every_grad_leaf_matches_jax(world, k):
    """The fp32 twins: every leaf within FP32_GRAD_TOL of its scale, the
    leaves zero in exact arithmetic below the zero floor in both."""
    zero, floor = _zero_floor(world, k)
    compared = 0
    for key, (got, w) in _grad_pairs(world, k, "_fp32").items():
        if got is None:  # a leaf no loss term reaches: zero in JAX
            assert not np.any(w), key
        elif key in zero:
            assert np.abs(got).max() < floor[key.split(".")[0]], key
        else:
            err = _leaf_err(got, w)
            assert err <= FP32_GRAD_TOL[k], (key, err)
            compared += 1
    assert compared > 150


@pytest.mark.parametrize("k", [0, 1])
def test_bf16_grad_leaves_match_jax(world, k):
    """The configured model: each leaf whose bf16 noise in JAX is at most
    NOISE_CAP within BF16_TOL plus NOISE_FACTOR times that noise."""
    zero, floor = _zero_floor(world, k)
    ref = _grad_pairs(world, k, "_fp32")
    compared = 0
    for key, (got, w) in _grad_pairs(world, k, "").items():
        if got is None:
            assert ref[key][0] is None and not np.any(w), key
            continue
        if key in zero:
            assert np.abs(got).max() < floor[key.split(".")[0]], key
            continue
        noise = _leaf_err(w, ref[key][1], w)
        if noise > NOISE_CAP:
            continue
        err = _leaf_err(got, w)
        assert err <= BF16_TOL[k] + NOISE_FACTOR * noise, (key, err, noise)
        compared += 1
    assert compared >= 120  # of 172 non-zero leaves: 133 / 129 (steps)


@pytest.mark.parametrize("k", [0, 1])
def test_bn_statistics_match_jax(world, k):
    o, state = world["out"][k], world["state"]
    for tower, mod in (("mm", state.mm), ("db", state.db)):
        want = _as_state_dict(o["params_j"][tower], o["stats_j"][tower], mod)
        for name, t in o["state"][tower].items():
            if name.endswith(("running_mean", "running_var")):
                assert _leaf_err(t.numpy(), want[name].numpy()) \
                    <= STATS_TOL, name


@pytest.mark.parametrize("k", [0, 1])
def test_adam_moments_match_jax(world, k):
    """The fp32 twins' mu and nu, as the gradients: the leaves zero in
    exact arithmetic have moments below the zero floor (squared for
    nu)."""
    zero, floor = _zero_floor(world, k)
    for (key, which), (got, w) in _moment_pairs(world, k, "_fp32").items():
        if key in zero:
            lim = floor[key.split(".")[0]] ** (1 + which)
            assert np.abs(got).max() < lim and np.abs(w).max() < lim, key
            continue
        err = _leaf_err(got, w)
        assert err <= FP32_MOMENT_TOL[k], (key, which, err)


@pytest.mark.parametrize("k", [0, 1])
def test_bf16_adam_moments_match_jax(world, k):
    """The configured model's moments, under the rule of its gradients
    (the noise JAX's bf16 moment against JAX's fp32 twin's)."""
    zero, _ = _zero_floor(world, k)
    ref = _moment_pairs(world, k, "_fp32")
    compared = 0
    for (key, which), (got, w) in _moment_pairs(world, k, "").items():
        noise = _leaf_err(w, ref[key, which][1], w)
        if key in zero or noise > NOISE_CAP:
            continue
        err = _leaf_err(got, w)
        assert err <= BF16_TOL[k] + NOISE_FACTOR * noise, \
            (key, which, err, noise)
        compared += 1
    assert compared >= 240


def test_parameters_after_each_update_match_jax(world):
    """Adam's update is about -lr * sign(g), and its size follows the
    ratio of the two steps' gradients.  Compared where every step's
    gradient is well above Adam's eps (1e-6) and within 1 % of JAX's, so
    the updates agree to within a few percent of the learning rate;
    elsewhere a gradient's sign or ratio is rounding noise (JAX's own
    oracle masks likewise, ``tests/test_torch_full_oracle.py``)."""
    state = world["state"]
    lr = state.opt.per_param(state.opt.lr)
    sure = {}
    for o in world["out"]:
        n_sure = n_all = 0
        for tower, mod in (("mm", state.mm), ("db", state.db)):
            grads = _as_state_dict(o["grads_j"][tower], o["stats_j"][tower],
                                   mod)
            params = _as_state_dict(o["params_j"][tower],
                                    o["stats_j"][tower], mod)
            for name, _ in mod.named_parameters():
                key = f"{tower}.{name}"
                w = grads[name].numpy()
                got = o["grads"][key]
                g = np.zeros_like(w) if got is None else got.numpy()
                ok = (np.abs(w) > 1e-6) & (np.abs(g - w) < 1e-2 * np.abs(w))
                m = sure[key] = sure.get(key, True) & ok
                n_sure += int(m.sum())
                n_all += m.size
                d = np.abs(o["state"][tower][name].numpy()
                           - params[name].numpy())
                assert np.all(d[m] <= 5e-2 * lr[key].numpy()[m] + 1e-7), key
        assert n_sure > 0.3 * n_all


def test_every_mining_mode_matches_jax(world):
    """With the same weights (JAX's state after one step) and the same
    generator, both miners pick the same triplets in every mode (full
    twice: its per-query cache of hard negatives carries over)."""
    cfg, cfg_j = world["cfg"], world["cfg_j"]
    params_j = world["out"][0]["params_j"]  # trained one step
    stats_j = world["out"][0]["stats_j"]
    state = init_state(cfg, "cpu")
    _load(state, params_j, stats_j)
    embed_q, embed_db = jax_infer_fns(cfg_j)
    miner_j = JaxMiner(cfg_j, world["ds_j"])
    miner = TripletMiner(cfg, world["ds"], "cpu")
    for mode in ("partial_sep", "random", "full", "full", "full_gallery"):
        rng_j, rng = np.random.default_rng(11), np.random.default_rng(11)
        cj = cfg_j.replace(train=dataclasses.replace(cfg_j.train,
                                                     mining=mode))
        miner_j.cfg = cj
        miner.cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                          mining=mode))
        want = miner_j.mine(rng_j, 8, params_j, stats_j, embed_q, embed_db)
        got = miner.mine(rng, 8, state.towers)
        np.testing.assert_array_equal(got, want, err_msg=mode)
        assert not state.mm.training and not state.db.training


def test_train_step_calls_no_eval_only_kernel(world, monkeypatch):
    """K2-K5 are eval-only: with every kernel flag on and bf16 activations
    (K5's gate) the eval forward reaches them and the train step does
    not; K1 runs through its Function, forward and backward."""
    cfg = world["cfg"]
    m = dataclasses.replace(cfg.model.mm, bev_pallas_head=False,
                            stem_pallas=True)
    d = dataclasses.replace(cfg.model.db, stem_pallas=True)
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, mm=m, db=d, compute_dtype="bfloat16"))
    calls = {}

    def spy(mod, name):
        real = getattr(mod, name)

        def f(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return real(*a, **kw)
        monkeypatch.setattr(mod, name, f)

    for mod, name in ((bev_down, "fused_conv0_down0"),
                      (bev_block_sm, "fused_eca_block_sm"),
                      (bev_head, "fused_head"),
                      (stem_pool, "fused_affine_relu_maxpool"),
                      (ode_step, "fused_euler_ode"),
                      (ode_step, "euler_ode")):
        spy(mod, name)
    backward = []
    real_bwd = ode_step.EulerODE.backward
    monkeypatch.setattr(ode_step.EulerODE, "backward", staticmethod(
        lambda ctx, g: backward.append(1) or real_bwd(ctx, g)))
    state = init_state(cfg, "cpu")
    batch = world["batches"][0]
    embed_q, _ = make_infer_fns(*state.towers)
    embed_q(batch["query_image"], batch["vox"])
    assert calls["fused_conv0_down0"] == 1
    assert calls["fused_eca_block_sm"] == 4
    assert calls["fused_affine_relu_maxpool"] == 1
    assert calls["euler_ode"] == calls["fused_euler_ode"] == 3
    calls.clear()
    make_train_step(cfg)(state, batch)
    assert calls == {"euler_ode": 3, "fused_euler_ode": 3}
    assert len(backward) == 3


def test_eval_embed_after_a_step_uses_the_new_weights(world):
    """The folded BEV kernels cached by an eval embed before a step are
    not served after it: the embed equals a fresh copy of the stepped
    towers'."""
    cfg = world["cfg"]
    state = init_state(cfg, "cpu")
    state.mm.load_state_dict(world["eval_mm"].state_dict())
    batch = world["batches"][1]
    embed_q, _ = make_infer_fns(*state.towers)
    state.mm.eval()
    before = embed_q(batch["query_image"], batch["vox"]).clone()
    make_train_step(cfg)(state, batch)
    state.mm.eval()
    after = embed_q(batch["query_image"], batch["vox"])
    fresh = copy.deepcopy(state.mm).eval()
    with torch.inference_mode():
        want = fresh(batch["query_image"], batch["vox"])["embedding"]
    assert torch.equal(after, want)
    assert not torch.equal(after, before)
