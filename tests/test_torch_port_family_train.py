"""Training the factory's other towers in the port, held against JAX on the
CPU: two train steps of GeoLoc + NetVLAD (query and aerial tower) and of
``share_qdb`` (one GeoLoc tower for both) against JAX's
``make_train_step`` from the same weights (JAX's ``init_state``, its
NetVLAD clusters initialised from the dataset) and batches: the loss,
every gradient leaf, the parameters after each update and the BN running
statistics.  Also the optimizer's group labels of these trees (crn,
``freeze_te``), the dataset NetVLAD init against JAX's from the same
k-means start, and ``python -m agplace_tpu_torch.train --modelq geoloc``
for two steps followed by ``.test --resume`` (its line equals the
in-process recalls).

Every leaf is fp32 in both, compared as a fraction of its largest
magnitude: the loss within 1e-4 (measured <= 1e-6), gradients and
parameters within 1e-3 in both steps (measured <= 1.6e-5), BN statistics
within 1e-4 (measured <= 3e-6).
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from agplace_tpu.config import synthetic_config as jax_synthetic_config
from agplace_tpu.data.base import collate_train as jax_collate_train
from agplace_tpu.data.synthetic import SyntheticDataset as JaxSynthetic
from agplace_tpu.models.geoloc import GeoLocalizationNet as JaxNet
from agplace_tpu.train import optim as jax_optim
from agplace_tpu.train.mining import TripletMiner as JaxMiner
from agplace_tpu.train.netvlad_init import (
    initialize_netvlad_from_dataset as jax_netvlad_init)
from agplace_tpu.train.step import init_state as jax_init
from agplace_tpu_torch.config import synthetic_config
from agplace_tpu_torch.data.base import collate_train
from agplace_tpu_torch.data.pipeline import prefetch_to_device
from agplace_tpu_torch.data.synthetic import SyntheticDataset
from agplace_tpu_torch.models.factory import GeoDB
from agplace_tpu_torch.models.geoloc import GeoLocalizationNet
from agplace_tpu_torch.train import optim
from agplace_tpu_torch.train.netvlad_init import (
    initialize_netvlad_from_dataset)
from agplace_tpu_torch.train.step import (check_pretrained, init_state,
                                          make_train_step)
from agplace_tpu_torch.utils.convert import flax_path, load_jax_variables
from test_torch_port_mm_options import random_variables
from test_torch_port_train_step import (_as_state_dict, _capturing_step,
                                        _copy, _leaf_err)

torch.set_num_threads(2)

LOSS_TOL = 1e-4
LEAF_TOL = (1e-3, 1e-3)  # step 1, step 2
STATS_TOL = 1e-4
# Adam moves an element by lr * g / (|g| + eps): where |g| is near eps a
# gradient difference of a few 1e-8 (1e-5 of the leaf) moves it by a
# share of lr, so a parameter is allowed PARAM_LR_TOL of the learning
# rate beside LEAF_TOL of its scale (measured 3.2e-2 of lr, a BN bias)
PARAM_LR_TOL = 0.1
GEO = dict(modelq="geoloc", backbone="resnet18conv4", aggregation="netvlad",
           netvlad_clusters=4, pretrained=False)
LR = synthetic_config().train.lr
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfgs(share=False):
    kw = dict(batch_size=2, image_size=32, vox_max_points=128)
    out = []
    for make in (jax_synthetic_config, synthetic_config):
        cfg = make(**kw)
        m = dataclasses.replace(
            cfg.model, share_qdb=share,
            db=dataclasses.replace(cfg.model.db, modeldb="geoloc"), **GEO)
        out.append(cfg.replace(model=m))
    return tuple(out)


def _towers(state):
    return [(t, m) for t, m in (("mm", state.mm), ("db", state.db))
            if m is not None]


def _run_steps(share):
    cfg_j, cfg = _cfgs(share)
    assert cfg.train.lr == LR
    ds_j = JaxSynthetic(n_db=24, n_q=16, image_size=32, seed=0)
    ds = SyntheticDataset(n_db=24, n_q=16, image_size=32, seed=0)
    rng_j, rng = np.random.default_rng(0), np.random.default_rng(0)
    miner_j = JaxMiner(cfg_j, ds_j)
    batches_j, batches = [], []
    for _ in range(2):
        r = miner_j.mine_random(rng_j, 2)
        b_j, b = (jax_collate_train(ds_j, r, cfg_j, rng_j),
                  collate_train(ds, r, cfg, rng))
        if share:
            # a synthetic query and its tile are one picture under other
            # noise: one tower embeds them almost alike, the triplet loss
            # is 0 at its margin and the two passes' gradients all but
            # cancel.  Mirrored tiles (in both frameworks' batches) keep
            # the shared case well-conditioned.
            b_j["db_map"] = b_j["db_map"][..., ::-1, :]
            b["db_map"] = b["db_map"][..., ::-1, :].copy()
        batches_j.append(b_j)
        batches.append(next(prefetch_to_device([b], "cpu")))
    state_j = jax_init(cfg_j, jax.random.PRNGKey(0), batches_j[0],
                       train_ds=ds_j)
    state = init_state(cfg, "cpu")
    for tower, mod in _towers(state):
        load_jax_variables(mod, {
            "params": _copy(state_j.params[tower]),
            "batch_stats": _copy(state_j.batch_stats[tower])})
    captured = []
    step_j = _capturing_step(cfg_j, captured)
    step = make_train_step(cfg)
    out = []
    for b_j, b in zip(batches_j, batches):
        state_j, m_j = step_j(state_j, b_j)
        jax.effects_barrier()
        m = step(state, b)
        out.append({
            "loss_j": float(m_j["loss"]), "loss": float(m["loss"]),
            "metrics": sorted(m), "metrics_j": sorted(m_j),
            "grads_j": captured[-1],
            "grads": {n: p.grad.clone() for n, p in
                      state.named_parameters() if p.grad is not None},
            "params_j": _copy(state_j.params),
            "stats_j": _copy(state_j.batch_stats),
            "state": {t: {k: v.clone() for k, v in m.state_dict().items()}
                      for t, m in _towers(state)}})
    return state, out


@pytest.fixture(scope="module", params=[False, True],
                ids=["geoloc-netvlad", "share_qdb"])
def world(request):
    return _run_steps(request.param)


@pytest.mark.parametrize("k", [0, 1])
def test_loss_matches_jax(world, k):
    _, out = world
    o = out[k]
    assert o["loss_j"] > 0.01  # every step has live triplets
    assert abs(o["loss"] - o["loss_j"]) <= LOSS_TOL * abs(o["loss_j"])
    # no geo "other" loss outside the MM, as JAX
    assert o["metrics"] == o["metrics_j"] == ["loss", "triplet_loss"]


@pytest.mark.parametrize("k", [0, 1])
def test_grads_params_and_stats_match_jax(world, k):
    state, out = world
    o = out[k]
    compared = 0
    for tower, mod in _towers(state):
        grads = _as_state_dict(o["grads_j"][tower], o["stats_j"][tower], mod)
        after = _as_state_dict(o["params_j"][tower], o["stats_j"][tower],
                               mod)
        for name, _ in mod.named_parameters():
            key = f"{tower}.{name}"
            w = grads[name].numpy()
            if key not in o["grads"]:
                assert not np.any(w), key
                continue
            assert _leaf_err(o["grads"][key].numpy(), w) <= LEAF_TOL[k], key
            got_p, want_p = o["state"][tower][name].numpy(), \
                after[name].numpy()
            assert np.abs(got_p - want_p).max() <= (
                LEAF_TOL[k] * np.abs(want_p).max() + PARAM_LR_TOL * LR), key
            compared += 1
        for name, t in o["state"][tower].items():
            if name.endswith(("running_mean", "running_var")):
                assert _leaf_err(t.numpy(), after[name].numpy()) \
                    <= STATS_TOL, name
    assert compared >= 45


# ------------------------------------------------------ optimizer labels
@pytest.mark.parametrize("backbone,agg", [("resnet18conv4", "crn"),
                                          ("vit", "netvlad"),
                                          ("cct384", "gem")])
@pytest.mark.parametrize("crn,freeze", [(True, None), (False, 1),
                                        (True, 0)])
def test_group_labels_match_jax(backbone, agg, crn, freeze):
    x = np.zeros((1, 32, 32, 3), np.float32)
    net = JaxNet(backbone=backbone, aggregation=agg, netvlad_clusters=4,
                 trunc_te=2)
    params = jax.eval_shape(net.init, jax.random.PRNGKey(0), x)["params"]
    tree = {"mm": params, "db": {"net": params}}
    labels_j = {tuple(str(k.key) for k in path): lab for path, lab in
                jax.tree_util.tree_flatten_with_path(
                    jax_optim.label_params(tree, crn=crn,
                                           freeze_te=freeze))[0]}
    port = GeoLocalizationNet(backbone, agg, 4, trunc_te=2,
                              image_hw=(32, 32))
    named = ([(f"mm.{n}", p) for n, p in port.named_parameters()]
             + [(f"db.{n}", p) for n, p in GeoDB(port).named_parameters()])
    labels = optim.label_params(named, crn, freeze)
    assert {flax_path(n, p): labels[n] for n, p in named} == labels_j
    if freeze is not None:
        assert "frozen" in labels.values()


# --------------------------------------------- the NetVLAD init from data
@pytest.mark.parametrize("which", ["query", "db"])
def test_netvlad_init_from_dataset_matches_jax(which):
    cfg_j, cfg = _cfgs()
    ds_j = JaxSynthetic(n_db=24, n_q=16, image_size=32, seed=0)
    ds = SyntheticDataset(n_db=24, n_q=16, image_size=32, seed=0)
    rng = np.random.default_rng(1)
    x = np.zeros((2, 32, 32, 3), np.float32)
    net = JaxNet(backbone="resnet18conv4", aggregation="netvlad",
                 netvlad_clusters=4)
    v = random_variables(net, rng, x)
    port = load_jax_variables(GeoLocalizationNet(
        "resnet18conv4", "netvlad", 4, image_hw=(32, 32)), v).eval()
    if which == "db":
        v = {c: {"net": v[c]} for c in v}
        port = GeoDB(port)
    got_v = jax_netvlad_init(cfg_j, v, ds_j, seed=3, tower=which)
    # JAX's k-means starts from jax.random.choice over its descriptors:
    # 16 images (24 tiles) x 4 descriptors of a 2 x 2 map
    n_desc = 4 * (16 if which == "query" else 24)
    init_idx = np.asarray(jax.random.choice(jax.random.PRNGKey(3), n_desc,
                                            shape=(4,), replace=False))
    initialize_netvlad_from_dataset(cfg, port, ds, seed=3, which=which,
                                    init_idx=init_idx)
    head_j = (got_v["params"]["net"] if which == "db"
              else got_v["params"])["aggregation"]["netvlad"]
    head = (port.net if which == "db" else port).aggregation.netvlad
    for name in ("centroids", "assign_w"):
        want = np.asarray(head_j[name])
        assert _leaf_err(getattr(head, name).detach().numpy(), want) \
            <= 1e-5, name


def test_netvlad_init_refused_for_token_backbones_as_jax():
    _, cfg = _cfgs()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, backbone="vit",
                                                trunc_te=1))
    ds = SyntheticDataset(n_db=8, n_q=4, image_size=32, seed=0)
    with pytest.raises(NotImplementedError, match="backbone=vit"):
        init_state(cfg, "cpu", train_ds=ds)


def test_check_pretrained_names_the_geoloc_backbone(caplog, monkeypatch):
    monkeypatch.delenv("AGPLACE_WEIGHTS", raising=False)
    _, cfg = _cfgs()
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, pretrained=True, backbone="resnet50conv4"))
    with caplog.at_level("WARNING", logger="train"):
        check_pretrained(cfg)
    assert any("resnet50conv4" in r.getMessage() for r in caplog.records)
    assert not any("resnet18" in r.getMessage() for r in caplog.records)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                pretrained_path="/w"))
    with pytest.raises(NotImplementedError, match="does not load"):
        check_pretrained(cfg)


# ------------------------------------------------------- the entry points
def test_train_then_test_entry_points(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    save = str(tmp_path / "run")
    common = ["--dataset", "synthetic", "--device", "cpu", "--q_resize",
              "32", "--modelq", "geoloc", "--modeldb", "geoloc",
              "--backbone", "resnet18conv4", "--aggregation", "netvlad",
              "--netvlad_clusters", "4", "--pretrained", "false",
              "--save_dir", save]

    def run(module, *args):
        p = subprocess.run(
            [sys.executable, "-m", f"agplace_tpu_torch.{module}", *common,
             *args], cwd=str(tmp_path), env=env, capture_output=True,
            text=True, timeout=600)
        assert p.returncode == 0, p.stderr[-3000:]
        return p.stdout

    run("train", "--train_batch_size", "2", "--negs_num_per_query", "2",
        "--queries_per_epoch", "4", "--cache_refresh_rate", "4",
        "--neg_samples_num", "8", "--epochs_num", "1")
    with open(os.path.join(save, "metrics.jsonl")) as f:
        epoch = json.loads(f.readline())
    assert epoch["steps"] == 2 and np.isfinite(epoch["losses"]).all()
    out = run("test", "--resume", "best_model")
    r = epoch["recalls"]
    assert out.strip().splitlines()[-1] == (
        f"R@1: {r[0]:.1f}, R@5: {r[1]:.1f}, R@10: {r[2]:.1f}, "
        f"R@20: {r[3]:.1f}")
