"""The port's data-parallel train step held against JAX's single-device
step (JAX's own data-parallel test, ``tests/test_parallel.py:35``, is
slow: a GSPMD step over the batch computes the same global step) at
``synthetic_config(batch_size=8, image_size=32, vox_max_points=64,
negs=2)``: the same weights (JAX's ``init_state``), the same batch, one
step, in 2 gloo processes (the batch split 4 + 4) and in 3 (the data
width resolves to 2: rank 2 runs the single-device step on the whole
batch).  Both frameworks run the fp32 twin of the model (the BEV convs in
fp32: ``tests/test_torch_port_train_step.py`` says why).  JAX's
tolerances (``tests/test_parallel.py:73-84``): the loss rtol 1e-4 / atol
1e-5, every parameter atol 5e-4 after the Adam step, and the BN running
statistics within 1e-4; every gradient leaf (captured from JAX's step as
``tests/test_torch_port_train_step.py`` does) within GRAD_TOL of its
scale.  The data ranks end bit-equal; the rank outside the data mesh
equals the port's single-device step."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import _torch_parallel_worker as worker
from agplace_tpu.config import synthetic_config as jax_synthetic_config
from agplace_tpu.data.base import collate_train as jax_collate_train
from agplace_tpu.data.synthetic import SyntheticDataset as JaxSynthetic
from agplace_tpu.train.mining import TripletMiner as JaxMiner
from agplace_tpu.train.step import (init_state as jax_init,
                                    make_train_step as jax_step)
from agplace_tpu_torch.data.base import collate_train
from agplace_tpu_torch.data.pipeline import prefetch_to_device
from agplace_tpu_torch.data.synthetic import SyntheticDataset
from agplace_tpu_torch.train.mining import TripletMiner
from agplace_tpu_torch.train.step import init_state, make_train_step
from agplace_tpu_torch.utils.convert import jax_to_state_dict
from test_torch_port_train_step import (_capturing_step, _copy, _fp32_bev,
                                       _leaf_err, _load)

torch.set_num_threads(2)

WORLDS = (2, 3)
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-5
PARAM_ATOL = 5e-4
STATS_TOL = 1e-4
# JAX's gradient leaf by leaf, a fraction of the leaf's scale: measured
# 4.5e-5 (the data ranks; the port's single-device step at this batch is
# 2.8e-3 from JAX on db.fe_0.fe.layer2_1.conv2.weight, whose gradient
# cancels before a train-mode BN)
GRAD_TOL = 5e-4
ZERO_REL = 1e-6


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp_step")
    kw = dict(batch_size=8, image_size=32, vox_max_points=64, negs=2)
    cfg_j = jax_synthetic_config(**kw)
    cfg_j = cfg_j.replace(model=dataclasses.replace(cfg_j.model,
                                                    pretrained=False))
    cfg = worker.world_cfg(batch_size=8)
    ds_j = JaxSynthetic(n_db=16, n_q=16, image_size=32, n_points=64, seed=0)
    ds = SyntheticDataset(n_db=16, n_q=16, image_size=32, n_points=64,
                          seed=0)
    rng_j, rng = np.random.default_rng(0), np.random.default_rng(0)
    rows_j = JaxMiner(cfg_j, ds_j).mine_random(rng_j, 8)
    rows = TripletMiner(cfg, ds, "cpu").mine_random(rng, 8)
    np.testing.assert_array_equal(rows, rows_j)
    batch_j = jax_collate_train(ds_j, rows_j, cfg_j, rng_j)
    batch = collate_train(ds, rows, cfg, rng)

    state_j = jax_init(cfg_j, jax.random.PRNGKey(0), batch_j)
    state = init_state(cfg, "cpu")
    _load(state, state_j.params, state_j.batch_stats)
    for w in WORLDS:
        (out / f"w{w}").mkdir()
        torch.save({"state": state.state_dict(), "batch": batch},
                   out / f"w{w}" / "inputs.pt")
    started = {w: worker.Ranks("train_step", w, out / f"w{w}")
               for w in WORLDS}

    captured = []
    with pytest.MonkeyPatch.context() as mp:
        _fp32_bev(mp)
        state_j, m_j = _capturing_step(cfg_j, captured)(state_j, batch_j)
        jax.effects_barrier()
    worker.fp32_twin(state)
    m = make_train_step(cfg)(state, next(prefetch_to_device([batch],
                                                            "cpu")))
    single = {"loss": float(m["loss"]), "state": state.state_dict(),
              "grads": worker.applied_grads(state)}
    want = {}
    for tower, mod in (("mm", state.mm), ("db", state.db)):
        sd = jax_to_state_dict({"params": _copy(state_j.params[tower]),
                                "batch_stats": _copy(
                                    state_j.batch_stats[tower])}, mod)
        want.update({f"{tower}.{k}": v for k, v in sd.items()})
    grads_j = {}
    for tower, mod in (("mm", state.mm), ("db", state.db)):
        sd = jax_to_state_dict({"params": captured[-1][tower],
                                "batch_stats": _copy(
                                    state_j.batch_stats[tower])}, mod)
        grads_j.update({f"{tower}.{k}": v for k, v in sd.items()})
    return {"loss_j": float(m_j["loss"]), "want": want, "single": single,
            "grads_j": grads_j,
            "ranks": {w: r.results() for w, r in started.items()}}


def _flat(sd):
    return {f"{t}.{k}": v for t in ("mm", "db") for k, v in sd[t].items()}


@pytest.mark.parametrize("w", WORLDS)
def test_data_width_resolves_as_jax(world, w):
    assert [r["dp"] for r in world["ranks"][w]] == [2] * w


@pytest.mark.parametrize("w", WORLDS)
def test_data_parallel_loss_matches_jax(world, w):
    for r in world["ranks"][w]:
        np.testing.assert_allclose(r["loss"], world["loss_j"],
                                   rtol=LOSS_RTOL, atol=LOSS_ATOL)


@pytest.mark.parametrize("w", WORLDS)
def test_data_parallel_params_and_stats_match_jax(world, w):
    want = world["want"]
    for r in world["ranks"][w]:
        got = _flat(r["state"])
        assert set(got) == set(want)
        for k, v in got.items():
            ref = want[k].numpy()
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(v.numpy(), ref, rtol=STATS_TOL,
                                           atol=STATS_TOL, err_msg=k)
            else:
                np.testing.assert_allclose(v.numpy(), ref, rtol=0,
                                           atol=PARAM_ATOL, err_msg=k)


@pytest.mark.parametrize("w", WORLDS)
def test_data_parallel_gradient_matches_jax(world, w):
    """The data ranks' gradient as Adam applied it (reduced over the
    ranks) against JAX's single-device step's: every leaf within GRAD_TOL
    of its scale; the leaves zero in exact arithmetic (conv biases before
    a train-mode BN) below ZERO_REL of their tower's largest in both."""
    want = {k: world["grads_j"][k] for k in world["single"]["grads"]}
    floor = {}
    for k, g in want.items():
        t = k.split(".")[0]
        floor[t] = max(floor.get(t, 0.0), ZERO_REL * float(g.abs().max()))
    for r in world["ranks"][w][:2]:
        assert set(r["grads"]) == set(want)
        for k, g in r["grads"].items():
            if float(want[k].abs().max()) < floor[k.split(".")[0]]:
                assert float(g.abs().max()) < floor[k.split(".")[0]], k
            else:
                assert _leaf_err(g.numpy(), want[k].numpy()) <= GRAD_TOL, k


@pytest.mark.parametrize("w", WORLDS)
def test_ranks_end_with_the_same_state(world, w):
    """The data ranks hold bit-equal states; a rank outside the data mesh
    (3 ranks) the single-device step's, within the gradient
    tolerance."""
    ranks = world["ranks"][w]
    first = _flat(ranks[0]["state"])
    for k, v in _flat(ranks[1]["state"]).items():
        assert torch.equal(v, first[k]), k
    for r in ranks[2:]:
        assert r["loss"] == world["single"]["loss"]
        for k, v in _flat(r["state"]).items():
            assert torch.equal(v, _flat(world["single"]["state"])[k]), k
