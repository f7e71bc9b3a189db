"""The port's training loop and entry point on the CPU: ``train`` writes
its metrics and a checkpoint under JAX's name, the checkpoint restores the
trained parameters and serves (``PlaceIndex.from_checkpoint``); ``python
-m agplace_tpu_torch.train`` runs on the synthetic world, refuses the
flags it does not honour and needs a card unless asked for the CPU; its
flag table is JAX's.  The slow tier shows that training raises recall,
as ``tests/test_train.py`` does for JAX."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import agplace_tpu.config as jax_config
from agplace_tpu_torch import config
from agplace_tpu_torch.data.synthetic import SyntheticDataset
from agplace_tpu_torch.train import cli
from agplace_tpu_torch.train.checkpoint import CheckpointManager
from agplace_tpu_torch.train.loop import train
from agplace_tpu_torch.train.step import init_state

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(save_dir, **train_kw):
    cfg = config.synthetic_config(batch_size=2, image_size=32,
                                  vox_max_points=128)
    return cfg.replace(
        model=dataclasses.replace(cfg.model, pretrained=False),
        data=dataclasses.replace(cfg.data, num_workers=2),
        train=dataclasses.replace(cfg.train, save_dir=str(save_dir),
                                  **train_kw))


def _world():
    return (SyntheticDataset(n_db=24, n_q=16, image_size=32, seed=0),
            SyntheticDataset(n_db=24, n_q=12, image_size=32, seed=1))


def test_train_writes_metrics_and_a_checkpoint_that_restores(tmp_path):
    from agplace_tpu_torch.serving import PlaceIndex

    cfg = _cfg(tmp_path)
    train_ds, test_ds = _world()
    out = train(cfg, train_ds, test_ds, max_steps=2, device="cpu")
    state = out["state"]
    assert state.step == 2 and state.opt.count == 2
    (rec,) = [json.loads(line) for line in
              open(tmp_path / "metrics.jsonl")]
    assert rec["epoch"] == 0 and len(rec["losses"]) == 2
    assert np.isfinite(rec["losses"]).all() and rec["is_best"]
    assert set(rec["phase_times"]) == {"mining", "train", "eval"}
    recalls = out["history"][0]["recalls"]
    name = f"ep@0__r1@{recalls[0]:.0f}"  # JAX's checkpoint name
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["metrics.jsonl", name, "best_model"])
    assert CheckpointManager(str(tmp_path)).latest() == name

    other = init_state(cfg, "cpu", seed=123)  # other weights
    restored, meta = CheckpointManager(str(tmp_path)).restore(name, other)
    assert meta["epoch_num"] == 0
    np.testing.assert_allclose(meta["recalls"], recalls)
    for (n, a), (_, b) in zip(state.named_parameters(),
                              restored.named_parameters()):
        assert torch.equal(a, b), n
    for tower in ("mm", "db"):
        want = getattr(state, tower).state_dict()
        for n, t in getattr(restored, tower).state_dict().items():
            assert torch.equal(t, want[n]), n
    assert restored.step == 2 and torch.equal(restored.opt.mu, state.opt.mu)

    idx = PlaceIndex.from_checkpoint(cfg, str(tmp_path), "best_model",
                                     "cpu")
    idx.add_tiles(test_ds)
    pts = np.stack([test_ds.load_query_points(i) for i in range(2)])
    imgs = np.stack([test_ds.load_query_image(i) for i in range(2)])
    d, i = idx.search(imgs, pts, k=3)
    assert d.shape == i.shape == (2, 3) and np.isfinite(d).all()
    for tower in (state.mm, state.db):
        tower.eval()
    want = idx._embed_q  # the served towers embed as the trained ones
    from agplace_tpu_torch.data.voxels import prepare_query_vox
    from agplace_tpu_torch.infer import make_infer_fns

    vox = prepare_query_vox(cfg, pts, "cpu")
    ref_q, _ = make_infer_fns(state.mm, state.db)
    torch.testing.assert_close(want(torch.from_numpy(imgs), vox),
                               ref_q(torch.from_numpy(imgs), vox),
                               rtol=0, atol=0)


def test_resume_continues_from_the_checkpoint(tmp_path):
    """Resume from the latest checkpoint; the first run also writes the
    profiler trace of its first step (``profile_steps``)."""
    cfg = _cfg(tmp_path, profile_steps=1)
    train_ds, test_ds = _world()
    train(cfg, train_ds, test_ds, max_steps=1, device="cpu")
    trace = json.load(open(tmp_path / "profile" / "trace.json"))
    assert trace["traceEvents"]
    name = CheckpointManager(str(tmp_path)).latest()
    cfg2 = cfg.replace(train=dataclasses.replace(cfg.train, resume=name,
                                                 epochs_num=2))
    out = train(cfg2, train_ds, test_ds, max_steps=1, device="cpu")
    assert [h["epoch"] for h in out["history"]] == [1]
    assert out["state"].step == 2  # one restored + one new


TINY_FLAGS = ["--dataset", "synthetic", "--q_resize", "32",
              "--train_batch_size", "2", "--infer_batch_size", "4",
              "--negs_num_per_query", "2", "--queries_per_epoch", "4",
              "--cache_refresh_rate", "4", "--neg_samples_num", "8",
              "--vox_max_points", "128", "--epochs_num", "1",
              "--pretrained", "false", "--num_workers", "2"]


def test_entry_point_runs_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, "-m", "agplace_tpu_torch.train", *TINY_FLAGS,
         "--save_dir", str(tmp_path), "--device", "cpu"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "Best: R@1" in open(tmp_path / "info.log").read()
    assert any(f.startswith("ep@0") for f in os.listdir(tmp_path))


@pytest.mark.parametrize("flag", [["--color_jitter", "0.1"],
                                  ["--odeint_rtol", "1"],
                                  ["--patience", "3"],
                                  ["--read_pc", "false"]])
def test_a_flag_not_honoured_raises(flag):
    """Every flag of the table is honoured now: these four, refused
    before, parse as JAX's do; what still raises is a multi-device
    flag above 1."""
    argv = ["--dataset", "synthetic", *flag]
    ours, _ = config.parse_arguments(argv)
    assert dataclasses.asdict(ours) == dataclasses.asdict(
        jax_config.parse_arguments(argv))
    with pytest.raises(NotImplementedError, match="one card"):
        init_state(config.parse_arguments(
            [*argv, "--data_parallel", "2"])[0], "cpu")


def test_real_datasets_and_missing_card_raise(monkeypatch, tmp_path):
    from agplace_tpu_torch.data.kitti360 import KITTI360Dataset
    from agplace_tpu_torch.data.nuscenes import NuScenesDataset

    # the readers are built for the real datasets (a tree without drives
    # gives empty splits, as JAX's reader does)
    cfg, _ = config.parse_arguments(["--dataset", "kitti360", "--dataroot",
                                     str(tmp_path)])
    assert all(isinstance(ds, KITTI360Dataset) and ds.queries_num == 0
               for ds in cli.build_datasets(cfg))
    nusc = tmp_path / "nuscenes"
    nusc.mkdir()
    for split, version in (("train", "v1.0-trainval"),
                           ("test", "v1.0-test")):
        (nusc / f"agplace_index_{version}_{split}.json").write_text(
            '{"queries": []}')
    cfg, _ = config.parse_arguments(["--dataset", "nuscenes", "--dataroot",
                                     str(nusc)])
    assert all(isinstance(ds, NuScenesDataset)
               for ds in cli.build_datasets(cfg))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([*TINY_FLAGS, "--save_dir", str(tmp_path)])


def test_flag_table_and_parsing_equal_the_jax_packages():
    assert config.FLAG_TABLE == jax_config._FLAG_TABLE
    argv = [*TINY_FLAGS, "--lr", "3e-4", "--mining", "random",
            "--final_type", "imageorg_stg2image", "--compute_dtype",
            "bfloat16", "--recall_values", "1_5"]
    ours, _ = config.parse_arguments(argv)
    ref = jax_config.parse_arguments(argv)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


def test_unsupported_training_options_raise(monkeypatch, tmp_path):
    cfg = _cfg(tmp_path)
    # share_qdb with the MM, and a query tower twice as wide as the
    # aerial tower's descriptors: JAX fails on both
    for model_kw in ({"share_qdb": True}, {"modelq": "minkloc_multimodal"}):
        bad = cfg.replace(model=dataclasses.replace(cfg.model, **model_kw))
        with pytest.raises(NotImplementedError):
            init_state(bad, "cpu")
    # pretrained: a source in $AGPLACE_WEIGHTS is grafted into the MM's
    # and the aerial tower's image branches; with none, random-init
    from scripts.write_torch_weights import seeded_state_dict

    pre = cfg.replace(model=dataclasses.replace(cfg.model, pretrained=True))
    sd = seeded_state_dict("resnet18", 5)
    torch.save(sd, tmp_path / "resnet18-seeded.pth")
    monkeypatch.setenv("AGPLACE_WEIGHTS", str(tmp_path))
    mm, db = init_state(pre, "cpu").towers
    for fe in (mm.image_fe.fe, db.fe_0.fe):
        assert torch.equal(fe.conv1.weight, sd["conv1.weight"])
        assert torch.equal(fe.bn1.running_mean, sd["bn1.running_mean"])
    monkeypatch.delenv("AGPLACE_WEIGHTS")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    mm, _ = init_state(pre, "cpu").towers  # no source: warn, random-init
    ref, _ = init_state(cfg, "cpu").towers
    assert torch.equal(mm.image_fe.fe.conv1.weight,
                       ref.image_fe.fe.conv1.weight)


@pytest.mark.slow
def test_end_to_end_training_improves_recall(tmp_path):
    """The integration recipe of ``tests/test_train.py``: from the same
    initial weights (JAX's ``init_state`` at key 0, converted), 7 epochs
    of 16 queries at learning rates of 1e-3; the best R@5 reaches the
    untrained towers' and the loss falls."""
    import jax

    from agplace_tpu.data.base import collate_train as jax_collate
    from agplace_tpu.data.synthetic import SyntheticDataset as JaxSynthetic
    from agplace_tpu.train.mining import TripletMiner as JaxMiner
    from agplace_tpu.train.step import init_state as jax_init_state
    from agplace_tpu_torch.evaluate import evaluate
    from agplace_tpu_torch.infer import make_infer_fns
    from agplace_tpu_torch.utils.convert import load_jax_variables

    cfg = _cfg(tmp_path, epochs_num=7, queries_per_epoch=16,
               cache_refresh_rate=8, lr=1e-3, lrpc=1e-3, lrdb=1e-3)
    cfg_j = jax_config.synthetic_config(batch_size=2, image_size=32,
                                        vox_max_points=128)
    train_ds, test_ds = _world()
    ds_j = JaxSynthetic(n_db=24, n_q=16, image_size=32, seed=0)
    rng = np.random.default_rng(0)
    batch = jax_collate(ds_j, JaxMiner(cfg_j, ds_j).mine_random(rng, 2),
                        cfg_j, rng)
    state_j = jax_init_state(cfg_j, jax.random.PRNGKey(0), batch)
    state0 = init_state(cfg, "cpu")
    for tower, mod in (("mm", state0.mm), ("db", state0.db)):
        load_jax_variables(mod, jax.tree_util.tree_map(np.array, {
            "params": state_j.params[tower],
            "batch_stats": state_j.batch_stats[tower]}))
    r0, _ = evaluate(cfg, test_ds, *make_infer_fns(*state0.towers),
                     device="cpu")
    out = train(cfg, train_ds, test_ds, state=state0, device="cpu")
    best_r5 = max(h["recalls"][1] for h in out["history"])
    assert best_r5 >= r0[1] or r0[1] == 100.0
    losses = [h["loss"] for h in out["history"]]
    assert losses[-1] < losses[0]
    assert len(out["history"]) == 7
