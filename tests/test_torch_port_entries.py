"""The port's entry points as subprocesses on the CPU (``--device cpu``):
``python -m agplace_tpu_torch.train`` takes two steps on a KITTI-360-AG
tree (``scripts/write_torch_trees.py``), ``.test`` prints the Recall@N
line of an in-process ``evaluate`` of its checkpoint and refuses
random-init weights on a real dataset with the JAX entry point's message,
``.serve`` builds a gallery and answers ``search`` (descriptors, the
query split, int8) and two ``http`` nodes behind a fan-out search, each
line parsing as the JAX entry point's and each answer the in-process
index's.  Without ``--device`` and without a card each entry point raises
"no CUDA device"."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import torch

from agplace_tpu_torch import config
from agplace_tpu_torch.embed import batched_embed_q
from agplace_tpu_torch.evaluate import evaluate
from agplace_tpu_torch.infer import make_infer_fns
from agplace_tpu_torch.serving import PlaceIndex
from agplace_tpu_torch.train import cli
from agplace_tpu_torch.train.checkpoint import load_towers
from scripts.write_torch_trees import kitti360_tree

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--q_resize", "32", "--db_cropsize", "32", "--db_resize", "32",
         "--infer_batch_size", "4", "--vox_grid_extent", "32_32_4"]


def _env():
    return dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")


def _run(module, *args, cwd):
    p = subprocess.run([sys.executable, "-m", f"agplace_tpu_torch.{module}",
                        *args], cwd=cwd, env=_env(), capture_output=True,
                       text=True, timeout=600)
    return p


def _ok(p):
    assert p.returncode == 0, p.stderr[-3000:]
    return p.stdout


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A KITTI-360-AG tree (2 drives of 24 frames, 4 m apart) and the
    checkpoint of two training steps on it."""
    tmp = tmp_path_factory.mktemp("entries")
    root = kitti360_tree(str(tmp / "kitti"), frames=24, image_hw=(60, 224),
                         tile=64, n_points=2000, step_m=4.0)
    save = str(tmp / "run")
    data = ["--dataset", "kitti360", "--dataroot", root, *SMALL,
            "--save_dir", save]
    out = _ok(_run("train", *data, "--device", "cpu", "--train_batch_size",
                   "2", "--negs_num_per_query", "2", "--queries_per_epoch",
                   "4", "--cache_refresh_rate", "4", "--neg_samples_num",
                   "8", "--pretrained", "false", "--epochs_num", "1",
                   "--num_workers", "2", cwd=str(tmp)))
    cfg, _ = config.parse_arguments([*data, "--resume", "best_model"])
    return tmp, cfg, data + ["--resume", "best_model"], out


def test_train_takes_two_steps_on_the_reader(world):
    tmp, cfg, _, _ = world
    with open(os.path.join(cfg.train.save_dir, "metrics.jsonl")) as f:
        epoch = json.loads(f.readline())
    assert epoch["steps"] == 2 and len(epoch["losses"]) == 2
    assert np.isfinite(epoch["losses"]).all()
    assert os.path.exists(os.path.join(cfg.train.save_dir, "best_model"))


def test_test_entry_prints_the_in_process_recalls(world):
    tmp, cfg, data, _ = world
    out = _ok(_run("test", *data, "--device", "cpu", cwd=str(tmp)))
    towers, _ = load_towers(cfg, cfg.train.save_dir, "best_model", "cpu")
    _, test_ds = cli.build_datasets(cfg)
    _, recalls_str = evaluate(cfg, test_ds, *make_infer_fns(*towers),
                              device="cpu")
    assert out.strip().splitlines()[-1] == recalls_str


def test_test_entry_refuses_random_init_on_a_real_dataset(world):
    tmp, _, data, _ = world
    p = _run("test", *data[:-2], "--device", "cpu", cwd=str(tmp))
    assert p.returncode == 1
    assert p.stderr.strip().splitlines()[-1] == (
        "test.py needs --resume <checkpoint-name> (random-init eval is "
        "only allowed with --dataset synthetic)")


def _rows(out):
    """The search lines, parsed as the JAX entry point's are."""
    rows = [json.loads(line) for line in out.strip().splitlines()]
    for r, row in enumerate(rows):
        assert row["query"] == r and set(row) <= {
            "query", "indices", "sq_distances", "east_north"}
    return rows


def _same_answers(rows, d, i, pos=None):
    assert len(rows) == len(i)
    for row, dr, ir in zip(rows, d, i):
        want = [None if not np.isfinite(v) else round(float(v), 6)
                for v in dr]
        with np.errstate(invalid="ignore"):  # inf - inf past the rows
            gaps = np.diff(np.asarray(dr, np.float64))
        for j, (got_i, want_i) in enumerate(zip(row["indices"], ir)):
            near = ((j and gaps[j - 1] < 1e-4)
                    or (j < len(gaps) and gaps[j] < 1e-4))
            assert near or got_i == int(want_i), (row, ir)
        got = np.array([np.inf if v is None else v
                        for v in row["sq_distances"]])
        np.testing.assert_allclose(got, np.array(
            [np.inf if v is None else v for v in want]), rtol=0, atol=2e-4)
        if pos is not None:
            assert len(row["east_north"]) == len(ir)


@pytest.fixture(scope="module")
def gallery(world):
    tmp, _, data, _ = world
    path = str(tmp / "g.npz")
    built = json.loads(_ok(_run(
        "serve", "build", "--device", "cpu", "--gallery_out", path, *data,
        cwd=str(tmp))).strip().splitlines()[-1])
    assert built == {"gallery": path, "rows": 8, "positions": True}
    q = np.random.default_rng(0).standard_normal((3, 256)).astype(
        np.float32)
    np.save(tmp / "q.npy", q)
    return path, str(tmp / "q.npy"), q


@pytest.mark.parametrize("quant", [[], ["--quant", "int8"]])
def test_serve_search_descriptors(world, gallery, quant):
    tmp = world[0]
    path, qpath, q = gallery
    out = _ok(_run("serve", "search", "--device", "cpu", "--gallery", path,
                   "--queries", qpath, "--k", "20", *quant, cwd=str(tmp)))
    idx = PlaceIndex.from_gallery(path, device="cpu",
                                  quant=quant[1] if quant else None)
    d, i, pos = idx.locate_descriptors(q, 20)
    rows = _rows(out)
    _same_answers(rows, d, i, pos)
    assert rows[0]["indices"][-12:] == [-1] * 12  # k > 8 rows: padding
    assert rows[0]["east_north"][-1] == [None, None]


def test_serve_search_embeds_the_query_split(world, gallery):
    tmp, cfg, data, _ = world
    path = gallery[0]
    out = _ok(_run("serve", "search", "--device", "cpu", "--gallery", path,
                   "--k", "3", *data, cwd=str(tmp)))
    idx = PlaceIndex.from_checkpoint(cfg, cfg.train.save_dir, "best_model",
                                     "cpu")
    idx.load_gallery(path)
    _, test_ds = cli.build_datasets(cfg)
    q = batched_embed_q(test_ds, list(range(test_ds.queries_num)),
                        idx._embed_q, 4, cfg, "cpu")
    _same_answers(_rows(out), *idx.search_descriptors(q, 3))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serve_http_nodes_behind_a_fan_out(world, gallery):
    tmp = world[0]
    path, qpath, q = gallery
    flat = PlaceIndex.from_gallery(path, device="cpu")
    with np.load(path) as z:
        feats, pos = z["feats"], z["positions"]
    parts = []
    for name, sl in (("g0.npz", slice(0, 3)), ("g1.npz", slice(3, None))):
        part = PlaceIndex(None, device="cpu")
        part.add_descriptors(feats[sl], positions=pos[sl])
        part.save_gallery(str(tmp / name))
        parts.append(str(tmp / name))
    ports = [_free_port(), _free_port()]
    procs = []
    try:
        for port, g, quant in zip(ports, parts, ([], ["--quant", "int8"])):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "agplace_tpu_torch.serve", "http",
                 "--device", "cpu", "--gallery", g, "--port", str(port),
                 *quant], env=_env(), cwd=str(tmp), stdout=subprocess.PIPE))
        for p, port, g in zip(procs, ports, (3, 5)):
            assert json.loads(p.stdout.readline()) == {
                "serving": f"http://127.0.0.1:{port}", "rows": g}
        out = _ok(_run("serve", "search", "--gallery", ",".join(
            f"http://127.0.0.1:{p}" for p in ports), "--queries", qpath,
            "--k", "5", cwd=str(tmp)))
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            p.wait(timeout=30)
    _same_answers(_rows(out), *flat.locate_descriptors(q, 5))


@pytest.mark.parametrize("entry,argv", [
    ("train", ["--dataset", "synthetic"]),
    ("test", ["--dataset", "synthetic"]),
    ("serve", ["build", "--dataset", "synthetic", "--resume", "x"]),
    ("serve", ["search", "--gallery", "G", "--queries", "Q"]),
    ("serve", ["http", "--gallery", "G"]),
])
def test_without_device_and_card_each_entry_raises(world, gallery,
                                                   monkeypatch, entry,
                                                   argv):
    from agplace_tpu_torch import serve, test
    from agplace_tpu_torch.train.cli import main as train_main

    tmp, _, _, _ = world
    argv = [a.replace("G", gallery[0]).replace("Q", gallery[1])
            for a in argv]
    if "--dataset" in argv:
        argv += ["--save_dir", str(tmp / "nodev")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = {"train": train_main, "test": test.main, "serve": serve.main}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main[entry](argv)
