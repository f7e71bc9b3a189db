"""The port's single-device tail held against the JAX package on the CPU:
the batch-hard metric losses (values and gradients against ``jax.grad``),
the folder dataset and ``PCADataset`` (items bit-equal on
``tests/test_aux.py``'s layout, ``evaluate``'s recalls equal), the
point-cloud augmentations and projections (bit-equal from the same
``np.random.Generator``), ``get_flops`` and the figures of ``utils/viz``
(equal pixel arrays).

Tolerances, fractions of max |JAX|: losses and statistics 1e-6, their
gradients 1e-5 (fp32 in both, distances summed in other orders; measured
<= 2.1e-7 and <= 3.3e-7).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from agplace_tpu.config import synthetic_config as jax_synthetic
from agplace_tpu.data import folder_dataset as jfd
from agplace_tpu.data import pc_augment as jpa
from agplace_tpu.data import projections as jpr
from agplace_tpu.train import metric_losses as jml
from agplace_tpu.utils import viz as jviz
from agplace_tpu_torch.config import synthetic_config
from agplace_tpu_torch.data import folder_dataset as pfd
from agplace_tpu_torch.data import pc_augment as ppa
from agplace_tpu_torch.data import projections as ppr
from agplace_tpu_torch.train import metric_losses as pml
from agplace_tpu_torch.utils import viz as pviz
from agplace_tpu_torch.utils.flops import cost_analysis, get_flops
from test_aux import folder_root  # noqa: F401  (the fixture)

torch.set_num_threads(2)

LOSS_TOL, GRAD_TOL = 1e-6, 1e-5


def close(got, want, tol, what=""):
    if isinstance(got, torch.Tensor):
        got = got.detach()
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, (what, err)


# ---------------------------------------------------------- metric losses
def _batch(seed, n=24, c=16):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, c)).astype(np.float32)
    eastnorth = rng.uniform(0, 60, (n, 2))
    return emb, eastnorth


@pytest.mark.parametrize("swap", [True, False])
@pytest.mark.parametrize("normalize", [True, False])
def test_batch_hard_loss_and_gradient_match_jax(swap, normalize):
    emb, en = _batch(0)
    pos, neg = pml.masks_from_eastnorth(en, 12.0, 20.0)
    pos_j, neg_j = jml.masks_from_eastnorth(en, 12.0, 20.0)
    np.testing.assert_array_equal(pos, pos_j)
    np.testing.assert_array_equal(neg, neg_j)
    assert (~pos.any(1)).any()  # anchors with no positive contribute 0

    def jax_loss(e):
        return jml.batch_hard_triplet_loss(e, pos_j, neg_j, 0.3, normalize,
                                           swap)

    (want, want_stats), want_g = jax.value_and_grad(jax_loss, has_aux=True)(
        jnp.asarray(emb))
    x = torch.from_numpy(emb).requires_grad_()
    got, stats = pml.batch_hard_triplet_loss(
        x, torch.from_numpy(pos), torch.from_numpy(neg), 0.3, normalize,
        swap)
    got.backward()
    close(got.detach(), want, LOSS_TOL, "loss")
    close(x.grad, want_g, GRAD_TOL, "grad")
    assert set(stats) == set(want_stats)
    for k in stats:
        close(stats[k], want_stats[k], LOSS_TOL, k)


def test_multi_batch_hard_loss_matches_jax():
    emb, en = _batch(1)
    rng = np.random.default_rng(2)
    outs = {"embedding": emb,
            "cloud_embedding": rng.standard_normal(emb.shape).astype(
                np.float32),
            "image_embedding": None}
    pos, neg = pml.masks_from_eastnorth(en)
    w = (1.0, 0.5, 0.25)

    def jax_loss(e, c):
        return jml.multi_batch_hard_triplet_loss(
            {"embedding": e, "cloud_embedding": c, "image_embedding": None},
            pos, neg, 0.2, w)

    (want, want_stats), (ge, gc) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(emb), jnp.asarray(outs["cloud_embedding"]))
    t = {k: None if v is None else torch.from_numpy(v).requires_grad_()
         for k, v in outs.items()}
    got, stats = pml.multi_batch_hard_triplet_loss(
        t, torch.from_numpy(pos), torch.from_numpy(neg), 0.2, w)
    got.backward()
    close(got.detach(), want, LOSS_TOL, "loss")
    close(t["embedding"].grad, ge, GRAD_TOL, "grad final")
    close(t["cloud_embedding"].grad, gc, GRAD_TOL, "grad cloud")
    assert set(stats) == set(want_stats)
    assert not any(k.startswith("image_") for k in stats)


# --------------------------------------------------------- folder dataset
def _configs(image_size=32, **data):
    out = []
    for make in (jax_synthetic, synthetic_config):
        cfg = make(image_size=image_size)
        out.append(cfg.replace(data=dataclasses.replace(cfg.data, **data))
                   if data else cfg)
    return out


def _with_method(cfg, method):
    return cfg.replace(eval=dataclasses.replace(cfg.eval,
                                                test_method=method))


@pytest.mark.parametrize("method", ["hard_resize", "central_crop",
                                    "single_query"])
def test_folder_items_equal_jax(folder_root, method):  # noqa: F811
    cfg_j, cfg = (_with_method(c, method) for c in _configs())
    ours = pfd.FolderDataset(cfg, folder_root, "train")
    ref = jfd.FolderDataset(cfg_j, folder_root, "train")
    assert (ours.database_num, ours.queries_num) == (8, 4)
    np.testing.assert_array_equal(ours.db_eastnorth, ref.db_eastnorth)
    np.testing.assert_array_equal(ours.q_eastnorth, ref.q_eastnorth)
    for a, b in ((ours.soft_positives_per_query,
                  ref.soft_positives_per_query),
                 (ours.hard_positives_per_query,
                  ref.hard_positives_per_query)):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    for i in range(4):
        np.testing.assert_array_equal(ours.load_query_image(i),
                                      ref.load_query_image(i))
        np.testing.assert_array_equal(ours.load_query_crops(i, 24),
                                      ref.load_query_crops(i, 24))
        np.testing.assert_array_equal(ours.load_query_points(i),
                                      ref.load_query_points(i))
    for i in (0, 7):
        np.testing.assert_array_equal(ours.load_db_maps(i),
                                      ref.load_db_maps(i))
    p_ours, p_ref = pfd.PCADataset(ours, 6, seed=3), jfd.PCADataset(ref, 6,
                                                                    seed=3)
    assert p_ours.paths == p_ref.paths and len(p_ours) == 6
    for i in range(6):
        np.testing.assert_array_equal(p_ours[i], p_ref[i])


def test_folder_norms_and_bad_names(tmp_path, folder_root):  # noqa: F811
    mean, std = (0.5, 0.4, 0.3), (0.2, 0.25, 0.3)
    cfg_j, cfg = _configs(norm_mean=mean, norm_std=std)
    ours = pfd.FolderDataset(cfg, folder_root, "train", imagenet_norm=False)
    ref = jfd.FolderDataset(cfg_j, folder_root, "train", imagenet_norm=False)
    assert ours.mean == mean and ours.std == std
    np.testing.assert_array_equal(ours.load_db_maps(3), ref.load_db_maps(3))
    bad = tmp_path / "bad" / "images" / "train" / "database"
    bad.mkdir(parents=True)
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(bad / "x@1.jpg")
    for mod, c in ((pfd, cfg), (jfd, cfg_j)):
        with pytest.raises(ValueError, match="cannot parse"):
            mod.FolderDataset(c, str(tmp_path / "bad"), "train")


@pytest.mark.parametrize("flag", [
    dict(horizontal_flip=True), dict(rand_perspective=0.3),
    dict(random_resized_crop=0.4), dict(random_rotation=15.0),
    dict(horizontal_flip=True, random_rotation=10.0)],
    ids=["flip", "perspective", "resized-crop", "rotation", "flip+rot"])
def test_folder_query_augmentation_flags_route_as_jax(folder_root, flag):  # noqa: F811,E501
    """The augmentation flags change the training queries (and only
    them), the same draws as JAX's from ``default_rng(cfg.train.seed)``."""
    cfg_j, cfg = _configs(**flag)
    _, plain = _configs()
    ours = pfd.FolderDataset(cfg, folder_root, "train")
    ref = jfd.FolderDataset(cfg_j, folder_root, "train")
    base = pfd.FolderDataset(plain, folder_root, "train")
    seq = [ours.load_query_image(i % 4) for i in range(6)]
    for i, img in enumerate(seq):
        np.testing.assert_array_equal(img, ref.load_query_image(i % 4))
    assert any(not np.array_equal(img, base.load_query_image(i % 4))
               for i, img in enumerate(seq))
    np.testing.assert_array_equal(ours.load_db_maps(1), base.load_db_maps(1))
    test_split = pfd.FolderDataset(cfg, folder_root, "train")
    test_split._augment = False  # what the test split does
    np.testing.assert_array_equal(test_split.load_query_image(0),
                                  base.load_query_image(0))


def test_folder_evaluate_recalls_equal_jax(tmp_path):
    """Recall@N of a GeoLoc pair over a seeded folder tree equals JAX's
    with the same weights."""
    import sys

    from agplace_tpu import evaluate as jax_evaluate
    from agplace_tpu.train.step import make_infer_fns as jax_fns
    from agplace_tpu_torch import evaluate
    from agplace_tpu_torch.infer import build_towers, make_infer_fns
    from agplace_tpu_torch.utils.convert import load_jax_variables
    from test_torch_port_families import configs, jax_towers

    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    from scripts.write_torch_trees import folder_tree

    root = folder_tree(str(tmp_path / "tree"), n_db=12, n_q=6, size=40,
                       split="test")
    cfg_j, cfg = configs(model=dict(modelq="geoloc"),
                         db=dict(modeldb="geoloc"), image_size=32)
    rng = np.random.default_rng(0)
    img = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    _, qv, _, dv = jax_towers(cfg_j, rng, img, img[:, None],
                              np.zeros((2, 1, 3), np.float32))
    mm, db = build_towers(cfg, "cpu")
    load_jax_variables(mm, qv)
    load_jax_variables(db, dv)
    got = evaluate.evaluate(cfg, pfd.FolderDataset(cfg, root, "test"),
                            *make_infer_fns(mm, db), device="cpu")
    params = {"mm": qv["params"], "db": dv["params"]}
    stats = {"mm": qv.get("batch_stats", {}),
             "db": dv.get("batch_stats", {})}
    want = jax_evaluate.evaluate(cfg_j, jfd.FolderDataset(cfg_j, root,
                                                          "test"),
                                 params, stats, *jax_fns(cfg_j))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] and got[0][-1] > 0


# ------------------------------------------- point clouds and projections
def _cloud(seed, n=400):
    rng = np.random.default_rng(seed)
    pc = rng.uniform(-40, 40, (n, 3)).astype(np.float32)
    pc[-30:] = np.nan
    return pc


@pytest.mark.parametrize("name,kw", [
    ("random_flip", {}), ("random_rotation", {"axis": 0, "max_deg": 30.0}),
    ("random_rotation", {}), ("random_translation", {}),
    ("random_scale", {}), ("random_shear", {}), ("jitter_points", {}),
    ("remove_random_points", {"ratio": 0.2}), ("remove_random_block", {})])
def test_pc_augment_bit_equal(name, kw):
    for seed in range(3):
        got = getattr(ppa, name)(_cloud(seed), np.random.default_rng(seed),
                                 **kw)
        want = getattr(jpa, name)(_cloud(seed), np.random.default_rng(seed),
                                  **kw)
        np.testing.assert_array_equal(got, want)
    nan = np.full((10, 3), np.nan, np.float32)
    np.testing.assert_array_equal(
        ppa.remove_random_block(nan, np.random.default_rng(0)), nan)


@pytest.mark.parametrize("seed", [0, 1])
def test_projections_bit_equal(seed):
    pc = _cloud(seed) * np.float32(3)  # some points past max_thd
    np.testing.assert_array_equal(ppr.generate_bev_from_pc(pc, 64, 100.0),
                                  jpr.generate_bev_from_pc(pc, 64, 100.0))
    np.testing.assert_array_equal(ppr.generate_sph_from_pc(pc),
                                  jpr.generate_sph_from_pc(pc))
    empty = np.full((5, 3), np.nan, np.float32)
    assert not ppr.generate_bev_from_pc(empty).any()
    assert not ppr.generate_sph_from_pc(empty).any()


# ------------------------------------------------------------ flops, viz
def test_flops_counts_matmul():
    """``test_aux.py``'s check: a 32 x 32 matmul is 2 * 32^3 FLOPs, and
    the keys the counter cannot give are -1.0, JAX's missing-key value."""
    assert get_flops(lambda x: x @ x, torch.ones(32, 32)) == 2 * 32 ** 3
    conv = torch.nn.Conv2d(3, 8, 3)
    assert get_flops(conv, torch.ones(2, 3, 10, 10)) == 2 * 2 * 8 * 3 * 9 * 64
    costs = cost_analysis(lambda x: x @ x, torch.ones(4, 4))
    assert costs == {"flops": 128.0, "bytes_accessed": -1.0,
                     "transcendentals": -1.0}


def test_viz_figures_equal_jax(tmp_path):
    rng = np.random.default_rng(1)
    pc = rng.uniform(-10, 10, (500, 3)).astype(np.float32)
    pc[450:] = np.nan
    q = rng.random((32, 32, 3))
    pairs = [
        (pviz.viz_lidar([pc, pc * 0.5], out_path=str(tmp_path / "a.png")),
         jviz.viz_lidar([pc, pc * 0.5], out_path=str(tmp_path / "b.png"))),
        (pviz.viz_retrievals(q, [q, 1 - q], [True, False],
                             out_path=str(tmp_path / "c.png")),
         jviz.viz_retrievals(q, [q, 1 - q], [True, False],
                             out_path=str(tmp_path / "d.png"))),
        (pviz.viz_retrievals(q, [], [], out_path=str(tmp_path / "e.png")),
         jviz.viz_retrievals(q, [], [], out_path=str(tmp_path / "f.png"))),
    ]
    for got, want in pairs:
        a, b = np.asarray(Image.open(got)), np.asarray(Image.open(want))
        assert a.shape == b.shape and a.size > 0
        np.testing.assert_array_equal(a, b)
