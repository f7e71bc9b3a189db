"""The factory's towers in the port held against the JAX package on the CPU:
every ``--modelq`` x ``--modeldb`` JAX builds (and ``share_qdb``), MinkLoc,
MinkLocMultimodal and ResnetFPN at JAX's small widths, the MM with the
squeezenet image branches and DBVanilla2D with the resnet50 /
convnext_tiny / squeezenet11 branches at ``synthetic_config()`` in fp32 and
bf16, and each refusal next to JAX's own failure.

Inputs and weights come from numpy seeds (the flax trees' shapes from
``jax.eval_shape`` of their inits).  Tolerances, fractions of max |JAX|:
fp32 towers with no bf16 rounding inside (GeoLoc, the aerial towers in
fp32, the MM's image vector) 1e-4 (measured <= 8.6e-7); towers through
the sparse or BEV voxel convs, which round to bf16 in both packages even
in fp32 (MinkLoc, the MM's voxel-dependent keys) 1e-2, as the MM's slice
tests (measured <= 4.5e-3; MinkLoc <= 3.6e-7); bf16 towers 5e-3
(measured <= 3.1e-3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agplace_tpu.config import synthetic_config as jax_synthetic
from agplace_tpu.data.base import prepare_query_vox as jax_prepare_query_vox
from agplace_tpu.models import factory as jf
from agplace_tpu.models.dbvanilla2d import DBVanilla2D as JaxDB
from agplace_tpu.models.minkloc import MinkLoc as JaxMinkLoc
from agplace_tpu.models.minkloc import MinkLocMultimodal as JaxMultimodal
from agplace_tpu.models.minkloc import ResnetFPN as JaxResnetFPN
from agplace_tpu.models.mm import MM as JaxMM
from agplace_tpu_torch.config import synthetic_config
from agplace_tpu_torch.data.voxels import prepare_query_vox
from agplace_tpu_torch.infer import build_towers, make_infer_fns
from agplace_tpu_torch.models.dbvanilla2d import DBVanilla2D
from agplace_tpu_torch.models.minkloc import (MinkLoc, MinkLocMultimodal,
                                              ResnetFPN)
from agplace_tpu_torch.models.mm import MM
from agplace_tpu_torch.utils.convert import load_jax_variables
from test_torch_port_mm_options import cloud, random_variables
from test_torch_port_pooling import close

torch.set_num_threads(1)

B, IMG = 2, 64
FP32, VOX, BF16 = 1e-4, 1e-2, 5e-3
KEYS = ("imagevec_org", "voxvec_org", "shallowvec_org", "stg2fusevec",
        "stg2imagevec", "stg2voxvec", "embedding")


def configs(model=None, mm=None, db=None, image_size=IMG):
    """(JAX config, port config) of ``synthetic_config()`` with overrides
    of ``model``, ``model.mm`` and ``model.db``."""
    out = []
    for make in (jax_synthetic, synthetic_config):
        cfg = make(image_size=image_size)
        m = cfg.model
        m = dataclasses.replace(
            m, pretrained=False, mm=dataclasses.replace(m.mm, **(mm or {})),
            db=dataclasses.replace(m.db, **(db or {})), **(model or {}))
        out.append(cfg.replace(model=m))
    return tuple(out)


def world(seed=0, image_size=IMG):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((B, image_size, image_size, 3)).astype(
        np.float32)
    maps = rng.standard_normal((B, 1, image_size, image_size, 3)).astype(
        np.float32)
    return rng, img, maps, cloud(rng, B, n=800)


# ------------------------------------------------- the factory, each pair
PAIRS = [("mm", "vanilla2d"), ("mm", "geoloc"), ("geoloc", "vanilla2d"),
         ("geoloc", "geoloc"), ("minkloc", "vanilla2d"),
         ("minkloc", "geoloc")]


def jax_towers(cfg_j, rng, img, maps, vox_j):
    q = jf.make_query_model(cfg_j)
    qv = random_variables(q, rng, *jf.query_args(cfg_j.model.modelq, img,
                                                  vox_j))
    db = None if cfg_j.model.share_qdb else jf.make_db_model(cfg_j)
    dv = None if db is None else random_variables(db, rng, maps)
    return q, qv, db, dv


def embed_both(cfg_j, cfg, seed=0):
    rng, img, maps, pts = world(seed, 32)
    vox_j = jax_prepare_query_vox(cfg_j, pts)
    q, qv, db, dv = jax_towers(cfg_j, rng, img, maps, vox_j)
    mq = cfg_j.model.modelq
    want_q = jax.jit(lambda v, i, x: jf.query_apply(mq, q, v, i, x)[0][
        "embedding"])(qv, img, vox_j)
    want_d = (jax.jit(lambda v, m: jf.shared_db_apply(mq, q, v, m)[0])(
        qv, maps) if db is None else jax.jit(db.apply)(dv, maps))
    mm, pdb = build_towers(cfg, "cpu")
    load_jax_variables(mm, qv)
    if pdb is not None:
        load_jax_variables(pdb, dv)
    eq, ed = make_infer_fns(mm, pdb)
    got_q = eq(torch.from_numpy(img), prepare_query_vox(cfg, pts, "cpu"))
    got_d = ed(torch.from_numpy(maps))
    return got_q.numpy(), np.asarray(want_q), got_d.numpy(), np.asarray(
        want_d)


@pytest.mark.parametrize("modelq,modeldb", PAIRS,
                         ids=[f"{q}-{d}" for q, d in PAIRS])
def test_factory_pair_matches_jax(modelq, modeldb):
    cfg_j, cfg = configs(model=dict(modelq=modelq), db=dict(modeldb=modeldb),
                         image_size=32)
    got_q, want_q, got_d, want_d = embed_both(cfg_j, cfg)
    close(got_q, want_q, FP32 if modelq == "geoloc" else VOX, "query")
    close(got_d, want_d, FP32, "db")


def test_share_qdb_embeds_tiles_with_the_query_tower():
    cfg_j, cfg = configs(model=dict(modelq="geoloc", share_qdb=True,
                                    aggregation="netvlad",
                                    netvlad_clusters=4), image_size=32)
    got_q, want_q, got_d, want_d = embed_both(cfg_j, cfg, seed=1)
    close(got_q, want_q, FP32, "query")
    close(got_d, want_d, FP32, "db")
    mm, db = build_towers(cfg, "cpu")
    assert db is None


def test_share_qdb_with_mm_refused_as_jax():
    cfg_j, cfg = configs(model=dict(share_qdb=True), image_size=32)
    with pytest.raises(NotImplementedError, match="image-only"):
        jf.shared_db_apply("mm", None, {}, jnp.zeros((1, 1, 8, 8, 3)))
    mm, db = build_towers(cfg, "cpu")
    _, ed = make_infer_fns(mm, db)
    with pytest.raises(NotImplementedError, match="image-only"):
        ed(torch.zeros(1, 1, 32, 32, 3))
    from agplace_tpu_torch.train.step import check_supported

    with pytest.raises(NotImplementedError, match="image-only"):
        check_supported(cfg)


@pytest.mark.parametrize("modeldb", ["vanilla2d", "geoloc"])
def test_minkloc_multimodal_widths_refused_where_jax_fails(modeldb):
    """MinkLocMultimodal gives 2 x features_dim descriptors, the aerial
    towers features_dim: JAX's train step fails to concatenate them (its
    trace shows it, ``jax.eval_shape``); the port refuses the pair.  With
    ``fc_output_dim`` widening a geoloc aerial tower to match, both run."""
    from agplace_tpu.data.base import collate_train as jax_collate
    from agplace_tpu.data.synthetic import SyntheticDataset
    from agplace_tpu.train.mining import TripletMiner
    from agplace_tpu.train.step import init_state, make_train_step

    cfg_j, cfg = configs(model=dict(modelq="minkloc_multimodal"),
                         db=dict(modeldb=modeldb), image_size=32)
    ds = SyntheticDataset(n_db=8, n_q=4, image_size=32, n_points=200,
                          nmap=1, seed=0)
    rng = np.random.default_rng(0)
    batch = jax_collate(ds, TripletMiner(cfg_j, ds).mine_random(
        rng, cfg_j.train.train_batch_size), cfg_j, rng)
    state = jax.eval_shape(lambda: init_state(
        cfg_j, jax.random.PRNGKey(0), batch))
    with pytest.raises(TypeError, match="concatenate"):
        jax.eval_shape(make_train_step(cfg_j), state, batch)
    with pytest.raises(NotImplementedError, match="TypeError"):
        build_towers(cfg, "cpu")
    if modeldb == "geoloc":
        _, cfg = configs(model=dict(modelq="minkloc_multimodal",
                                    fc_output_dim=512),
                         db=dict(modeldb="geoloc"), image_size=32)
        mm, db = build_towers(cfg, "cpu")
        assert mm.out_dim == db.net.out_dim == 512


# ------------------------------------------------------ the MinkLoc family
def test_minkloc_small_widths_match_jax():
    """JAX's ``tests/test_model_families.py`` widths: MinkLoc at planes
    (8, 16, 16), one top-down level and the linear block."""
    cfg_j, cfg = configs(model=dict(modelq="minkloc"))
    rng, _, _, pts = world(2)
    vox_j = jax_prepare_query_vox(cfg_j, pts)
    m = JaxMinkLoc(feature_size=32, output_dim=32, planes=(8, 16, 16),
                   num_top_down=1, linear_block=True)
    v = random_variables(m, rng, vox_j)
    want = jax.jit(m.apply)(v, vox_j)
    port = load_jax_variables(MinkLoc(32, 32, planes=(8, 16, 16),
                                      num_top_down=1, linear_block=True), v)
    with torch.no_grad():
        got = port.eval()(prepare_query_vox(cfg, pts, "cpu"))
    close(got.numpy(), want, VOX)


def test_minkloc_multimodal_matches_jax():
    cfg_j, cfg = configs(model=dict(modelq="minkloc_multimodal"))
    rng, img, _, pts = world(3)
    vox_j = jax_prepare_query_vox(cfg_j, pts)
    m = JaxMultimodal(cloud_fe_size=32, image_fe_size=32, output_dim=64)
    v = random_variables(m, rng, vox_j, img)
    want = jax.jit(m.apply)(v, vox_j, img)
    port = load_jax_variables(MinkLocMultimodal(32, 32, 64), v).eval()
    with torch.no_grad():
        got = port(prepare_query_vox(cfg, pts, "cpu"), torch.from_numpy(img))
        image_only = port(None, torch.from_numpy(img))
    close(got["image_embedding"].numpy(), want["image_embedding"], FP32)
    close(got["cloud_embedding"].numpy(), want["cloud_embedding"], VOX)
    close(got["embedding"].numpy(), want["embedding"], VOX)
    assert got["embedding"].shape == (B, 64)
    assert image_only["cloud_embedding"] is None
    torch.testing.assert_close(image_only["embedding"],
                               got["image_embedding"])


@pytest.mark.parametrize("kw", [
    dict(out_channels=64, lateral_dim=64, fh_num_bottom_up=3,
         fh_num_top_down=1, add_fc_block=True),
    dict(out_channels=32, lateral_dim=32, fh_num_top_down=2,
         pool_method="spoc")])
def test_resnet_fpn_matches_jax(kw):
    rng = np.random.default_rng(7)
    img = rng.standard_normal((B, IMG, IMG, 3)).astype(np.float32)
    m = JaxResnetFPN(**kw)
    v = random_variables(m, rng, img)
    want = jax.jit(m.apply)(v, img)
    port = load_jax_variables(ResnetFPN(**kw), v).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(img))
    close(got.numpy(), want, FP32)


# -------------------------------- the MM and DBVanilla2D image branches
SQUEEZE = {"squeezenet10": (256, 512, 256), "squeezenet11": (128, 256, 256)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("fe", list(SQUEEZE))
def test_mm_with_squeezenet_matches_jax(fe, dtype):
    cfg_j, cfg = configs(mm=dict(imgfe=fe, imgfe_planes=SQUEEZE[fe],
                                 imgfe_dim=256))
    rng, img, _, pts = world(4)
    vox_j = jax_prepare_query_vox(cfg_j, pts)
    jdt, tdt = DTYPES[dtype]
    v = random_variables(JaxMM(config=cfg_j.model.mm), rng, img, vox_j)
    want = jax.jit(JaxMM(config=cfg_j.model.mm, dtype=jdt).apply)(
        v, img, vox_j)
    mm = load_jax_variables(MM(cfg.model.mm, dtype=tdt), v).eval()
    with torch.inference_mode():
        got = mm(torch.from_numpy(img), prepare_query_vox(cfg, pts, "cpu"))
    assert sorted(got) == sorted(KEYS) == sorted(want)
    for k in KEYS:
        tol = ((FP32 if k == "imagevec_org" else VOX)
               if dtype == "float32" else BF16)
        close(got[k].float().numpy(), want[k], tol, k)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("fe", ["resnet50", "convnext_tiny",
                                "squeezenet11"])
def test_dbvanilla2d_branches_match_jax(fe, dtype):
    cfg_j, cfg = configs(db=dict(image_fe=fe))
    rng, _, maps, _ = world(5)
    jdt, tdt = DTYPES[dtype]
    kw = dict(dim=cfg.model.features_dim)
    v = random_variables(JaxDB(config=cfg_j.model.db, **kw), rng, maps)
    if fe == "convnext_tiny":  # the layer scale away from 1e-6
        for blk in v["params"]["fe_0"]["fe"].values():
            if "gamma" in blk:
                blk["gamma"] = rng.normal(0, 0.5, blk["gamma"].shape).astype(
                    np.float32)
    want = jax.jit(JaxDB(config=cfg_j.model.db, dtype=jdt, **kw).apply)(
        v, maps)
    db = load_jax_variables(DBVanilla2D(cfg.model.db, dtype=tdt, **kw),
                            v).eval()
    with torch.inference_mode():
        got = db(torch.from_numpy(maps))
    close(got.float().numpy(), want, FP32 if dtype == "float32" else BF16)


@pytest.mark.parametrize("fe,planes,dim", [
    ("resnet50", (256, 512, 1024), 1024),
    ("convnext_tiny", (96, 192, 384), 384),
    ("resnet50", (256,), 256)])
def test_mm_wide_image_branch_refused_where_jax_fails(fe, planes, dim):
    """JAX's FCODE chain adds the last scale's image vector to the 256-wide
    sum with no projection: its init fails; the port refuses."""
    layers = (2,) * len(planes)
    cfg_j, cfg = configs(mm=dict(imgfe=fe, imgfe_planes=planes,
                                 imgfe_dim=dim, imgfe_layers=layers),
                         image_size=32)
    rng, img, _, pts = world(6, 32)
    vox_j = jax_prepare_query_vox(cfg_j, pts)
    with pytest.raises((TypeError, AssertionError, ValueError)):
        jax.eval_shape(JaxMM(config=cfg_j.model.mm).init,
                       jax.random.PRNGKey(0), img, vox_j)
    with pytest.raises(NotImplementedError, match="JAX"):
        MM(cfg.model.mm)
