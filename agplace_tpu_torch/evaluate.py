"""Evaluation (``agplace_tpu/evaluate.py``): embed the database tiles, then
the queries, in padded batches; exact L2 top-k; optional crop
post-processing and PCA; Recall@N against the radius ground truth.

    mm, db = build_towers(cfg, generator=g)            # on the card
    recalls, text = evaluate(cfg, ds, *make_infer_fns(mm, db))

Test methods (``cfg.eval.test_method``): hard_resize and central_crop (the
dataset's query transform; one descriptor per query), single_query (ragged
original-resolution queries at batch 1), five_crops (the mean of the five
crop descriptors), nearest_crop and maj_voting (the five crops searched
apart and merged, ``retrieval/recall.py``).  Everything runs on ``device``:
the card unless the caller passes ``"cpu"``.  With meshes
(``parallel/mesh.py``) the embed passes run data-parallel (``embed.py``)
and the search gallery-sharded (``retrieval/sharded.py``); every rank of
them calls ``evaluate`` and gets the same recalls.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from agplace_tpu_torch.config import Config
from agplace_tpu_torch.data.voxels import prepare_query_vox
from agplace_tpu_torch.device import resolve_device
from agplace_tpu_torch.embed import (batched_embed_db, batched_embed_q,
                                     batched_embed_q_crops, to_device)
from agplace_tpu_torch.infer import compute_dtype
from agplace_tpu_torch.parallel.mesh import mesh_axis
from agplace_tpu_torch.retrieval.knn import l2_topk_blocked
from agplace_tpu_torch.retrieval.sharded import shard_gallery, sharded_l2_topk
from agplace_tpu_torch.retrieval.recall import (compute_recalls,
                                                dedup_nearest_crop,
                                                maj_voting_merge)
from agplace_tpu_torch.utils.pca import compute_pca

CROP_METHODS = ("five_crops", "nearest_crop", "maj_voting")


def resize_bilinear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """[H, W, C] -> [h, w, C] fp32, bilinear with half-pixel centres and an
    antialiasing filter when it shrinks: ``jax.image.resize(...,
    "bilinear")``'s semantics."""
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    y = F.interpolate(x.permute(2, 0, 1)[None], size=tuple(size),
                      mode="bilinear", align_corners=False, antialias=True)
    return y[0].permute(1, 2, 0).contiguous().numpy()


def _embed_single_queries(cfg: Config, ds, embed_queries, device):
    """single_query: each query at batch 1 at its own resolution.  The
    first ``cfg.eval.max_query_shapes`` distinct shapes embed as they are;
    a later new shape is resized (``resize_bilinear``) to the kept shape
    nearest in log height + log width, with one warning."""
    cap = max(1, cfg.eval.max_query_shapes)
    kept: list = []  # (h, w) in first-appearance order
    warned = False
    feats = []
    for i in range(ds.queries_num):
        img = ds.load_query_image(i)
        shape = img.shape[:2]
        if shape not in kept and len(kept) < cap:
            kept.append(shape)
        if shape not in kept:
            if not warned:
                warned = True
                logging.warning(
                    "single_query: over %d distinct query shapes; further "
                    "new shapes are resized to the nearest kept shape "
                    "(raise eval.max_query_shapes to keep more)", cap)
            target = min(kept, key=lambda s: abs(np.log(shape[0] / s[0]))
                         + abs(np.log(shape[1] / s[1])))
            img = resize_bilinear(img, target)
        vox = prepare_query_vox(cfg, ds.load_query_points(i)[None], device,
                                compute_dtype(cfg))
        feats.append(embed_queries(to_device(img[None], device), vox))
    if not feats:
        return np.empty((0, 0), np.float32)
    return torch.cat(feats).float().cpu().numpy()


def extract_features(cfg: Config, ds, embed_queries, embed_db,
                     device="cuda", mesh=None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(query descriptors, database descriptors) as fp32 numpy: the
    database first, then the queries, in batches of
    ``cfg.train.infer_batch_size`` (single_query: one by one; the crop
    methods: 5 rows per query, ``batched_embed_q_crops``); data-parallel
    over ``mesh`` (single_query excepted, as in JAX)."""
    device = resolve_device(device)
    bs = cfg.train.infer_batch_size
    db_feats = batched_embed_db(ds, list(range(ds.database_num)), embed_db,
                                bs, device, mesh)
    method = cfg.eval.test_method
    if method in CROP_METHODS:
        if not hasattr(ds, "load_query_crops"):
            # one descriptor per query would reach evaluate_features'
            # five-crop reshapes: refuse here, where the cause is
            raise ValueError(
                f"test_method {method!r} needs a dataset with "
                f"load_query_crops; {type(ds).__name__} has none")
        q_feats = batched_embed_q_crops(ds, list(range(ds.queries_num)),
                                        embed_queries, bs, cfg, device, mesh)
    elif method == "single_query":
        q_feats = _embed_single_queries(cfg, ds, embed_queries, device)
    else:
        q_feats = batched_embed_q(ds, list(range(ds.queries_num)),
                                  embed_queries, bs, cfg, device, mesh)
    return q_feats, db_feats


def evaluate(cfg: Config, ds, embed_queries, embed_db, pca=None,
             device="cuda", mesh=None, gallery_mesh=None
             ) -> Tuple[np.ndarray, str]:
    """(recalls in percent at ``cfg.eval.recall_values``, "R@1: ...").
    With ``cfg.eval.pca_dim`` and no fitted ``pca``, a PCA is fitted on the
    database descriptors (up to 2^14 sampled rows, seed
    ``cfg.train.seed``) and both sides are reduced.  ``mesh`` /
    ``gallery_mesh``: the embed passes data-parallel, the search
    gallery-sharded."""
    q_feats, db_feats = extract_features(cfg, ds, embed_queries, embed_db,
                                         device, mesh)
    if pca is None and cfg.eval.pca_dim:
        pca = compute_pca(db_feats, cfg.eval.pca_dim, seed=cfg.train.seed)
    if pca is not None:
        q_feats, db_feats = pca.transform(q_feats), pca.transform(db_feats)
    return evaluate_features(cfg, ds, q_feats, db_feats, device=device,
                             gallery_mesh=gallery_mesh)


def search(q_feats: np.ndarray, db_feats: np.ndarray, k: int,
           device="cuda", gallery_mesh=None) -> Tuple[np.ndarray, np.ndarray]:
    """Exact L2 top-k of the queries over the database on ``device``:
    numpy (sq distances [Q, k], indices [Q, k]); sharded over
    ``gallery_mesh`` when it splits the gallery over this rank and
    others."""
    device = resolve_device(device)
    if mesh_axis(gallery_mesh, "gallery") is not None:
        d, i = sharded_l2_topk(
            gallery_mesh, torch.as_tensor(np.asarray(q_feats, np.float32),
                                          device=device),
            shard_gallery(gallery_mesh, db_feats, device=device), k,
            n_rows=len(db_feats))
        return d.cpu().numpy(), i.cpu().numpy()
    gallery = torch.as_tensor(np.asarray(db_feats, np.float32),
                              device=device)
    return l2_topk_blocked(q_feats, gallery, k)


def evaluate_features(cfg: Config, ds, q_feats: np.ndarray,
                      db_feats: np.ndarray,
                      test_method: Optional[str] = None,
                      device="cuda", gallery_mesh=None
                      ) -> Tuple[np.ndarray, str]:
    """Recall@N of given descriptors, with the crop post-processing of
    ``test_method`` (default ``cfg.eval.test_method``).  For the crop
    methods ``q_feats`` holds 5 rows per query (``batched_embed_q_crops``);
    nearest_crop and maj_voting merge 20 predictions per query."""
    method = test_method or cfg.eval.test_method
    k = max(cfg.eval.recall_values)
    nq = ds.queries_num
    if method in ("nearest_crop", "maj_voting"):
        if k > 20:
            # the merge keeps 20 predictions per query: a deeper recall
            # value would silently report R@20
            raise ValueError(
                f"{method} supports recall values up to 20 (the 20-deep "
                f"crop merge); got {cfg.eval.recall_values}")
        if len(db_feats) < 20:
            raise ValueError(f"{method} merges 20 distinct tiles per query: "
                             f"it needs a gallery of at least 20 rows, got "
                             f"{len(db_feats)}")
        d, i = search(q_feats, db_feats, 20, device, gallery_mesh)
        if method == "nearest_crop":
            preds = dedup_nearest_crop(d.reshape(nq, 5 * 20),
                                       i.reshape(nq, 5 * 20), keep=20)
        else:
            preds = maj_voting_merge(d.reshape(nq, 5, 20).copy(),
                                     i.reshape(nq, 5, 20).copy(),
                                     cfg.eval.majority_weight, keep=20)
    else:
        if method == "five_crops":
            q_feats = q_feats.reshape(nq, 5, -1).mean(axis=1)
        preds = search(q_feats, db_feats, k, device, gallery_mesh)[1]
    return compute_recalls(preds, ds.soft_positives_per_query,
                           cfg.eval.recall_values)
