"""The training step (``agplace_tpu/train/step.py``).

One ``train_step`` is what JAX's jitted step does: both tower forwards in
training mode, the geo "other" loss (MM query towers only) plus the
triplet (or SARE) loss over the batch's triplets, backward, the grouped
optimizer update, and the new BN running statistics (updated in place by
the towers' BN layers during the forward).  The towers come from the
factory (``models/factory.py``): any ``--modelq`` / ``--modeldb`` JAX
trains; under ``share_qdb`` the query tower embeds the aerial maps in a
second forward after the query pass, so its BN statistics move twice, in
that order, as JAX's do.

Batch layout (``data/base.collate_train``, on the device):
    query_image     [B, H, W, 3]
    vox             BEVGrid (the MM's bev backend) or SparseVoxels
    query_eastnorth [B, 2]
    db_map          [B, 1+nneg, NMAP, H, W, 3]
    db_eastnorth    [B, 1+nneg, 2]
    triplets_local  [B*nneg, 3] int32 rows of the flattened
                    [B*(2+nneg), C] feature matrix

The aerial tower takes the 6-D entry in one forward, so its BN statistics
cover all B*(1+nneg)*NMAP tiles, as in JAX.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional

import torch

from agplace_tpu_torch.config import Config
from agplace_tpu_torch.infer import build_towers
from agplace_tpu_torch.models.factory import query_apply, shared_db_apply
from agplace_tpu_torch.train.losses import (compute_other_loss,
                                            compute_sare_loss,
                                            compute_triplet_loss)
from agplace_tpu_torch.train.optim import make_optimizer
from agplace_tpu_torch.train.state import TrainState

log = logging.getLogger("train")


def check_supported(cfg: Config) -> None:
    """Raise on a configuration JAX cannot train or the port does not yet
    (nothing is ignored)."""
    m = cfg.model
    if m.share_qdb and m.modelq != "geoloc":
        raise NotImplementedError(
            "share_qdb needs an image-only query tower (modelq='geoloc'); "
            "JAX and the reference MM raise NotImplementedError there")
    if cfg.mesh.data_parallel not in (-1, 1) or cfg.mesh.gallery_parallel \
            != 1:
        raise NotImplementedError(
            "data_parallel / gallery_parallel > 1: the port trains on one "
            "card (multi-GPU is ROADMAP Queue 1 item 10)")
    if cfg.train.loss.criterion not in ("triplet", "sare_ind",
                                        "sare_joint"):
        raise NotImplementedError(cfg.train.loss.criterion)


def check_pretrained(cfg: Config) -> None:
    """JAX grafts pretrained backbones when a weight source exists and
    otherwise warns and stays random-init.  The port warns likewise when
    no source is configured, naming each backbone JAX would graft (the
    MM's and DBVanilla2D's image branches, GeoLoc's ``model.backbone``),
    and raises when one is: loading torchvision weights waits for ROADMAP
    Queue 1 item 13."""
    if not cfg.model.pretrained:
        return
    m = cfg.model
    src = m.pretrained_path or os.environ.get("AGPLACE_WEIGHTS")
    if src:
        raise NotImplementedError(
            f"pretrained backbone weights from {src!r}: the port does not "
            f"load them yet (ROADMAP Queue 1 item 13); unset "
            f"model.pretrained_path / AGPLACE_WEIGHTS or pass "
            f"--pretrained false")
    archs = {"mm": {m.mm.imgfe}, "geoloc": {m.backbone}}.get(m.modelq,
                                                            set())
    if not m.share_qdb:
        archs |= {"vanilla2d": {m.db.image_fe},
                  "geoloc": {m.backbone}}.get(m.db.modeldb, set())
    for arch in sorted(archs):
        log.warning("no pretrained %s weights configured (set "
                    "AGPLACE_WEIGHTS or model.pretrained_path); %s backbones "
                    "stay random-init", arch, arch)


def init_state(cfg: Config, device="cuda", seed: Optional[int] = None,
               train_ds=None) -> TrainState:
    """Both towers on ``device`` (the card unless the caller passes
    ``"cpu"``), seeded from ``seed`` (default ``cfg.train.seed``), and the
    optimizer over both.  With ``train_ds``, a geoloc tower's NetVLAD /
    CRN clusters are initialised from its descriptors of the dataset
    (``train/netvlad_init.py``), as JAX's ``init_state`` does."""
    check_supported(cfg)
    check_pretrained(cfg)
    g = torch.Generator().manual_seed(cfg.train.seed if seed is None
                                      else seed)
    mm, db = build_towers(cfg, device, g)
    if train_ds is not None and cfg.model.aggregation in ("netvlad", "crn"):
        from agplace_tpu_torch.train.netvlad_init import (
            initialize_netvlad_from_dataset)

        if cfg.model.modelq == "geoloc":
            initialize_netvlad_from_dataset(cfg, mm, train_ds,
                                            seed=cfg.train.seed)
        if db is not None and cfg.model.db.modeldb == "geoloc":
            initialize_netvlad_from_dataset(cfg, db, train_ds,
                                            seed=cfg.train.seed, which="db")
    state = TrainState(mm, db, None)
    state.opt = make_optimizer(cfg.train, list(state.named_parameters()),
                               crn=cfg.model.aggregation == "crn",
                               freeze_te=cfg.model.freeze_te)
    return state


def make_train_step(cfg: Config):
    """``train_step(state, batch) -> metrics``: one optimizer step in
    place; the metrics (loss, triplet_loss, and otherloss for an MM query
    tower) stay on the device as 0-d tensors."""
    check_supported(cfg)
    loss_cfg = cfg.train.loss
    bs = cfg.train.train_batch_size
    nneg = cfg.train.negs_num_per_query

    def train_step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        mm, db = state.towers
        for tower in state.towers:
            if tower is not None:
                tower.train()
        mm_out = query_apply(mm, batch["query_image"], batch["vox"])
        aerial = (shared_db_apply(mm, batch["db_map"]) if db is None
                  else db(batch["db_map"]))  # [B, 1+nneg, C]
        metrics = {}
        loss = 0.0
        if cfg.model.modelq == "mm":
            otherloss = compute_other_loss(
                mm_out, aerial, batch["query_eastnorth"],
                batch["db_eastnorth"], loss_cfg,
                positive_thd=cfg.data.train_positives_dist_threshold,
                negative_thd=cfg.data.val_positive_dist_threshold)
            loss = otherloss
            metrics["otherloss"] = otherloss.detach()
        feats = torch.cat([mm_out["embedding"][:, None, :], aerial], dim=1)
        feats = feats.reshape(-1, feats.shape[-1])  # [B*(2+nneg), C]
        tri = batch["triplets_local"]
        if loss_cfg.criterion == "triplet":
            tloss = compute_triplet_loss(feats, tri, bs, nneg,
                                         loss_cfg.margin)
        else:
            tloss = compute_sare_loss(feats, tri, bs, nneg,
                                      joint=loss_cfg.criterion
                                      == "sare_joint")
        loss = loss + tloss * loss_cfg.tripletloss_weight
        state.opt.zero_grad()
        loss.backward()
        state.opt.step()
        state.step += 1
        metrics.update(loss=loss.detach(), triplet_loss=tloss.detach())
        return metrics

    return train_step
