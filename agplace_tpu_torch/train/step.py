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


def check_one_device(cfg: Config) -> None:
    """Raise on ``data_parallel`` / ``gallery_parallel`` above 1: the port
    runs on one card (multi-GPU is ROADMAP Queue 1 item 10)."""
    if cfg.mesh.data_parallel not in (-1, 1) or cfg.mesh.gallery_parallel \
            != 1:
        raise NotImplementedError(
            "data_parallel / gallery_parallel > 1: the port runs on one "
            "card (multi-GPU is ROADMAP Queue 1 item 10)")


def check_supported(cfg: Config) -> None:
    """Raise on a configuration JAX cannot train or the port does not yet
    (nothing is ignored)."""
    m = cfg.model
    if m.share_qdb and m.modelq != "geoloc":
        raise NotImplementedError(
            "share_qdb needs an image-only query tower (modelq='geoloc'); "
            "JAX and the reference MM raise NotImplementedError there")
    check_one_device(cfg)
    if cfg.train.loss.criterion not in ("triplet", "sare_ind",
                                        "sare_joint"):
        raise NotImplementedError(cfg.train.loss.criterion)


def apply_pretrained_backbones(cfg: Config, mm, db) -> None:
    """Graft pretrained weights into every image backbone JAX grafts
    (``agplace_tpu/train/step.py:apply_pretrained_backbones``), in place:
    the MM's image branch (resnet18 / 34 / 50, convnext_tiny,
    squeezenet), each DBVanilla2D map-type branch (one under
    ``share_dbfe``), and GeoLoc's ``backbone`` on either tower (resnet /
    vgg16 / alexnet / ViT / CCT, the positional embedding resized to the
    tower's token count).  A backbone with no source found warns and
    stays as initialised."""
    from agplace_tpu_torch.models.geoloc import RESNET_BACKBONES
    from agplace_tpu_torch.utils.torch_convert import (
        graft, load_pretrained_backbone)

    m = cfg.model
    loaded: dict = {}

    def get(arch: str, where: str, **kw):
        key = (arch, tuple(sorted(kw.items())))
        if key not in loaded:
            loaded[key] = load_pretrained_backbone(arch, m.pretrained_path,
                                                   **kw)
            if loaded[key] is None:
                log.warning(
                    "no pretrained %s weights found (set AGPLACE_WEIGHTS or "
                    "model.pretrained_path); %s stays random-init", arch,
                    where)
        return loaded[key]

    def put(tower, name: str, prefix: str, arch: str, where: str, **kw):
        got = get(arch, where, **kw)
        if got is None:
            return
        dropped = graft(tower, prefix, *got)
        log.info("loaded pretrained %s into %s/%s%s", arch, name,
                 prefix.replace(".", "/"),
                 f" (dropped {len(dropped)} unused subtrees)"
                 if dropped else "")

    def graft_fe(tower, name: str, prefix: str, fe: str, layers):
        where = f"{name} image branch {fe}"
        if fe in ("resnet18", "resnet34", "resnet50"):
            put(tower, name, prefix + ".fe", fe, where,
                num_stages=len(layers))
        elif fe == "convnext_tiny":
            put(tower, name, prefix + ".fe", fe, where, layers=tuple(layers))
        elif fe in ("squeezenet10", "squeezenet11"):
            put(tower, name, prefix + ".fe", fe, where)  # fc stays fresh

    def graft_geoloc(tower, name: str, prefix: str):
        bb = m.backbone
        where = f"{name} model.backbone={bb}"
        if bb in RESNET_BACKBONES:
            arch, stages, _ = RESNET_BACKBONES[bb]
            put(tower, name, prefix + "backbone", arch, where,
                num_stages=stages)
        elif bb in ("vgg16", "alexnet"):
            put(tower, name, prefix + "backbone", bb, where)
        elif bb in ("vit", "cct384"):
            backbone = tower.get_submodule(prefix + "backbone")
            put(tower, name, prefix + "backbone", bb, where,
                n_tokens=backbone.pos.shape[1])

    if m.modelq == "mm":
        graft_fe(mm, "mm", "image_fe", m.mm.imgfe, m.mm.imgfe_layers)
    elif m.modelq == "geoloc":
        graft_geoloc(mm, "mm", "")
    if db is None:  # share_qdb: no aerial tower
        return
    if m.db.modeldb == "vanilla2d":
        for i in range(1 if m.db.share_dbfe else cfg.data.nmap):
            graft_fe(db, "db", f"fe_{i}", m.db.image_fe,
                     m.db.image_fe_layers)
    elif m.db.modeldb == "geoloc":
        graft_geoloc(db, "db", "net.")


def init_state(cfg: Config, device="cuda", seed: Optional[int] = None,
               train_ds=None) -> TrainState:
    """Both towers on ``device`` (the card unless the caller passes
    ``"cpu"``), seeded from ``seed`` (default ``cfg.train.seed``), and the
    optimizer over both.  With ``train_ds``, a geoloc tower's NetVLAD /
    CRN clusters are initialised from its descriptors of the dataset
    (``train/netvlad_init.py``), as JAX's ``init_state`` does; then, with
    ``model.pretrained``, the image backbones are grafted from the
    weight files found (``apply_pretrained_backbones``), in JAX's
    order."""
    check_supported(cfg)
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
    if cfg.model.pretrained:
        apply_pretrained_backbones(cfg, mm, db)
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
