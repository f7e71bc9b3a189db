"""Training losses (``agplace_tpu/train/losses.py``).

* triplet: a sum of triplet margin losses (eps inside the sqrt, as
  ``nn.TripletMarginLoss``) over the batch's triplets, divided by B*nneg;
* sare_ind / sare_joint: -log softmax of negated squared distances;
* the geo-supervised "other" loss: bce / mse / l1 on pairwise descriptor
  distances against 0/1 labels from the UTM distance thresholds;
* ``infonce_loss``, not wired into the step (nor is it in JAX).

Features are the flattened [B*(2+nneg), C] matrix (query, positive,
negatives per sample) and ``triplets_local`` its [B*nneg, 3] (q, p, n)
row indices, as ``data/base.collate_train`` builds them.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from agplace_tpu_torch.config import LossConfig
from agplace_tpu_torch.retrieval.knn import pairwise_l2


def _pairdist(a, b, eps: float = 1e-6):
    """Row-wise L2 distance with torch's eps-inside-norm semantics."""
    return torch.sqrt(((a - b) ** 2).sum(dim=-1) + eps)


def triplet_margin_loss(anchor, positive, negative, margin: float = 0.1):
    """Sum-reduced triplet margin loss."""
    return torch.clamp(_pairdist(anchor, positive)
                       - _pairdist(anchor, negative) + margin, min=0.0).sum()


def _take(features, triplets_local):
    t = triplets_local.long()
    return features[t[:, 0]], features[t[:, 1]], features[t[:, 2]]


def compute_triplet_loss(features, triplets_local, batch_size: int,
                         negs_num: int, margin: float = 0.1):
    q, p, n = _take(features, triplets_local)
    return triplet_margin_loss(q, p, n, margin) / (batch_size * negs_num)


def sare_ind(query, positive, negative):
    """Independent SARE: -log softmax of the negated squared distances,
    positive first.  query/positive [..., C], negative [..., N, C] ->
    one loss per leading index [...]."""
    d_pos = ((query - positive) ** 2).sum(dim=-1)
    d_neg = ((query[..., None, :] - negative) ** 2).sum(dim=-1)
    logits = -torch.cat([d_pos[..., None], d_neg], dim=-1)
    return -F.log_softmax(logits, dim=-1)[..., 0]


def sare_joint(query, positive, negatives):
    """Joint SARE over all negatives at once."""
    return sare_ind(query, positive, negatives)


def compute_sare_loss(features, triplets_local, batch_size: int,
                      negs_num: int, joint: bool = False):
    t = triplets_local.long().reshape(batch_size, negs_num, 3)
    if joint:  # one term per query with its negatives together
        loss = sare_joint(features[t[:, 0, 0]], features[t[:, 0, 1]],
                          features[t[:, :, 2]]).sum()
    else:  # one term per triplet
        q, p, n = _take(features, t.reshape(-1, 3))
        loss = sare_ind(q, p, n[:, None]).sum()
    return loss / (batch_size * negs_num)


def geo_pairwise_dist(a, b):
    """Euclidean distance between UTM east/north rows by direct
    differences: the expanded form loses metres at UTM magnitudes."""
    d = a[:, None, :] - b[None, :, :]
    return torch.sqrt((d * d).sum(dim=-1))


def compute_bcemat(dist, positive_thd: float, negative_thd: float):
    """0 closer than ``positive_thd``, 1 farther than ``negative_thd``,
    -1 (masked) in between."""
    mat = torch.full_like(dist, -1.0)
    mat = torch.where(dist < positive_thd, 0.0, mat)
    return torch.where(dist > negative_thd, 1.0, mat)


def _masked_loss(featsdist, bcemat, kind: str):
    mask = (bcemat != -1.0).float()
    n = torch.clamp(mask.sum(), min=1.0)
    target = torch.where(mask > 0, bcemat, 0.0)
    if kind == "bce":  # BCEWithLogitsLoss(input=dist, target)
        x = featsdist
        per = (torch.clamp(x, min=0) - x * target
               + torch.log1p(torch.exp(-x.abs())))
    elif kind == "mse":
        per = (torch.sigmoid(featsdist) - target) ** 2
    elif kind == "l1":
        per = (torch.sigmoid(featsdist) - target).abs()
    else:
        raise NotImplementedError(kind)
    return (per * mask).sum() / n


def compute_other_loss(feats_ground: Dict[str, torch.Tensor],
                       feats_aerial_embed,  # [B, NDB, C]
                       query_eastnorth,  # [B, 2]
                       db_eastnorth,  # [B, NDB, 2]
                       cfg: LossConfig, positive_thd: float = 10.0,
                       negative_thd: float = 25.0):
    """Four pair-group terms, each weighted by ``otherloss_weight``: A-A on
    embeddings, and G-(A and G) on the embedding, imagevec_org and
    voxvec_org."""
    g_embed = feats_ground["embedding"]
    g_image = feats_ground.get("imagevec_org", g_embed)
    g_vox = feats_ground.get("voxvec_org", g_embed)
    c = feats_aerial_embed.shape[-1]
    a_embed = feats_aerial_embed.reshape(-1, c)
    en_g = query_eastnorth
    en_a = db_eastnorth.reshape(-1, 2)
    en_ag = torch.cat([en_a, en_g], dim=0)

    mat_aa = compute_bcemat(geo_pairwise_dist(en_a, en_a), positive_thd,
                            negative_thd)
    mat_g = compute_bcemat(geo_pairwise_dist(en_g, en_ag), positive_thd,
                           negative_thd)
    kind = cfg.otherloss_type
    loss = _masked_loss(pairwise_l2(a_embed, a_embed), mat_aa, kind)
    for g in (g_embed, g_image, g_vox):
        loss = loss + _masked_loss(
            pairwise_l2(g, torch.cat([a_embed, g], dim=0)), mat_g, kind)
    return loss * cfg.otherloss_weight


def infonce_loss(features, triplets_local, batch_size: int, negs_num: int,
                 temperature: float = 0.07):
    """InfoNCE over (q, p, negatives) groups, mean over the queries."""
    t = triplets_local.long().reshape(batch_size, negs_num, 3)
    q = features[t[:, 0, 0]]
    p = features[t[:, 0, 1]]
    n = features[t[:, :, 2]]
    pos = (q * p).sum(dim=-1, keepdim=True) / temperature
    neg = torch.einsum("bnc,bc->bn", n, q) / temperature
    return -F.log_softmax(torch.cat([pos, neg], dim=1), dim=1)[:, 0].mean()
