"""Plain PyTorch reference of one training step of the MM + aerial towers.

Both towers in training mode (batch moments in every BatchNorm, over the
occupied cells in the voxel branch), the geo-supervised "other" loss (BCE
on descriptor distances against 0/1 labels from UTM distances) plus the
triplet margin loss, gradients by autograd, and Adam (b1 0.9, b2 0.999, eps
1e-8, bias corrections in fp32) with one learning rate per group: the
aerial tower, the query tower's voxel branch, and the rest.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from portbench.reference.model import Params, Reference

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def group_of(name: str) -> str:
    """'db' for the aerial tower, 'pc' for the query tower's voxel branch
    and its pooling, 'base' for every other parameter."""
    if name.startswith("db."):
        return "db"
    if name.startswith(("mm.vox_fe.", "mm.vox_pool.")):
        return "pc"
    return "base"


def _dist(a, b):
    """Euclidean distances [len(a), len(b)], zero (with zero gradient) where
    two rows are equal."""
    d2 = (a[:, None, :] - b[None, :, :]).square().sum(dim=-1)
    nz = d2 > 0
    return torch.where(nz, torch.sqrt(torch.where(nz, d2, 1.0)), 0.0)


def _labels(en_a, en_b, pos: float, neg: float):
    """0 closer than ``pos`` metres, 1 farther than ``neg``, -1 between."""
    d = torch.sqrt((en_a[:, None, :] - en_b[None, :, :]).square().sum(-1))
    lab = torch.full_like(d, -1.0)
    lab = torch.where(d < pos, 0.0, lab)
    return torch.where(d > neg, 1.0, lab)


def _bce(x, lab):
    keep = (lab != -1.0).float()
    t = torch.where(keep > 0, lab, 0.0)
    per = torch.clamp(x, min=0) - x * t + torch.log1p(torch.exp(-x.abs()))
    return (per * keep).sum() / keep.sum().clamp(min=1.0)


def loss_of(ref: Reference, P: Params, batch: dict, hp: dict
            ) -> torch.Tensor:
    """The step's loss.  ``batch``: query_image [B,H,W,3], occ [B,X,Y,Z],
    query_eastnorth [B,2], db_map [B,1+nneg,1,h,w,3], db_eastnorth
    [B,1+nneg,2]; ``hp``: margin, otherloss_weight, the two distance
    thresholds, the triplet weight."""
    q = ref.query_tower(P, batch["query_image"], batch["occ"])
    aer = ref.aerial_tower(P, batch["db_map"])  # [B, 1+nneg, C]
    b, ndb, c = aer.shape
    a = aer.reshape(-1, c)
    en_a = batch["db_eastnorth"].reshape(-1, 2)
    en_g = batch["query_eastnorth"]
    pos, neg = hp["pos_thd"], hp["neg_thd"]
    other = _bce(_dist(a, a), _labels(en_a, en_a, pos, neg))
    lab_g = _labels(en_g, torch.cat([en_a, en_g]), pos, neg)
    for key in ("embedding", "imagevec_org", "voxvec_org"):
        g = q[key]
        other = other + _bce(_dist(g, torch.cat([a, g])), lab_g)
    other = other * hp["otherloss_weight"]
    anchor = q["embedding"]
    d_pos = torch.sqrt((anchor - aer[:, 0]).square().sum(-1) + 1e-6)
    d_neg = torch.sqrt((anchor[:, None] - aer[:, 1:]).square().sum(-1)
                       + 1e-6)
    trip = torch.clamp(d_pos[:, None] - d_neg + hp["margin"], min=0.0)
    trip = trip.sum() / (b * (ndb - 1))
    return other + trip * hp["triplet_weight"]


class Adam:
    """Adam with one learning rate per group, over a dict of leaves."""

    def __init__(self, P: Params, lrs: Dict[str, float]):
        self.lr = {n: lrs[group_of(n)] for n in P}
        self.mu = {n: torch.zeros_like(v) for n, v in P.items()}
        self.nu = {n: torch.zeros_like(v) for n, v in P.items()}
        self.count = 0

    def step(self, P: Params, grads: Params) -> Params:
        self.count += 1
        t = np.float32(self.count)
        c1 = float(1 - np.float32(ADAM_B1) ** t)
        c2 = float(1 - np.float32(ADAM_B2) ** t)
        out = {}
        for n, p in P.items():
            g = grads[n]
            self.mu[n] = (1 - ADAM_B1) * g + ADAM_B1 * self.mu[n]
            self.nu[n] = (1 - ADAM_B2) * g.square() + ADAM_B2 * self.nu[n]
            upd = (self.mu[n] / c1) / (torch.sqrt(self.nu[n] / c2) + ADAM_EPS)
            out[n] = p - self.lr[n] * upd
        return out


def steps(ref: Reference, P: Params, buffers: Params, batches, hp: dict,
          lrs: Dict[str, float]) -> Tuple[list, Params, Params]:
    """Run one step per batch from the leaves ``P`` (the parameters;
    ``buffers`` the rest of the state, which training mode does not
    read).  Returns (each step's loss, the first step's gradients, the leaves
    after the last step)."""
    ref.training_mode = True
    opt = Adam(P, lrs)
    losses, first = [], None
    names = list(P)
    for batch in batches:
        leaves = [P[n].detach().requires_grad_(True) for n in names]
        live = dict(zip(names, leaves))
        loss = loss_of(ref, {**buffers, **live}, batch, hp)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = {n: (g if g is not None else torch.zeros_like(P[n]))
                 for n, g in zip(names, grads)}
        if first is None:
            first = {n: g.detach() for n, g in grads.items()}
        losses.append(float(loss.detach()))
        P = {n: v.detach() for n, v in opt.step(P, grads).items()}
    ref.training_mode = False
    return losses, first, P
