"""Batch-hard metric-learning losses (``agplace_tpu/train/metric_losses.py``,
the MinkLoc lineage's batch-hard triplet loss).

Fixed-shape, as JAX's: every anchor is scored, and one with no positive
or no negative contributes 0; the loss is the mean over the non-zero
triplets (pytorch-metric-learning's ``AvgNonZeroReducer``).  Plain torch
functions: the gradients come from autograd.  Ties of the hardest
positive / negative go to the lowest index, as ``jnp.argmax`` /
``jnp.argmin`` take them (``torch.max`` / ``min`` with ``dim`` promise no
order, ``argmax`` / ``argmin`` take the first).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from agplace_tpu_torch.models.layers import l2n
from agplace_tpu_torch.retrieval.knn import pairwise_l2

_BIG = 1e9


def batch_hard_triplet_loss(embeddings: torch.Tensor,
                            positives_mask: torch.Tensor,
                            negatives_mask: torch.Tensor,
                            margin: float = 0.2,
                            normalize_embeddings: bool = True,
                            swap: bool = True
                            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """embeddings [N, C], masks [N, N] bool -> (loss, stats)."""
    x = l2n(embeddings) if normalize_embeddings else embeddings
    d = pairwise_l2(x, x)
    big = torch.tensor(_BIG, dtype=d.dtype, device=d.device)
    pos_d = torch.where(positives_mask, d, -big)
    hardest_pos_idx = torch.argmax(pos_d, dim=1)
    hardest_pos = pos_d.gather(1, hardest_pos_idx[:, None])[:, 0]
    neg_d = torch.where(negatives_mask, d, big)
    hardest_neg_idx = torch.argmin(neg_d, dim=1)
    hardest_neg = neg_d.gather(1, hardest_neg_idx[:, None])[:, 0]
    valid = positives_mask.any(dim=1) & negatives_mask.any(dim=1)
    an = hardest_neg
    if swap:  # the positive-negative distance, when it is smaller
        an = torch.minimum(an, d[hardest_pos_idx, hardest_neg_idx])
    per_anchor = torch.clamp(hardest_pos - an + margin, min=0.0)
    per_anchor = torch.where(valid, per_anchor, torch.zeros_like(per_anchor))
    nonzero = (per_anchor > 0).float().sum()
    loss = per_anchor.sum() / torch.clamp(nonzero, min=1.0)
    zero = torch.zeros_like(hardest_pos)
    stats = {
        "num_triplets": valid.int().sum(),
        "num_non_zero_triplets": nonzero,
        "mean_pos_pair_dist": torch.where(valid, hardest_pos, zero).mean(),
        "mean_neg_pair_dist": torch.where(valid, hardest_neg, zero).mean(),
        "max_pos_pair_dist": torch.where(valid, hardest_pos, -big).max(),
        "min_neg_pair_dist": torch.where(valid, hardest_neg, big).min(),
    }
    return loss, stats


def multi_batch_hard_triplet_loss(outputs: Dict[str, torch.Tensor],
                                  positives_mask: torch.Tensor,
                                  negatives_mask: torch.Tensor,
                                  margin: float = 0.2,
                                  weights: Sequence[float] = (1.0, 0.0, 0.0),
                                  normalize_embeddings: bool = True
                                  ) -> Tuple[torch.Tensor,
                                             Dict[str, torch.Tensor]]:
    """Weighted batch-hard losses over ``embedding``, ``cloud_embedding``
    and ``image_embedding`` (a key that is absent or None is skipped; a
    zero weight keeps its stats but not its loss)."""
    assert len(weights) == 3
    loss = torch.zeros(())
    stats: Dict[str, torch.Tensor] = {}
    for w, key, prefix in zip(weights,
                              ("embedding", "cloud_embedding",
                               "image_embedding"),
                              ("final", "cloud", "image")):
        if outputs.get(key) is None:
            continue
        part, s = batch_hard_triplet_loss(outputs[key], positives_mask,
                                          negatives_mask, margin,
                                          normalize_embeddings)
        stats.update({f"{prefix}_{k}": v for k, v in s.items()})
        if w > 0:
            loss = loss.to(part.device) + w * part
    stats["loss"] = loss
    return loss, stats


def masks_from_eastnorth(eastnorth: np.ndarray, positive_thd: float = 10.0,
                         negative_thd: float = 25.0
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """[N, N] positive / negative masks from UTM positions (an anchor is
    not its own positive)."""
    d = np.linalg.norm(eastnorth[:, None] - eastnorth[None], axis=-1)
    eye = np.eye(len(eastnorth), dtype=bool)
    return np.logical_and(d < positive_thd, ~eye), d > negative_thd
