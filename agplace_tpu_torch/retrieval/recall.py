"""Recall@N against geographic ground truth, and the crop merges of the
five-crop test methods (``agplace_tpu/retrieval/recall.py``), in numpy.

Recall@N is the percentage of queries whose top-N predictions hold at
least one database index of the query's soft positives (tiles within
``val_positive_dist_threshold``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def compute_recalls(
    predictions: np.ndarray,
    positives_per_query: Sequence[np.ndarray],
    recall_values: Sequence[int] = (1, 5, 10, 20),
) -> Tuple[np.ndarray, str]:
    """predictions: [Q, max(recall_values)] database indices, nearest
    first.  The first recall level at which a positive appears credits that
    level and every larger one.  Returns (recalls in percent, "R@1: ..")."""
    recalls = np.zeros(len(recall_values))
    n_q = predictions.shape[0]
    for q, pred in enumerate(predictions):
        pos = positives_per_query[q]
        for i, n in enumerate(recall_values):
            if np.any(np.isin(pred[:n], pos)):
                recalls[i:] += 1
                break
    recalls = recalls / max(n_q, 1) * 100
    recalls_str = ", ".join(
        f"R@{v}: {r:.1f}" for v, r in zip(recall_values, recalls))
    return recalls, recalls_str


def dedup_nearest_crop(distances: np.ndarray, predictions: np.ndarray,
                       keep: int = 20) -> np.ndarray:
    """'nearest_crop': the 5 crops of a query were searched apart; merge
    their predictions by distance and drop repeats.  distances /
    predictions: [Q, 5*keep] -> [Q, keep]."""
    out = np.empty((predictions.shape[0], keep), dtype=predictions.dtype)
    for q in range(predictions.shape[0]):
        order = np.argsort(distances[q])
        preds = predictions[q, order]
        _, unique_idx = np.unique(preds, return_index=True)
        out[q] = preds[np.sort(unique_idx)][:keep]
    return out


def top_n_voting(topn: str, predictions: np.ndarray, distances: np.ndarray,
                 maj_weight: float) -> None:
    """'maj_voting' vote boost of one query, in place on ``distances``
    (predictions / distances: [5, 20], 5 crops x top 20): a database index
    that ``count`` crops hold among their first n loses
    ``maj_weight * count / n`` of distance there.  ``distances[:,
    selected]`` is a view, so the masked subtraction writes through."""
    if topn == "top1":
        n, selected = 1, 0
    elif topn == "top5":
        n, selected = 5, slice(0, 5)
    elif topn == "top10":
        n, selected = 10, slice(0, 10)
    else:
        raise ValueError(topn)
    vals, counts = np.unique(predictions[:, selected], return_counts=True)
    for val, count in zip(vals[counts > 1], counts[counts > 1]):
        mask = predictions[:, selected] == val
        distances[:, selected][mask] -= maj_weight * count / n


def maj_voting_merge(distances: np.ndarray, predictions: np.ndarray,
                     maj_weight: float, keep: int = 20) -> np.ndarray:
    """'maj_voting' merge across the 5 crops: boost (``top_n_voting`` at
    top1, top5 and top10, in place), then merge by distance and drop
    repeats.  distances / predictions: [Q, 5, keep] -> [Q, keep]."""
    out = np.empty((predictions.shape[0], keep), dtype=predictions.dtype)
    for q in range(predictions.shape[0]):
        for topn in ("top1", "top5", "top10"):
            top_n_voting(topn, predictions[q], distances[q], maj_weight)
        dists = distances[q].flatten()
        preds = predictions[q].flatten()
        order = np.argsort(dists)
        preds = preds[order]
        _, unique_idx = np.unique(preds, return_index=True)
        out[q] = preds[np.sort(unique_idx)][:keep]
    return out
