"""Exact L2 nearest-neighbour search (``agplace_tpu/retrieval/knn.py``),
faiss ``IndexFlatL2`` semantics: squared distances, ascending, and for
k > N the missing slots padded with +inf and index -1.

``||q - d||^2 = ||q||^2 + ||d||^2 - 2 q.d`` with the cross term one fp32
``torch.matmul`` (TF32 is off in this package: the expanded form is
tie-sensitive), as XLA computed it outside any kernel.
"""

from __future__ import annotations

import numpy as np
import torch


def pairwise_sq_l2(queries: torch.Tensor,
                   database: torch.Tensor) -> torch.Tensor:
    """[Q, D] squared L2 distances, clamped at zero."""
    q_sq = (queries * queries).sum(dim=-1, keepdim=True)
    d_sq = (database * database).sum(dim=-1)
    cross = queries @ database.T
    return torch.clamp(q_sq + d_sq[None, :] - 2.0 * cross, min=0.0)


def l2_topk(queries: torch.Tensor, database: torch.Tensor, k: int):
    """(sq_distances [Q, k] fp32, indices [Q, k] int64)."""
    d2 = pairwise_sq_l2(queries.float(), database.float())
    kk = min(k, database.shape[0])
    d, idx = torch.topk(d2, kk, dim=1, largest=False, sorted=True)
    if kk < k:
        qn = d2.shape[0]
        d = torch.cat([d, d.new_full((qn, k - kk), float("inf"))], dim=1)
        idx = torch.cat([idx, idx.new_full((qn, k - kk), -1)], dim=1)
    return d, idx


def l2_topk_blocked(queries: np.ndarray, database: torch.Tensor, k: int,
                    block: int = 1024):
    """Host-driven blocked search (query blocks of ``block`` rows, so the
    [Q, N] distance matrix stays bounded).  Returns numpy (distances,
    indices)."""
    n = queries.shape[0]
    out_d = np.empty((n, k), dtype=np.float32)
    out_i = np.empty((n, k), dtype=np.int64)
    for start in range(0, n, block):
        stop = min(start + block, n)
        chunk = torch.as_tensor(np.asarray(queries[start:stop], np.float32),
                                device=database.device)
        d, i = l2_topk(chunk, database, k)
        out_d[start:stop] = d.cpu().numpy()
        out_i[start:stop] = i.cpu().numpy()
    return out_d, out_i
