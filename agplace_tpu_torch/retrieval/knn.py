"""Exact nearest-neighbour search (``agplace_tpu/retrieval/knn.py``),
faiss ``IndexFlatL2`` / ``IndexFlatIP`` semantics: squared distances
ascending (similarities descending), and for k > N the missing slots padded
with +inf (-inf) and index -1.

``||q - d||^2 = ||q||^2 + ||d||^2 - 2 q.d`` with the cross term one fp32
``torch.matmul`` (TF32 is off in this package: the expanded form is
tie-sensitive), as XLA computed it outside any kernel.

Ties come out lowest index first, as ``lax.top_k`` gives them, on every
device: ``torch.topk`` promises no order among equal values, so its k are
reordered by column where they tie, and a row whose tie straddles the
k-th place is taken again on an int64 key that packs each value's
order-preserving 32-bit image above its column (``_ascending_topk``).
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


def pairwise_l2(queries: torch.Tensor, database: torch.Tensor
                ) -> torch.Tensor:
    """[Q, D] Euclidean distances, zero where the squared distance is zero
    (a safe sqrt: no infinite gradient at zero)."""
    d2 = pairwise_sq_l2(queries, database)
    nonzero = d2 > 0
    return torch.where(nonzero, torch.sqrt(torch.where(nonzero, d2, 1.0)),
                       0.0)


def _keyed_topk(values: torch.Tensor, k: int):
    """``_ascending_topk`` by one ``topk`` of int64 keys, each value's
    order-preserving int32 image above its column.  The int32 image of a
    float is its bits, the 31 low ones flipped when the sign is set: it
    orders as the floats do and is its own inverse.  Overwrites
    ``values``."""
    bits = values.view(torch.int32)
    bits ^= (bits >> 31) & 0x7FFFFFFF
    cols = torch.arange(bits.shape[1], device=bits.device,
                        dtype=torch.int64)
    key = bits.to(torch.int64).mul_(1 << 32).bitwise_or_(cols)
    top, idx = torch.topk(key, k, dim=1, largest=False, sorted=True)
    hi = (top >> 32).to(torch.int32)
    return (hi ^ ((hi >> 31) & 0x7FFFFFFF)).view(torch.float32), idx


def _ascending_topk(values: torch.Tensor, k: int):
    """(values [Q, k], columns [Q, k]) of the k smallest of the fp32
    ``values`` per row, ascending, equal values lowest column first.  The
    callers' temporary ``values`` is overwritten; -0.0 counts as +0.0.

    One ``topk`` of k + 1 settles which k are taken wherever the k-th and
    the (k+1)-th values differ; two stable sorts of those k order their
    ties by column.  Rows where a tie straddles the k-th place go through
    ``_keyed_topk``; k = N is a stable sort of the row."""
    v = values.add_(0.0)  # -0.0 + 0.0 = +0.0
    if k >= v.shape[1]:
        return tuple(torch.sort(v, dim=1, stable=True))
    top, cols = torch.topk(v, k + 1, dim=1, largest=False, sorted=True)
    straddle = (top[:, k - 1] == top[:, k]).nonzero()[:, 0]
    cols, order = cols[:, :k].sort(dim=1)
    top, order = top[:, :k].gather(1, order).sort(dim=1, stable=True)
    cols = cols.gather(1, order)
    if straddle.numel():
        top[straddle], cols[straddle] = _keyed_topk(v[straddle], k)
    return top, cols


def _pad(vals: torch.Tensor, idx: torch.Tensor, k: int, fill: float):
    """faiss's k > N padding: ``fill`` values and index -1."""
    if idx.shape[1] == k:
        return vals, idx
    qn, pad = vals.shape[0], k - idx.shape[1]
    return (torch.cat([vals, vals.new_full((qn, pad), fill)], dim=1),
            torch.cat([idx, idx.new_full((qn, pad), -1)], dim=1))


def l2_topk(queries: torch.Tensor, database: torch.Tensor, k: int):
    """(sq_distances [Q, k] fp32, indices [Q, k] int64), ascending."""
    d2 = pairwise_sq_l2(queries.float(), database.float())
    d, idx = _ascending_topk(d2, min(k, database.shape[0]))
    return _pad(d, idx, k, float("inf"))


def ip_topk(queries: torch.Tensor, database: torch.Tensor, k: int):
    """Exact max-inner-product search: (similarities [Q, k] fp32, indices
    [Q, k] int64), descending, equal similarities lowest index first."""
    sims = queries.float() @ database.float().T
    neg, idx = _ascending_topk(sims.neg_(), min(k, database.shape[0]))
    return _pad(-neg, idx, k, float("-inf"))


def l2_topk_blocked(queries: np.ndarray, database: torch.Tensor, k: int,
                    block: int = 1024):
    """Host-driven blocked search (query blocks of ``block`` rows, so the
    [Q, N] distance matrix stays bounded).  Returns numpy (distances,
    indices), fetched from the device once."""
    ds, idxs = [], []
    for start in range(0, queries.shape[0], block):
        chunk = torch.as_tensor(
            np.asarray(queries[start:start + block], np.float32),
            device=database.device)
        d, i = l2_topk(chunk, database, k)
        ds.append(d)
        idxs.append(i)
    if not ds:
        return np.zeros((0, k), np.float32), np.zeros((0, k), np.int64)
    return torch.cat(ds).cpu().numpy(), torch.cat(idxs).cpu().numpy()


def radius_neighbors(points_a: np.ndarray, points_b: np.ndarray,
                     radius: float, block: int = 4096):
    """All indices of ``points_b`` within ``radius`` of each row of
    ``points_a`` (the geographic ground truth): a list of int64 arrays, one
    per row, computed in float64 on the host in blocks of ``block`` rows
    (UTM coordinates are ~1e5 m: float32 would lose metres)."""
    a = np.asarray(points_a, dtype=np.float64)
    b = np.asarray(points_b, dtype=np.float64)
    out = []
    r2 = radius * radius
    for start in range(0, a.shape[0], block):
        chunk = a[start:start + block]
        diff2 = ((chunk[:, None, 0] - b[None, :, 0]) ** 2
                 + (chunk[:, None, 1] - b[None, :, 1]) ** 2)
        for row in diff2 <= r2:
            out.append(np.flatnonzero(row))
    return out
