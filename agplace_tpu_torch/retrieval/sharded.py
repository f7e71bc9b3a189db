"""Exact retrieval over a gallery split across the ranks of a mesh's
``gallery`` axis (``agplace_tpu/retrieval/sharded.py``), for galleries
beyond one card's memory.

Each rank holds one contiguous block of rows on its device, the gallery
padded at the end with sentinel rows that never enter a top-k.  Each rank
takes its local top-``min(k, shard_rows)`` with the single-device search
(``knn.l2_topk`` / ``knn.l2_candidates_int8``: fp32, TF32 off), offsets
its indices by ``rank * shard_rows``, and one all-gather of the ``[Q, k]``
candidates, rank-major, feeds the merge.  Candidates gathered rank-major
are in global-index order within equal distances, and the merge takes
equal values lowest column first, so ties come out lowest global index
first, as ``lax.top_k`` over JAX's gathered array gives them.  The ``[Q,
rows]`` distance matrices never leave their rank.

Every rank of the gallery axis calls these functions with the same
queries.  Nothing here is cached: a gallery's process group lives in its
``Mesh``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from agplace_tpu_torch.parallel.mesh import Mesh, MeshAxis, all_gather
from agplace_tpu_torch.retrieval.knn import (_ascending_topk,
                                             l2_candidates_int8, l2_topk,
                                             quantize_rows)


def _axis(mesh: Mesh, axis: str) -> MeshAxis:
    ax = mesh.axis(axis)
    if ax is None:
        raise ValueError(f"this rank is not in the gallery mesh {mesh}")
    return ax


def _block(db: np.ndarray, ax: MeshAxis, multiple: int, fill: float
           ) -> np.ndarray:
    """This rank's rows of ``db`` padded with ``fill`` rows to a multiple
    of ``ax.size * multiple`` rows."""
    rem = (-len(db)) % (ax.size * multiple)
    if rem:
        db = np.concatenate([db, np.full((rem, db.shape[1]), fill,
                                         db.dtype)])
    rows = len(db) // ax.size
    return db[ax.index * rows:(ax.index + 1) * rows]


def shard_gallery(mesh: Mesh, database, axis: str = "gallery",
                  device="cuda") -> torch.Tensor:
    """This rank's block [rows / W, C] of the [rows, C] gallery on
    ``device``; the gallery padded with 1e18 rows (at huge distance from
    any query) to a multiple of the axis's width W."""
    db = np.asarray(database, np.float32)
    return torch.from_numpy(np.ascontiguousarray(
        _block(db, _axis(mesh, axis), 1, 1e18))).to(device)


def shard_quant_gallery(mesh: Mesh, database, axis: str = "gallery",
                        device="cuda") -> Tuple[torch.Tensor, ...]:
    """int8 variant of ``shard_gallery``: this rank's block of the
    per-row quantized gallery (``knn.quantize_rows``) on ``device``: int8
    rows, scales and exact squared norms.  Padding rows are 1e9 in every
    component before quantising, so their exact norms dwarf any real
    distance; the gallery is padded to a multiple of 8 W rows and the
    columns to a multiple of 8, as the card's int8 GEMM needs
    (``knn.int8_cross``)."""
    db = np.asarray(database, np.float32)
    db = np.pad(db, ((0, 0), (0, -db.shape[1] % 8)))
    q, scale, sq = quantize_rows(_block(db, _axis(mesh, axis), 8, 1e9))
    return tuple(torch.from_numpy(a).to(device)
                 for a in (q, scale[:, 0], sq))


def _merge(d: torch.Tensor, gidx: torch.Tensor, ax: MeshAxis, k: int):
    """The global top-``k`` of every rank's ascending local candidates
    (``d`` [Q, kl], global indices ``gidx`` [Q, kl])."""
    qn = d.shape[0]

    def gathered(x):  # [Q, W * kl], rank-major within each row
        return all_gather(x, ax).view(ax.size, qn, -1).transpose(0, 1) \
            .reshape(qn, -1)

    cand_d, cand_i = gathered(d), gathered(gidx)
    best, slot = _ascending_topk(cand_d, min(k, cand_d.shape[1]))
    return best, torch.gather(cand_i, 1, slot)


def sharded_l2_topk(mesh: Mesh, queries, database_sharded: torch.Tensor,
                    k: int, axis: str = "gallery", n_rows: int = None,
                    block: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact global top-k over a gallery from ``shard_gallery``: (sq
    distances [Q, k] fp32, global indices [Q, k] int64) on the gallery's
    device, the same on every rank.  ``n_rows``: the real row count
    before the padding; pass it whenever k can reach the gallery size.
    For k > ``n_rows`` the blocks are gathered and the single-device
    ``l2_topk`` runs on the real rows, giving faiss's +inf / -1 padding
    (a gallery that small fits any card).  The queries go in blocks of
    ``block`` rows, the same blocks on every rank, so a rank's [block,
    rows / W] distance matrix stays bounded as ``knn.l2_topk_blocked``'s
    does (JAX's search takes every query at once)."""
    ax = _axis(mesh, axis)
    q = torch.as_tensor(queries, device=database_sharded.device).float()
    shard_rows = database_sharded.shape[0]
    if n_rows is None:
        n_rows = shard_rows * ax.size
    if k > n_rows:
        return l2_topk(q, all_gather(database_sharded, ax)[:n_rows], k)
    # each real global top-k row wins its shard's top-min(k, shard_rows),
    # and the sentinels lose to every real row: with k <= n_rows the merge
    # is sentinel-free
    out = []
    for start in range(0, max(q.shape[0], 1), block):
        d, i = l2_topk(q[start:start + block], database_sharded,
                       min(k, shard_rows))
        out.append(_merge(d, i + ax.index * shard_rows, ax, k))
    return torch.cat([d for d, _ in out]), torch.cat([i for _, i in out])


def sharded_l2_candidates_int8(mesh: Mesh, queries, quant_gallery, nc: int,
                               axis: str = "gallery"
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate global top-``nc`` L2 candidates (approximate sq
    distances, global indices) over an int8 gallery from
    ``shard_quant_gallery``: each rank's ``knn.l2_candidates_int8``, one
    all-gather, the merge.  The int8 approximation is confined to the
    cross term; feed the indices to an exact re-rank
    (``serving.PlaceIndex``).  A padding row can appear only when the
    gallery holds fewer than ``nc`` real rows; its index is >= the real
    row count."""
    ax = _axis(mesh, axis)
    rows, scale, sq = quant_gallery
    q = torch.as_tensor(queries, device=rows.device).float()
    shard_rows = rows.shape[0]
    d, i = l2_candidates_int8(q, rows, scale, sq, min(nc, shard_rows))
    return _merge(d, i + ax.index * shard_rows, ax, nc)
