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

The int8 gallery (``quantize_rows`` on the host, ``l2_candidates_int8`` on
the gallery's device) gives approximate candidates for an exact re-rank
(``serving.PlaceIndex``): its cross term is one int8 x int8 -> int32
product (``int8_cross``, ``torch._int_mm``), as JAX's ``lax.dot_general``
computed it outside any kernel.
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


def quantize_rows(x: np.ndarray):
    """Per-row symmetric int8 quantization of a descriptor matrix:
    ``x ~= scale[:, None] * q`` with ``q`` int8 in [-127, 127].

    Returns ``(q [N, C] int8, scale [N, 1] f32, sq_norm [N] f32)``; the
    squared norms are the exact fp32 rows', so a search only sees
    quantization noise in the cross term."""
    x = np.asarray(x, np.float32)
    amax = np.maximum(np.abs(x).max(axis=1, keepdims=True), 1e-12)
    scale = (amax / 127.0).astype(np.float32)
    q = np.clip(np.rint(x / scale), -127, 127).astype(np.int8)
    return q, scale, np.einsum("nc,nc->n", x, x).astype(np.float32)


def int8_cross(q_i8: torch.Tensor, db_i8: torch.Tensor) -> torch.Tensor:
    """[Q, N] int32 = ``q_i8 @ db_i8.T`` of int8 [Q, C] and [N, C'], exact;
    a gallery zero-padded to C' >= C columns pads the queries alike.

    On the card this is cuBLASLt's int8 GEMM behind ``torch._int_mm``, which
    takes more than 16 rows and widths that are multiples of 8: the queries
    are padded here with zero rows to a multiple of 8 above 16; the
    gallery's N and C' must already be multiples of 8 (``serving.PlaceIndex``
    pads them when it uploads the rows), else this raises."""
    qn, c = q_i8.shape[0], db_i8.shape[1]
    q_i8 = torch.nn.functional.pad(q_i8, (0, c - q_i8.shape[1]))
    if q_i8.is_cuda:
        if c % 8 or db_i8.shape[0] % 8:
            raise ValueError(f"int8_cross on the card: C = {c} and N = "
                             f"{db_i8.shape[0]} must be multiples of 8")
        q_i8 = torch.nn.functional.pad(
            q_i8, (0, 0, 0, max(24, -(-qn // 8) * 8) - qn))
    return torch._int_mm(q_i8, db_i8.T)[:qn]


def quantize_queries(q: torch.Tensor):
    """(int8 [Q, C], scales [Q, 1] fp32): per-row symmetric quantization of
    fp32 queries on their device, JAX's ``l2_candidates_int8`` step for
    step.  The scale divides by a tensor of 127s, not by the number: on
    the card PyTorch turns a division by a host scalar into a product with
    its reciprocal, which rounds otherwise."""
    amax = torch.clamp(q.abs().amax(dim=1, keepdim=True), min=1e-12)
    qs = amax / torch.full_like(amax, 127.0)
    return torch.clamp(torch.round(q / qs), -127, 127).to(torch.int8), qs


def xla_row_sq(q: torch.Tensor) -> torch.Tensor:
    """[Q, 1] fp32 sums of squares of the rows of ``q``, in the order in
    which XLA's CPU backend sums them in JAX's ``l2_candidates_int8`` at
    the descriptors' width 256: the products rounded, each 32-wide window
    summed in sequence, then the window sums in sequence.  The int8 path's
    approximate distances then equal JAX's bit for bit, so its candidates
    come out in JAX's order, which the exact re-rank keeps among equal
    distances."""
    p = q * q
    if p.shape[1] % 32:
        p = torch.cat([p, p.new_zeros((p.shape[0], -p.shape[1] % 32))], 1)
    win = p.view(p.shape[0], -1, 32)  # [Q, C / 32, 32]
    part = win[..., 0]
    for j in range(1, 32):  # the windows side by side, each in sequence
        part = part + win[..., j]
    total = part[:, 0]
    for w in range(1, part.shape[1]):
        total = total + part[:, w]
    return total[:, None]


def l2_candidates_int8(queries: torch.Tensor, db_i8: torch.Tensor,
                       db_scale: torch.Tensor, db_sq: torch.Tensor,
                       nc: int):
    """Approximate top-``nc`` L2 candidates against an int8 gallery, on the
    gallery's device: (approximate sq distances [Q, nc], indices [Q, nc]),
    ascending, ties lowest index first.

    The fp32 queries are quantized per row (``quantize_queries``;
    ``torch.round`` rounds half to even, as ``jnp.round``); the cross term
    is ``int8_cross``, rescaled in JAX's order ``(cross * qs) *
    db_scale``, and the query norms are ``xla_row_sq``'s.  ``db_scale``
    [N] and ``db_sq`` [N] come from ``quantize_rows`` (a padded row has
    scale 0 and ``db_sq`` +inf, so it never enters the top ``nc``)."""
    q = queries.float()
    q_i8, qs = quantize_queries(q)
    cross = int8_cross(q_i8, db_i8).float() * qs * db_scale[None, :]
    q_sq = xla_row_sq(q)
    d2 = torch.clamp(q_sq + db_sq[None, :] - 2.0 * cross, min=0.0)
    return _ascending_topk(d2, nc)


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
