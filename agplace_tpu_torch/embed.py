"""Batched descriptor extraction for evaluation (``agplace_tpu/embed.py``).

Indices are taken in batches of ``bs``; the last batch is padded with
copies of its last index (one batch shape for every call) and trimmed.
Each batch's descriptors stay on the device: they are trimmed and
concatenated there and fetched to the host once, as fp32 numpy.

The ``embed_*`` closures are ``infer.make_infer_fns``'s.  The batches go to
``device``: the card unless the caller passes ``"cpu"``.

With a data ``mesh`` that holds this rank (JAX's ``_put`` of each batch
over the ``data`` axis), each rank collates and embeds its contiguous
block of every padded batch, and one all-gather at the end returns every
batch's descriptors, in order, to every rank of the mesh.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from agplace_tpu_torch.config import Config
from agplace_tpu_torch.data.base import collate_cache_db, collate_cache_q
from agplace_tpu_torch.data.voxels import prepare_query_vox
from agplace_tpu_torch.device import resolve_device
from agplace_tpu_torch.infer import compute_dtype
from agplace_tpu_torch.parallel.mesh import MeshAxis, all_gather, mesh_axis


def to_device(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)


def padded_batches(indices: Sequence[int], bs: int,
                   ax: Optional[MeshAxis] = None):
    """(chunk padded to ``bs`` with its last index, rows to keep); with a
    data axis ``ax``, the chunk is this rank's block of it."""
    if ax is not None and bs % ax.size:
        raise ValueError(f"batch {bs} does not split over {ax.size} ranks")
    for s in range(0, len(indices), bs):
        chunk = list(indices[s:s + bs])
        keep = len(chunk)
        chunk = chunk + [chunk[-1]] * (bs - keep)
        if ax is not None:
            b = bs // ax.size
            chunk = chunk[ax.index * b:(ax.index + 1) * b]
        yield chunk, keep


def drain(parts: List[torch.Tensor], keeps: List[int],
          ax: Optional[MeshAxis] = None) -> np.ndarray:
    """The first ``keeps[j]`` rows of each batch's descriptors, concatenated
    on the device and fetched once as fp32 numpy.  With a data axis
    ``ax``, ``parts`` are this rank's blocks, gathered first in one
    all-gather."""
    if not parts:
        return np.empty((0, 0), np.float32)
    if ax is not None:
        nb, b = len(parts), parts[0].shape[0]
        full = all_gather(torch.stack(parts), ax)  # [W * nb, b, ...]
        parts = full.view(ax.size, nb, *parts[0].shape).transpose(0, 1) \
            .reshape(nb, ax.size * b, *parts[0].shape[1:]).unbind(0)
    return torch.cat([p[:k] for p, k in zip(parts, keeps)]).float() \
        .cpu().numpy()


def batched_embed_db(ds, indices: Sequence[int], embed_db, bs: int,
                     device="cuda", mesh=None) -> np.ndarray:
    """[len(indices), C] aerial-tile descriptors."""
    device = resolve_device(device)
    ax = mesh_axis(mesh, "data")
    parts, keeps = [], []
    for chunk, keep in padded_batches(indices, bs, ax):
        parts.append(embed_db(to_device(collate_cache_db(ds, chunk),
                                        device)))
        keeps.append(keep)
    return drain(parts, keeps, ax)


def batched_embed_q(ds, indices: Sequence[int], embed_q, bs: int,
                    cfg: Config, device="cuda", mesh=None) -> np.ndarray:
    """[len(indices), C] query descriptors (image + point cloud)."""
    device = resolve_device(device)
    ax = mesh_axis(mesh, "data")
    parts, keeps = [], []
    for chunk, keep in padded_batches(indices, bs, ax):
        images, vox = collate_cache_q(ds, chunk, cfg, device,
                                      compute_dtype(cfg))
        parts.append(embed_q(to_device(images, device), vox))
        keeps.append(keep)
    return drain(parts, keeps, ax)


def batched_embed_q_crops(ds, indices: Sequence[int], embed_q, bs: int,
                          cfg: Config, device="cuda",
                          mesh=None) -> np.ndarray:
    """[5*len(indices), C]: the five crops of each query
    (``ds.load_query_crops(i, cfg.data.q_resize)``, [5, H, W, 3]) embedded
    at batch 5*bs, each with the query's point cloud; row 5*q + c is crop
    c of query q."""
    device = resolve_device(device)
    ax = mesh_axis(mesh, "data")
    parts, keeps = [], []
    for chunk, keep in padded_batches(indices, bs, ax):
        crops = np.stack([ds.load_query_crops(i, cfg.data.q_resize)
                          for i in chunk])  # [b, 5, H, W, 3]
        pts = np.stack([ds.load_query_points(i) for i in chunk])
        vox = prepare_query_vox(cfg, np.repeat(pts, 5, axis=0), device,
                                compute_dtype(cfg))
        out = embed_q(to_device(crops.reshape(-1, *crops.shape[2:]), device),
                      vox)  # [5*b, C]
        parts.append(out.reshape(len(chunk), 5, -1))
        keeps.append(keep)
    stacked = drain(parts, keeps, ax)
    return stacked.reshape(-1, stacked.shape[-1]) if parts else stacked
