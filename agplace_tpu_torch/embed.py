"""Batched descriptor extraction for evaluation (``agplace_tpu/embed.py``).

Indices are taken in batches of ``bs``; the last batch is padded with
copies of its last index (one batch shape for every call) and trimmed.
Each batch's descriptors stay on the device: they are trimmed and
concatenated there and fetched to the host once, as fp32 numpy.

The ``embed_*`` closures are ``infer.make_infer_fns``'s.  The batches go to
``device``: the card unless the caller passes ``"cpu"``.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from agplace_tpu_torch.config import Config
from agplace_tpu_torch.data.base import collate_cache_db, collate_cache_q
from agplace_tpu_torch.data.voxels import prepare_query_vox
from agplace_tpu_torch.device import resolve_device
from agplace_tpu_torch.infer import compute_dtype


def to_device(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)


def padded_batches(indices: Sequence[int], bs: int):
    """(chunk padded to ``bs`` with its last index, rows to keep)."""
    for s in range(0, len(indices), bs):
        chunk = list(indices[s:s + bs])
        keep = len(chunk)
        yield chunk + [chunk[-1]] * (bs - keep), keep


def drain(parts: List[torch.Tensor], keeps: List[int]) -> np.ndarray:
    """The first ``keeps[j]`` rows of each batch's descriptors, concatenated
    on the device and fetched once as fp32 numpy."""
    if not parts:
        return np.empty((0, 0), np.float32)
    return torch.cat([p[:k] for p, k in zip(parts, keeps)]).float() \
        .cpu().numpy()


def batched_embed_db(ds, indices: Sequence[int], embed_db, bs: int,
                     device="cuda") -> np.ndarray:
    """[len(indices), C] aerial-tile descriptors."""
    device = resolve_device(device)
    parts, keeps = [], []
    for chunk, keep in padded_batches(indices, bs):
        parts.append(embed_db(to_device(collate_cache_db(ds, chunk),
                                        device)))
        keeps.append(keep)
    return drain(parts, keeps)


def batched_embed_q(ds, indices: Sequence[int], embed_q, bs: int,
                    cfg: Config, device="cuda") -> np.ndarray:
    """[len(indices), C] query descriptors (image + point cloud)."""
    device = resolve_device(device)
    parts, keeps = [], []
    for chunk, keep in padded_batches(indices, bs):
        images, vox = collate_cache_q(ds, chunk, cfg, device,
                                      compute_dtype(cfg))
        parts.append(embed_q(to_device(images, device), vox))
        keeps.append(keep)
    return drain(parts, keeps)


def batched_embed_q_crops(ds, indices: Sequence[int], embed_q, bs: int,
                          cfg: Config, device="cuda") -> np.ndarray:
    """[5*len(indices), C]: the five crops of each query
    (``ds.load_query_crops(i, cfg.data.q_resize)``, [5, H, W, 3]) embedded
    at batch 5*bs, each with the query's point cloud; row 5*q + c is crop
    c of query q."""
    device = resolve_device(device)
    parts, keeps = [], []
    for chunk, keep in padded_batches(indices, bs):
        crops = np.stack([ds.load_query_crops(i, cfg.data.q_resize)
                          for i in chunk])  # [bs, 5, H, W, 3]
        pts = np.stack([ds.load_query_points(i) for i in chunk])
        vox = prepare_query_vox(cfg, np.repeat(pts, 5, axis=0), device,
                                compute_dtype(cfg))
        out = embed_q(to_device(crops.reshape(-1, *crops.shape[2:]), device),
                      vox)  # [5*bs, C]
        parts.append(out.reshape(bs, 5, -1))
        keeps.append(keep)
    stacked = drain(parts, keeps)
    return stacked.reshape(-1, stacked.shape[-1]) if parts else stacked
