"""Dataset interface and the fixed-shape collates
(``agplace_tpu/data/base.py``).

A dataset is a plain object with numpy item loaders; ``collate_cache_*``
stack a batch of them, and ``collate_cache_q`` builds the query tower's
voxel input on the host (``data/voxels.prepare_query_vox``) and moves it to
the caller's device.  ``collate_train`` builds one training batch on the
host (numpy arrays and a CPU ``BEVGrid``); ``data/pipeline.
prefetch_to_device`` moves it to the card.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from agplace_tpu_torch.config import Config
from agplace_tpu_torch.data.voxels import prepare_query_vox


class PlaceDataset:
    """Protocol both towers' data sources implement.

    Indices [0, database_num) are aerial tiles; queries are separate.
    Geometry is UTM east/north in metres.
    """

    database_num: int = 0
    queries_num: int = 0
    db_eastnorth: np.ndarray  # [database_num, 2] float64
    q_eastnorth: np.ndarray  # [queries_num, 2] float64

    # eval ground truth: db indices within val_positive_dist_threshold
    soft_positives_per_query: List[np.ndarray]
    # mining ground truth: db indices within train_positives_dist_threshold
    hard_positives_per_query: Optional[List[np.ndarray]] = None

    def load_query_image(self, idx: int) -> np.ndarray:  # [H, W, 3] f32
        raise NotImplementedError

    def load_query_points(self, idx: int) -> np.ndarray:  # [P, 3], NaN pad
        raise NotImplementedError

    def load_db_maps(self, idx: int) -> np.ndarray:  # [NMAP, H, W, 3] f32
        raise NotImplementedError


def _rot_z(points: np.ndarray, angle_rad: float) -> np.ndarray:
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    return points @ rot.T


def collate_train(ds: PlaceDataset, triplets: np.ndarray, cfg: Config,
                  rng: np.random.Generator) -> Dict:
    """One training batch from ``triplets`` [B, 2+nneg] global ids (query,
    positive, negatives), drawing from ``rng`` in the JAX package's order:
    stacked query images, one +-``pc_rot_aug_deg`` z-rotation of every
    point cloud of the batch, [B, 1+nneg, NMAP, H, W, 3] aerial stacks, and
    local triplet indices into the flattened [B*(2+nneg)] feature matrix
    (sample i: 0 = query, 1 = positive, 2+j = negative j)."""
    b = triplets.shape[0]
    nneg = triplets.shape[1] - 2
    images = np.stack([ds.load_query_image(q) for q in triplets[:, 0]])
    pts = np.stack([ds.load_query_points(q) for q in triplets[:, 0]])
    if cfg.data.pc_rot_aug_deg > 0:
        ang = np.deg2rad(rng.uniform(-cfg.data.pc_rot_aug_deg,
                                     cfg.data.pc_rot_aug_deg))
        pts = _rot_z(pts, ang)
    db_maps = np.stack([
        np.stack([ds.load_db_maps(d) for d in row[1:]]) for row in triplets
    ])
    q_en = ds.q_eastnorth[triplets[:, 0]].astype(np.float32)
    db_en = np.stack([ds.db_eastnorth[row[1:]] for row in triplets]).astype(
        np.float32)
    group = 2 + nneg
    i, j = np.meshgrid(np.arange(b), np.arange(nneg), indexing="ij")
    tri = np.stack([i * group, i * group + 1, i * group + 2 + j],
                   axis=-1).reshape(b * nneg, 3).astype(np.int32)
    return {
        "query_image": images,
        "vox": prepare_query_vox(cfg, pts, "cpu"),
        "query_eastnorth": q_en,
        "db_map": db_maps,
        "db_eastnorth": db_en,
        "triplets_local": tri,
    }


def collate_cache_db(ds: PlaceDataset, indices: Sequence[int]) -> np.ndarray:
    """[B, NMAP, H, W, 3] aerial stack."""
    return np.stack([ds.load_db_maps(i) for i in indices])


def collate_cache_q(ds: PlaceDataset, indices: Sequence[int], cfg: Config,
                    device="cuda", dtype: Optional[torch.dtype] = None):
    """(query images [B, H, W, 3] numpy, the voxel input on ``device``: the
    card unless the caller passes ``"cpu"``)."""
    images = np.stack([ds.load_query_image(i) for i in indices])
    pts = np.stack([ds.load_query_points(i) for i in indices])
    return images, prepare_query_vox(cfg, pts, device, dtype)


def pad_positives(positives: List[np.ndarray], pad_to: Optional[int] = None):
    """Variable-length positive sets -> a [Q, P_max] int64 matrix padded
    with -1, and the counts."""
    p_max = max(pad_to or max((len(p) for p in positives), default=1), 1)
    out = np.full((len(positives), p_max), -1, np.int64)
    for i, p in enumerate(positives):
        k = min(len(p), p_max)
        out[i, :k] = p[:k]
    counts = np.array([min(len(p), p_max) for p in positives], np.int64)
    return out, counts
