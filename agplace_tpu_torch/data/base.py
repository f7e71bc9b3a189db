"""Dataset interface and the fixed-shape eval collates
(``agplace_tpu/data/base.py``).

A dataset is a plain object with numpy item loaders; ``collate_cache_*``
stack a batch of them, and ``collate_cache_q`` builds the query tower's
voxel input on the host (``data/voxels.prepare_query_vox``) and moves it to
the caller's device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

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
