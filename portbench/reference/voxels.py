"""The query tower's occupancy grid from raw point clouds, in numpy.

MinkowskiEngine's ``sparse_quantize`` as the model reads it: each point's
voxel is ``floor(p / quant)``, clamped to the static grid of +-63 voxels; a
cloud keeps its lexicographically smallest ``capacity`` distinct voxels;
the grid [X, Y, Z] is centred (voxel c lands in cell c + extent // 2,
clamped to the grid).  Non-finite points are dropped.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

GRID_RADIUS = 64


def occupancy(points: np.ndarray, quant: float, capacity: int,
              extent: Tuple[int, int, int]) -> np.ndarray:
    """Clouds [B, P, 3] -> bool occupancy [B, X, Y, Z]."""
    pts = np.asarray(points, np.float32)
    b = pts.shape[0]
    x, y, z = extent
    out = np.zeros((b, x, y, z), bool)
    half = np.array([x // 2, y // 2, z // 2])
    top = np.array([x - 1, y - 1, z - 1])
    for i in range(b):
        p = pts[i][np.all(np.isfinite(pts[i]), axis=-1)]
        c = np.floor(p / np.float32(quant)).astype(np.int64)
        c = np.clip(c, -GRID_RADIUS + 1, GRID_RADIUS - 1)
        c = np.unique(c, axis=0)[:capacity]
        cell = np.clip(c + half, 0, top)
        out[i, cell[:, 0], cell[:, 1], cell[:, 2]] = True
    return out


def rotate_z(points: np.ndarray, degrees: float) -> np.ndarray:
    """Every cloud of a batch turned about z by ``degrees``."""
    a = np.deg2rad(degrees)
    c, s = np.cos(a), np.sin(a)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    return np.asarray(points, np.float32) @ rot.T
