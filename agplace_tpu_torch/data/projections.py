"""Point-cloud -> BEV height grid and spherical range image
(``agplace_tpu/data/projections.py``): the port's own numpy copy, host
side, fixed output shapes, bit-equal to JAX's.
"""

from __future__ import annotations

import numpy as np


def generate_bev_from_pc(pc: np.ndarray, w: int = 200,
                         max_thd: float = 100.0) -> np.ndarray:
    """Scatter z into a (w+1, w+1) top-down grid after clamping to ±max_thd
    (``kitti360:286-307``)."""
    pc = pc[np.all(np.isfinite(pc), axis=-1)]
    pc = pc[np.max(np.abs(pc), axis=1) < max_thd]
    bev = np.zeros((w + 1, w + 1), np.float32)
    if len(pc) == 0:
        return bev
    grid = ((pc + max_thd) / (2 * max_thd) * w).astype(np.int64)
    bev[grid[:, 0], grid[:, 1]] = pc[:, 2]
    return bev


def generate_sph_from_pc(pc: np.ndarray, w: int = 361,
                         h: int = 61) -> np.ndarray:
    """Spherical range image: elevation/azimuth -> (h, w) grid of ranges
    (``kitti360:312-353``).  Elevation mapping matches the reference's
    KITTI-360 constants (u = h - 2*(elev_deg + 25))."""
    pc = pc[np.all(np.isfinite(pc), axis=-1)]
    sph = np.zeros((h, w), np.float32)
    if len(pc) == 0:
        return sph
    u = np.arctan2(pc[:, 2], np.sqrt(pc[:, 0] ** 2 + pc[:, 1] ** 2))
    u = h - (u / np.pi * 180 + 25) * 2
    v = np.arctan2(pc[:, 0], pc[:, 1]) / np.pi * 180 + 180
    r = np.sqrt((pc ** 2).sum(1))
    uv = np.stack([u, v], 1).astype(np.int32)
    keep = (uv[:, 0] >= 0) & (uv[:, 0] < h) & (uv[:, 1] >= 0) & (uv[:, 1] < w)
    uv, r = uv[keep], r[keep]
    sph[uv[:, 0], uv[:, 1]] = r
    return sph
