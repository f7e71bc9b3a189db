"""Point-cloud augmentations (``agplace_tpu/data/pc_augment.py``): the
port's own numpy copy, stateless host ops drawing from the caller's
``np.random.Generator`` in JAX's order, so the same generator gives
bit-equal clouds.  NaN-padded rows stay padding; the removals NaN rows
out instead of shortening the cloud.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _rot_matrix(axis: int, theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    if axis == 0:
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
    if axis == 1:
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


def random_flip(pc: np.ndarray, rng: np.random.Generator,
                p_x: float = 0.5, p_y: float = 0.5) -> np.ndarray:
    """PCRandomFlip (pc_augmentation.py:71): mirror x and/or y."""
    out = pc.copy()
    if rng.uniform() < p_x:
        out[..., 0] = -out[..., 0]
    if rng.uniform() < p_y:
        out[..., 1] = -out[..., 1]
    return out


def random_rotation(pc: np.ndarray, rng: np.random.Generator,
                    axis: int = 2, max_deg: float = 180.0) -> np.ndarray:
    """PCRandomRotation (pc_augmentation.py:94-115; the collate uses ±5° z)."""
    theta = np.deg2rad(rng.uniform(-max_deg, max_deg))
    return pc @ _rot_matrix(axis, theta).T


def random_translation(pc: np.ndarray, rng: np.random.Generator,
                       max_delta: float = 0.05) -> np.ndarray:
    return pc + rng.uniform(-max_delta, max_delta, size=(3,)).astype(
        np.float32)


def random_scale(pc: np.ndarray, rng: np.random.Generator,
                 lo: float = 0.95, hi: float = 1.05) -> np.ndarray:
    return pc * np.float32(rng.uniform(lo, hi))


def random_shear(pc: np.ndarray, rng: np.random.Generator,
                 sigma: float = 0.1) -> np.ndarray:
    shear = np.eye(3, dtype=np.float32)
    shear[0, 1], shear[0, 2] = rng.normal(0, sigma, 2)
    shear[1, 0], shear[1, 2] = rng.normal(0, sigma, 2)
    shear[2, 0], shear[2, 1] = rng.normal(0, sigma, 2)
    return pc @ shear.T


def jitter_points(pc: np.ndarray, rng: np.random.Generator,
                  sigma: float = 0.01, clip: float = 0.05) -> np.ndarray:
    """PCJitterPoints (pc_augmentation.py:146)."""
    noise = np.clip(rng.normal(0, sigma, pc.shape), -clip, clip)
    return pc + noise.astype(np.float32)


def remove_random_points(pc: np.ndarray, rng: np.random.Generator,
                         ratio: float = 0.1) -> np.ndarray:
    """Drop a random fraction by NaN-ing rows (keeps the array fixed-shape,
    unlike the reference's variable-length remove)."""
    n = pc.shape[0]
    k = int(n * ratio)
    if k == 0:
        return pc
    out = pc.copy()
    idx = rng.choice(n, size=k, replace=False)
    out[idx] = np.nan
    return out


def remove_random_block(pc: np.ndarray, rng: np.random.Generator,
                        scale_range: Tuple[float, float] = (0.02, 0.33),
                        aspect: float = 0.3) -> np.ndarray:
    """PCRemoveRandomBlock (pc_augmentation.py:207): erase an axis-aligned
    box covering a random area fraction, NaN-ing contained points."""
    finite = np.all(np.isfinite(pc), axis=-1)
    if not finite.any():
        return pc
    pts = pc[finite]
    mins, maxs = pts.min(0), pts.max(0)
    extent = maxs - mins
    frac = rng.uniform(*scale_range)
    ar = rng.uniform(aspect, 1 / aspect)
    w = extent[0] * np.sqrt(frac * ar)
    h = extent[1] * np.sqrt(frac / ar)
    x0 = rng.uniform(mins[0], maxs[0] - w) if extent[0] > w else mins[0]
    y0 = rng.uniform(mins[1], maxs[1] - h) if extent[1] > h else mins[1]
    inside = (
        (pc[..., 0] >= x0) & (pc[..., 0] <= x0 + w)
        & (pc[..., 1] >= y0) & (pc[..., 1] <= y0 + h)
    )
    out = pc.copy()
    out[inside] = np.nan
    return out
