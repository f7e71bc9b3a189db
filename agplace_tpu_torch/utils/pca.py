"""PCA for descriptor dimensionality reduction (``agplace_tpu/utils/
pca.py``), in numpy: an SVD fit in float64, a matmul transform."""

from __future__ import annotations

from typing import Optional

import numpy as np


class PCA:
    def __init__(self, dim: int, whiten: bool = False):
        self.dim = dim
        self.whiten = whiten
        self.mean_: Optional[np.ndarray] = None
        self.components_: Optional[np.ndarray] = None
        self.scale_: Optional[np.ndarray] = None

    def fit(self, x: np.ndarray) -> "PCA":
        x = np.asarray(x, np.float64)
        if min(x.shape) < self.dim:
            # the SVD yields min(n, d) components: fewer would change
            # transform()'s output width
            raise ValueError(
                f"PCA dim {self.dim} needs a fit matrix with >= {self.dim} "
                f"rows and columns, got {x.shape}")
        self.mean_ = x.mean(axis=0)
        _, s, vt = np.linalg.svd(x - self.mean_, full_matrices=False)
        self.components_ = vt[:self.dim]
        n = max(x.shape[0] - 1, 1)
        var = (s[:self.dim] ** 2) / n
        self.scale_ = np.sqrt(np.maximum(var, 1e-12)) if self.whiten else None
        return self

    def transform(self, x: np.ndarray) -> np.ndarray:
        y = (np.asarray(x, np.float64) - self.mean_) @ self.components_.T
        if self.scale_ is not None:
            y = y / self.scale_
        return y.astype(np.float32)

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        return self.fit(x).transform(x)


def compute_pca(features: np.ndarray, pca_dim: int,
                num_samples: int = 2 ** 14, seed: int = 0) -> PCA:
    """Fit on up to ``num_samples`` rows drawn without replacement
    (``default_rng(seed).choice``)."""
    f = np.asarray(features)
    if len(f) > num_samples:
        idx = np.random.default_rng(seed).choice(len(f), num_samples,
                                                 replace=False)
        f = f[idx]
    return PCA(pca_dim).fit(f)


def reduce_pca(train_descs: np.ndarray, test_descs: np.ndarray,
               lower_dim: int, whiten: bool = True):
    """Fit on ``train_descs`` (whitened by default), transform both."""
    pca = PCA(lower_dim, whiten=whiten).fit(train_descs)
    return pca.transform(train_descs), pca.transform(test_descs)
