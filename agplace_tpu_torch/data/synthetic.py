"""Synthetic place-recognition dataset (``agplace_tpu/data/synthetic.py``):
the same arrays, bit for bit, from the same arguments.

Database tiles sit on a grid of UTM locations; each query lies near a tile,
and images and point clouds are seeded by the location quantised to the
tile grid (plus per-item noise), so a query and its tile share a content
signature.
"""

from __future__ import annotations

import numpy as np

from agplace_tpu_torch.data.base import PlaceDataset
from agplace_tpu_torch.retrieval.knn import radius_neighbors


class SyntheticDataset(PlaceDataset):
    def __init__(
        self,
        n_db: int = 64,
        n_q: int = 32,
        image_size: int = 64,
        nmap: int = 1,
        n_points: int = 256,
        grid_step: float = 30.0,
        seed: int = 0,
        val_thresh: float = 25.0,
        train_thresh: float = 10.0,
    ):
        rng = np.random.default_rng(seed)
        self.image_size = image_size
        self.nmap = nmap
        self.n_points = n_points
        self._seed = seed
        self._grid_step = grid_step

        # database on a grid, tiles ~grid_step apart
        side = int(np.ceil(np.sqrt(n_db)))
        xs, ys = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
        grid = np.stack([xs.ravel(), ys.ravel()], -1)[:n_db] * grid_step
        base = np.array([500000.0, 4000000.0])
        self.db_eastnorth = base + grid + rng.uniform(-2, 2, grid.shape)

        # queries: near a random tile (within train_thresh / 2)
        owners = rng.integers(0, n_db, size=n_q)
        self.q_eastnorth = (
            self.db_eastnorth[owners]
            + rng.uniform(-train_thresh / 2, train_thresh / 2, (n_q, 2)))
        self.database_num = n_db
        self.queries_num = n_q

        self.soft_positives_per_query = radius_neighbors(
            self.q_eastnorth, self.db_eastnorth, val_thresh)
        self.hard_positives_per_query = radius_neighbors(
            self.q_eastnorth, self.db_eastnorth, train_thresh)

    def _loc_rng(self, eastnorth: np.ndarray, salt: int
                 ) -> np.random.Generator:
        # quantised to the tile grid: a query and its tile share the seed
        key = (int(round(eastnorth[0] / self._grid_step)) * 1_000_003
               + int(round(eastnorth[1] / self._grid_step))
               + salt + self._seed)
        return np.random.default_rng(key % (2 ** 63))

    def _image_at(self, eastnorth, salt, noise_rng) -> np.ndarray:
        s = self.image_size
        r = self._loc_rng(eastnorth, salt)
        # low-frequency location signature + per-item noise
        freq = r.uniform(0.05, 0.3, size=(2, 3))
        phase = r.uniform(0, 2 * np.pi, size=(3,))
        yy, xx = np.mgrid[0:s, 0:s]
        img = np.stack([
            np.sin(freq[0, c] * xx + freq[1, c] * yy + phase[c])
            for c in range(3)
        ], -1).astype(np.float32)
        return img + 0.1 * noise_rng.standard_normal(img.shape).astype(
            np.float32)

    def load_query_image(self, idx: int) -> np.ndarray:
        noise = np.random.default_rng(idx)
        return self._image_at(self.q_eastnorth[idx], salt=1, noise_rng=noise)

    def load_query_points(self, idx: int) -> np.ndarray:
        r = self._loc_rng(self.q_eastnorth[idx], salt=2)
        n_real = self.n_points * 3 // 4
        pts = r.uniform(-60, 60, size=(n_real, 3)).astype(np.float32)
        pad = np.full((self.n_points - n_real, 3), np.nan, np.float32)
        return np.concatenate([pts, pad])

    def load_db_maps(self, idx: int) -> np.ndarray:
        noise = np.random.default_rng(10_000 + idx)
        return np.stack([
            self._image_at(self.db_eastnorth[idx], salt=1, noise_rng=noise)
            for _ in range(self.nmap)])
