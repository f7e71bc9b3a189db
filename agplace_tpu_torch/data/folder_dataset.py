"""DVGLB-style folder dataset (``agplace_tpu/data/folder_dataset.py``, the
pitts30k-format benchmark layout of the DVGLB lineage), on the port's
``data/base.py`` and ``data/transforms.py``:

    {root}/{name}/images/{split}/database/@utm_east@utm_north@...@.jpg
    {root}/{name}/images/{split}/queries/ ...

UTM coordinates are parsed from the '@'-separated filenames (fields 1, 2).
Training queries take the random query augmentations of the
``horizontal_flip`` / ``rand_perspective`` / ``random_resized_crop`` /
``random_rotation`` flags, drawn from one ``default_rng(cfg.train.seed)``
per dataset, as JAX's; ``PCADataset`` samples images for PCA fitting, and
``load_query_crops`` serves the crop-based test methods.  Items are
bit-equal to JAX's.
"""

from __future__ import annotations

import os
from glob import glob

import numpy as np

from agplace_tpu_torch.config import Config
from agplace_tpu_torch.data.base import PlaceDataset
from agplace_tpu_torch.data.transforms import (center_crop, five_crops,
                                               load_image_rgb, normalize,
                                               random_query_augment, resize)
from agplace_tpu_torch.retrieval.knn import radius_neighbors

_IMG_EXTS = (".jpg", ".jpeg", ".png")


def _parse_utm(path: str) -> np.ndarray:
    parts = os.path.basename(path).split("@")
    try:
        return np.array([float(parts[1]), float(parts[2])], np.float64)
    except (IndexError, ValueError):
        # name the offending file: a silent None would crash np.stack
        # during __init__ with an error far from the cause
        raise ValueError(
            f"cannot parse @utm_east@utm_north@ from image filename "
            f"{path!r} (expected e.g. '@584612.5@4477430.1@...')")


class FolderDataset(PlaceDataset):
    """Generic @utm@-named image-retrieval dataset (queries + database are
    both plain images; no LiDAR)."""

    def __init__(self, cfg: Config, root: str, split: str = "train",
                 imagenet_norm: bool = True):
        self.cfg = cfg
        base = os.path.join(root, "images", split)
        self.db_paths = sorted(
            p for ext in _IMG_EXTS
            for p in glob(os.path.join(base, "database", f"*{ext}")))
        self.q_paths = sorted(
            p for ext in _IMG_EXTS
            for p in glob(os.path.join(base, "queries", f"*{ext}")))
        self.db_eastnorth = np.stack(
            [_parse_utm(p) for p in self.db_paths]) if self.db_paths \
            else np.zeros((0, 2))
        self.q_eastnorth = np.stack(
            [_parse_utm(p) for p in self.q_paths]) if self.q_paths \
            else np.zeros((0, 2))
        self.database_num = len(self.db_paths)
        self.queries_num = len(self.q_paths)
        self.mean = (0.485, 0.456, 0.406) if imagenet_norm \
            else cfg.data.norm_mean
        self.std = (0.229, 0.224, 0.225) if imagenet_norm \
            else cfg.data.norm_std
        # the query augmentations: training queries only
        d = cfg.data
        self._augment = split == "train" and (
            d.horizontal_flip or d.rand_perspective > 0
            or d.random_resized_crop > 0 or d.random_rotation > 0)
        self._aug_rng = np.random.default_rng(cfg.train.seed)
        self.soft_positives_per_query = radius_neighbors(
            self.q_eastnorth, self.db_eastnorth,
            cfg.data.val_positive_dist_threshold)
        self.hard_positives_per_query = radius_neighbors(
            self.q_eastnorth, self.db_eastnorth,
            cfg.data.train_positives_dist_threshold)

    def _load(self, path: str, size: int, augment: bool = False
              ) -> np.ndarray:
        img = load_image_rgb(path)
        if augment:
            img = random_query_augment(img, self.cfg.data, self._aug_rng)
        img = resize(img, (size, size))
        return normalize(img, self.mean, self.std)

    def load_query_image(self, idx: int) -> np.ndarray:
        """Query transform per ``eval.test_method``: hard_resize = square
        resize; central_crop = biggest ratio-preserving central crop of
        q_resize; single_query = original resolution (ragged; evaluated
        at batch 1)."""
        method = self.cfg.eval.test_method
        path = self.q_paths[idx]
        if method == "single_query":
            return normalize(load_image_rgb(path), self.mean, self.std)
        if method == "central_crop":
            size = self.cfg.data.q_resize
            img = load_image_rgb(path)
            h, w = img.shape[:2]
            scale = max(size / h, size / w)
            img = resize(img, (max(size, round(h * scale)),
                               max(size, round(w * scale))))
            img = center_crop(img, size)
            return normalize(img, self.mean, self.std)
        return self._load(path, self.cfg.data.q_resize,
                          augment=self._augment)

    def load_query_crops(self, idx: int, crop: int) -> np.ndarray:
        """[5, crop, crop, 3] five-crops for the crop-based test methods
        (five_crops / nearest_crop / maj_voting)."""
        img = load_image_rgb(self.q_paths[idx])
        img = resize(img, int(crop * 1.2))
        return np.stack([
            normalize(c, self.mean, self.std) for c in five_crops(img, crop)
        ])

    def load_query_points(self, idx: int) -> np.ndarray:
        # image-only dataset: single NaN point (read_pc=False semantics)
        return np.full((self.cfg.data.vox_max_points, 3), np.nan, np.float32)

    def load_db_maps(self, idx: int) -> np.ndarray:
        return self._load(self.db_paths[idx],
                          self.cfg.data.db_resize)[None]


class PCADataset:
    """Random database + query images for PCA fitting."""

    def __init__(self, ds: FolderDataset, num_images: int = 2 ** 10,
                 seed: int = 0):
        rng = np.random.default_rng(seed)
        paths = list(ds.db_paths) + list(ds.q_paths)
        take = rng.choice(len(paths), size=min(num_images, len(paths)),
                          replace=False)
        self.paths = [paths[i] for i in take]
        self.ds = ds

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i: int) -> np.ndarray:
        return self.ds._load(self.paths[i], self.ds.cfg.data.q_resize)
