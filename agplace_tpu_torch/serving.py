"""Serving: a place-recognition index (``agplace_tpu/serving.py``), limited
to the fp32 single-device gallery.

    mm, db = build_towers(cfg, generator=g)      # on the card, or converted
    idx = PlaceIndex(cfg, (mm, db))
    idx.add_tiles(ds)                            # embed + index the gallery
    d, i = idx.search(images, points, k=5)       # (sq distances, indices)
    d, i, en = idx.locate(images, points, k=5)   # + the hits' UTM east/north

Requests are padded to ``infer_batch_size`` (embedding) and to power-of-two
query buckets (search), as the JAX index does.  The gallery is kept as a
host fp32 buffer plus a device-resident copy rebuilt only after a change.
``from_gallery`` builds a search-only index from a saved gallery, and
``from_checkpoint`` an index from a training checkpoint.  The int8,
sharded and audit paths and the HTTP front end are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from agplace_tpu_torch.config import Config
from agplace_tpu_torch.data.voxels import prepare_query_vox
from agplace_tpu_torch.device import resolve_device
from agplace_tpu_torch.embed import (batched_embed_db, drain, padded_batches,
                                     to_device)
from agplace_tpu_torch.infer import compute_dtype, make_infer_fns
from agplace_tpu_torch.retrieval.knn import l2_topk_blocked


class PlaceIndex:
    GALLERY_VERSION = 1

    def __init__(self, cfg: Config, towers=None, device=None):
        """``towers``: (MM, DBVanilla2D) from ``infer.build_towers``, or
        None for a search-only index.  ``device`` defaults to the towers'
        device, and for a search-only index to the card (``"cpu"`` keeps
        it on the CPU; without a card anything else raises)."""
        self.cfg = cfg
        if towers is None:
            self._embed_q = self._embed_db = None
            self.device = resolve_device(device)
        else:
            self._embed_q, self._embed_db = make_infer_fns(*towers)
            self.device = resolve_device(
                device or next(towers[0].parameters()).device)
        self._parts: list = []  # host fp32 [n_i, C]
        self._pos_parts: list = []  # [n_i, 2] UTM east/north, or None
        self._gallery: Optional[torch.Tensor] = None
        self._dirty = False
        self._n_rows = 0
        self.upload_count = 0  # host->device gallery builds

    @classmethod
    def from_checkpoint(cls, cfg: Config, save_dir: str, name: str,
                        device="cuda") -> "PlaceIndex":
        """An index over the towers of a training checkpoint (``ep@N__r1@R``
        / ``best_model`` in ``save_dir``, or a path), on ``device``: the
        card unless the caller passes ``"cpu"``."""
        from agplace_tpu_torch.infer import build_towers
        from agplace_tpu_torch.train.checkpoint import CheckpointManager

        towers = build_towers(cfg, device)
        saved = CheckpointManager(save_dir).read(
            name, next(towers[0].parameters()).device)
        for tower, key in zip(towers, ("mm", "db")):
            tower.load_state_dict(saved["state"][key], strict=True)
        return cls(cfg, towers, device)

    # -- gallery ------------------------------------------------------------
    def add_tiles(self, ds, indices: Optional[Sequence[int]] = None) -> int:
        """Embed aerial tiles of ``ds`` (any object with ``database_num``,
        ``load_db_maps(i) -> [NMAP, H, W, 3]`` and optionally
        ``db_eastnorth``) and append them.  Returns the gallery size."""
        if self._embed_db is None:
            raise RuntimeError("search-only index has no tower")
        idx = list(indices if indices is not None
                   else range(ds.database_num))
        feats = batched_embed_db(ds, idx, self._embed_db,
                                 self.cfg.train.infer_batch_size,
                                 self.device)
        pos = getattr(ds, "db_eastnorth", None)
        if pos is not None:
            pos = np.asarray(pos, np.float64)[idx]
        return self.add_descriptors(feats, positions=pos)

    def add_descriptors(self, feats: np.ndarray,
                        positions: Optional[np.ndarray] = None) -> int:
        """Append [n, C] descriptors (and optional [n, 2] positions)."""
        feats = np.asarray(feats, np.float32)
        if feats.ndim != 2:
            raise ValueError(f"descriptors must be [n, C], got {feats.shape}")
        if self._parts and feats.shape[1] != self.dim:
            raise ValueError(f"descriptor dim {feats.shape[1]} != "
                             f"gallery dim {self.dim}")
        if positions is not None:
            positions = np.asarray(positions, np.float64)
            if positions.shape != (feats.shape[0], 2):
                raise ValueError(
                    f"positions {positions.shape} != ({feats.shape[0]}, 2)")
        self._parts.append(feats)
        self._pos_parts.append(positions)
        self._n_rows += int(feats.shape[0])
        self._dirty = True
        return self._n_rows

    def remove_rows(self, indices) -> int:
        """Delete gallery rows by index.  The rows left keep their order and
        their indices shift down.  Returns the new size; the device copy
        is rebuilt on the next search."""
        indices = np.atleast_1d(np.asarray(indices, np.int64))
        if indices.size == 0:
            return self._n_rows
        if indices.min() < 0 or indices.max() >= self._n_rows:
            raise IndexError(f"row index out of range [0, {self._n_rows})")
        keep = np.ones(self._n_rows, bool)
        keep[indices] = False
        host, pos = self._host_gallery(), self.positions
        self._parts = [host[keep]]
        self._pos_parts = [pos[keep] if pos is not None else None]
        self._n_rows = int(keep.sum())
        self._dirty = True
        return self._n_rows

    @property
    def positions(self) -> Optional[np.ndarray]:
        if not self._pos_parts or any(p is None for p in self._pos_parts):
            return None
        if len(self._pos_parts) > 1:
            self._pos_parts = [np.concatenate(self._pos_parts)]
        return self._pos_parts[0]

    def _host_gallery(self) -> np.ndarray:
        if not self._parts:
            raise RuntimeError("empty index: add tiles first")
        if len(self._parts) > 1:
            self._parts = [np.concatenate(self._parts)]
        return self._parts[0]

    def _device_gallery(self) -> torch.Tensor:
        if self._dirty or self._gallery is None:
            self._gallery = torch.from_numpy(self._host_gallery()).to(
                self.device)
            self.upload_count += 1
            self._dirty = False
        return self._gallery

    def __len__(self) -> int:
        return self._n_rows

    @property
    def dim(self) -> Optional[int]:
        return int(self._parts[0].shape[1]) if self._parts else None

    # -- persistence ---------------------------------------------------------
    def save_gallery(self, path: str) -> None:
        """Persist descriptors (+ positions) to an ``.npz`` — the same file
        format as the JAX index, so either package can load it."""
        arrays = {"feats": self._host_gallery(),
                  "version": np.int64(self.GALLERY_VERSION)}
        pos = self.positions
        if pos is not None:
            arrays["positions"] = pos
        np.savez_compressed(path, **arrays)

    def load_gallery(self, path: str) -> int:
        with np.load(path) as z:
            v = int(z["version"])
            if v > self.GALLERY_VERSION:
                raise ValueError(f"gallery file version {v} is newer than "
                                 f"this build ({self.GALLERY_VERSION})")
            feats = z["feats"]
            pos = z["positions"] if "positions" in z.files else None
        if not np.isfinite(feats).all():
            raise ValueError(f"gallery {path!r} contains non-finite "
                             f"descriptors")
        return self.add_descriptors(feats, positions=pos)

    @classmethod
    def from_gallery(cls, path: str, cfg: Optional[Config] = None,
                     device=None) -> "PlaceIndex":
        """Search-only index over a gallery saved by ``save_gallery``:
        ``search_descriptors`` / ``locate_descriptors`` only."""
        idx = cls(cfg, None, device)
        idx.load_gallery(path)
        return idx

    # -- queries ------------------------------------------------------------
    def embed(self, images: np.ndarray,
              points: Optional[np.ndarray] = None) -> np.ndarray:
        """[B, H, W, 3] images (+ optional [B, P, 3] NaN-padded clouds) ->
        [B, C] descriptors; requests are padded to ``infer_batch_size``
        (``embed.padded_batches``) and fetched once."""
        if self._embed_q is None:
            raise RuntimeError("search-only index has no tower")
        bs = self.cfg.train.infer_batch_size
        images = np.asarray(images, np.float32)
        n = images.shape[0]
        if n == 0:
            return np.zeros((0, self.cfg.model.features_dim), np.float32)
        points = (np.full((n, 1, 3), np.nan, np.float32) if points is None
                  else np.asarray(points, np.float32))
        if len(points) != n:
            raise ValueError(f"{len(points)} point clouds for {n} images")
        parts, keeps = [], []
        for chunk, keep in padded_batches(range(n), bs):
            vox = prepare_query_vox(self.cfg, points[chunk], self.device,
                                    compute_dtype(self.cfg))
            parts.append(self._embed_q(to_device(images[chunk], self.device),
                                       vox))
            keeps.append(keep)
        return drain(parts, keeps)

    def search(self, images: np.ndarray, points: Optional[np.ndarray] = None,
               k: int = 5) -> Tuple[np.ndarray, np.ndarray]:
        """Embed queries and return (sq_distances [B, k], indices [B, k])."""
        if self._n_rows == 0:
            raise RuntimeError("empty index: add tiles first")
        return self.search_descriptors(self.embed(images, points), k)

    def locate(self, images: np.ndarray, points: Optional[np.ndarray] = None,
               k: int = 5) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``search`` plus the [B, k, 2] UTM east/north of the hits (NaN
        for -1 padding); every gallery part needs positions."""
        d, i = self.search(images, points, k)
        return d, i, self._positions_of(i)

    def locate_descriptors(self, q_feats: np.ndarray, k: int = 5
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        d, i = self.search_descriptors(q_feats, k)
        return d, i, self._positions_of(i)

    def _positions_of(self, i: np.ndarray) -> np.ndarray:
        pos = self.positions
        if pos is None:
            raise RuntimeError("gallery has rows without positions")
        return np.where((i >= 0)[..., None], pos[np.clip(i, 0, None)],
                        np.nan)

    @staticmethod
    def _pow2(n: int, lo: int = 1) -> int:
        return max(lo, 1 << (max(n, 1) - 1).bit_length())

    def search_descriptors(self, q_feats: np.ndarray, k: int
                           ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact top-k of [Q, C] descriptors.  The query count is bucketed
        to a power of two (min 8, padded with the last row) and k to a
        power of two, then sliced, as the JAX index does."""
        q = np.asarray(q_feats, np.float32)
        nq = q.shape[0]
        if nq == 0:
            return (np.zeros((0, k), np.float32), np.zeros((0, k), np.int64))
        bq = self._pow2(nq, lo=8)
        if bq != nq:
            q = np.concatenate([q, np.repeat(q[-1:], bq - nq, 0)])
        d, i = l2_topk_blocked(q, self._device_gallery(), self._pow2(k))
        return d[:nq, :k], i[:nq, :k]
