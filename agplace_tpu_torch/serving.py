"""Serving: a place-recognition index (``agplace_tpu/serving.py``).

    mm, db = build_towers(cfg, generator=g)      # on the card, or converted
    idx = PlaceIndex(cfg, (mm, db))              # quant="int8", audit_rate
    idx.add_tiles(ds)                            # embed + index the gallery
    d, i = idx.search(images, points, k=5)       # (sq distances, indices)
    d, i, en = idx.locate(images, points, k=5)   # + the hits' UTM east/north

Requests are padded to ``infer_batch_size`` (embedding) and to power-of-two
query buckets (search), as the JAX index does.  The gallery is kept as a
host fp32 buffer plus a device-resident copy rebuilt only after a change:
fp32 rows, or with ``quant="int8"`` per-row int8 rows (4x less device
memory) whose candidates are re-ranked exactly on the host copy, with an
optional every-Nth-call audit against an exact host search.
``from_gallery`` builds a search-only index from a saved gallery, and
``from_checkpoint`` an index from a training checkpoint; ``serving_http``
puts an index behind a JSON API.

``gallery_mesh`` (``parallel/mesh.py``, a program of one process per
card): the device gallery is split over the mesh's ``gallery`` ranks,
fp32 (``retrieval/sharded.sharded_l2_topk``) or int8
(``sharded_l2_candidates_int8``, then the same exact host re-rank), and
every rank of the gallery group calls ``add_tiles`` / ``search`` with the
same requests.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from agplace_tpu_torch.config import Config
from agplace_tpu_torch.data.voxels import prepare_query_vox
from agplace_tpu_torch.device import resolve_device
from agplace_tpu_torch.embed import (batched_embed_db, drain, padded_batches,
                                     to_device)
from agplace_tpu_torch.infer import compute_dtype, make_infer_fns
from agplace_tpu_torch.models.factory import tower_width
from agplace_tpu_torch.parallel.mesh import mesh_axis
from agplace_tpu_torch.retrieval.knn import (l2_candidates_int8,
                                             l2_topk_blocked, quantize_rows)
from agplace_tpu_torch.retrieval.sharded import (shard_gallery,
                                                 shard_quant_gallery,
                                                 sharded_l2_candidates_int8,
                                                 sharded_l2_topk)


class PlaceIndex:
    GALLERY_VERSION = 1

    def __init__(self, cfg: Config, towers=None, device=None,
                 quant: Optional[str] = None, audit_rate: float = 0.0,
                 gallery_mesh=None):
        """``towers``: (query tower, aerial tower or None under
        ``share_qdb``) from ``infer.build_towers``, or None for a
        search-only index.  ``device`` defaults to the towers'
        device, and for a search-only index to the card (``"cpu"`` keeps
        it on the CPU; without a card anything else raises).

        ``quant="int8"``: the device gallery holds per-row int8 rows; a
        search takes 4x oversampled candidates from them on the device and
        re-ranks those exactly in fp32 on the host copy, so it returns the
        fp32 path's (distance, index) pairs whenever the true top-k
        survives the candidate scan.  ``audit_rate`` in [0, 1] (int8 only):
        every ``round(1 / audit_rate)``-th search is checked against an
        exact host top-k, and candidate misses are counted in
        ``audit_stats`` and logged.  ``gallery_mesh``: the device gallery
        split over the mesh's ``gallery`` ranks (module docstring)."""
        if quant not in (None, "int8"):
            raise ValueError(f"unsupported quant mode {quant!r}")
        if not 0.0 <= audit_rate <= 1.0:
            raise ValueError(f"audit_rate must be in [0, 1]: {audit_rate}")
        self.quant = quant
        self.gallery_mesh = gallery_mesh
        self.audit_rate = audit_rate
        self.audit_stats = {"searches": 0, "audited": 0,
                            "miss_queries": 0, "missed_rows": 0}
        self.cfg = cfg
        # the descriptor width of an empty request: the towers' where they
        # know it (GeoLoc, MinkLoc), else features_dim (the MM's), as JAX
        self._width = None if cfg is None else cfg.model.features_dim
        if towers is None:
            self._embed_q = self._embed_db = None
            self.device = resolve_device(device)
        else:
            self._width = tower_width(towers[0]) or self._width
            self._embed_q, self._embed_db = make_infer_fns(*towers)
            self.device = resolve_device(
                device or next(towers[0].parameters()).device)
        self._parts: list = []  # host fp32 [n_i, C]
        self._pos_parts: list = []  # [n_i, 2] UTM east/north, or None
        self._gallery: Optional[torch.Tensor] = None
        # (int8 rows, scales, exact sq norms), rows padded to a multiple of 8
        self._quant_gallery: Optional[Tuple[torch.Tensor, ...]] = None
        self._dirty = False
        self._n_rows = 0
        self.upload_count = 0  # host->device gallery builds

    @classmethod
    def from_checkpoint(cls, cfg: Config, save_dir: str, name: str,
                        device="cuda", quant: Optional[str] = None,
                        audit_rate: float = 0.0,
                        gallery_mesh=None) -> "PlaceIndex":
        """An index over the towers of a training checkpoint (``ep@N__r1@R``
        / ``best_model`` in ``save_dir``, or a path), on ``device``: the
        card unless the caller passes ``"cpu"``."""
        from agplace_tpu_torch.train.checkpoint import load_towers

        towers, _ = load_towers(cfg, save_dir, name, device)
        return cls(cfg, towers, device, quant=quant, audit_rate=audit_rate,
                   gallery_mesh=gallery_mesh)

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

    def _sharded(self) -> bool:
        return mesh_axis(self.gallery_mesh, "gallery") is not None

    def _device_gallery(self) -> torch.Tensor:
        """The device gallery (this rank's block when sharded), rebuilt
        only after a change."""
        if self._dirty or self._gallery is None:
            host = self._host_gallery()
            self._gallery = (
                shard_gallery(self.gallery_mesh, host, device=self.device)
                if self._sharded() else torch.from_numpy(host).to(
                    self.device))
            self._quant_gallery = None
            self.upload_count += 1
            self._dirty = False
        return self._gallery

    def _device_gallery_int8(self) -> Tuple[torch.Tensor, ...]:
        """(int8 rows [N8, C8], scales [N8], exact sq norms [N8]) on the
        device, built like the fp32 copy (which it drops).  Rows and
        columns are zero-padded to multiples of 8 for the card's int8 GEMM
        (``knn.int8_cross``); a padded row has scale 0 and norm +inf."""
        if self._dirty or self._quant_gallery is None:
            if self._sharded():
                self._quant_gallery = shard_quant_gallery(
                    self.gallery_mesh, self._host_gallery(),
                    device=self.device)
            else:
                q, scale, sq = quantize_rows(self._host_gallery())
                n, c = q.shape
                q = np.pad(q, ((0, -n % 8), (0, -c % 8)))
                scale = np.pad(scale[:, 0], (0, -n % 8))
                sq = np.pad(sq, (0, -n % 8), constant_values=np.inf)
                self._quant_gallery = tuple(
                    torch.from_numpy(a).to(self.device)
                    for a in (q, scale, sq))
            self._gallery = None
            self.upload_count += 1
            self._dirty = False
        return self._quant_gallery

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
                     device=None, quant: Optional[str] = None,
                     audit_rate: float = 0.0,
                     gallery_mesh=None) -> "PlaceIndex":
        """Search-only index over a gallery saved by ``save_gallery``:
        ``search_descriptors`` / ``locate_descriptors`` only."""
        idx = cls(cfg, None, device, quant=quant, audit_rate=audit_rate,
                  gallery_mesh=gallery_mesh)
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
            return np.zeros((0, self._width), np.float32)
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
        """Top-k of [Q, C] descriptors: (sq distances [Q, k] fp32, indices
        [Q, k] int64), faiss's +inf / -1 padding for k > rows.  The query
        count is bucketed to a power of two (min 8, padded with the last
        row) and the device's k to a power of two, then sliced, as the JAX
        index does."""
        q = np.asarray(q_feats, np.float32)
        nq = q.shape[0]
        if nq == 0:
            return (np.zeros((0, k), np.float32), np.zeros((0, k), np.int64))
        bq = self._pow2(nq, lo=8)
        if bq != nq:
            q = np.concatenate([q, np.repeat(q[-1:], bq - nq, 0)])
        d, i = self._search_impl(q, k)
        d, i = d[:nq], i[:nq]
        if self.quant == "int8" and self.audit_rate > 0.0:
            self.audit_stats["searches"] += 1
            stride = max(1, int(round(1.0 / self.audit_rate)))
            if (self.audit_stats["searches"] - 1) % stride == 0:
                self._audit_int8(q[:nq], k, d, i)
        return d, i

    def _search_impl(self, q: np.ndarray, k: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        if self.quant == "int8":
            return self._search_int8(q, k)
        if self._sharded() and k <= self._n_rows:
            d, i = sharded_l2_topk(
                self.gallery_mesh, torch.from_numpy(q).to(self.device),
                self._device_gallery(), min(self._pow2(k), self._n_rows),
                n_rows=self._n_rows)
            return d.cpu().numpy()[:, :k], i.cpu().numpy()[:, :k]
        if self._sharded():  # k > rows: a tiny gallery, the blocked path
            db = torch.from_numpy(self._host_gallery()).to(self.device)
        else:
            db = self._device_gallery()
        d, i = l2_topk_blocked(q, db, self._pow2(k))
        return d[:, :k], i[:, :k]

    def _audit_int8(self, q: np.ndarray, k: int, d_int8: np.ndarray,
                    i_int8: np.ndarray) -> None:
        """Exact host fp32 full-gallery top-k of this search's queries;
        counts the ranks where the exact distance beats the int8 path's (a
        candidate the scan dropped, which the re-rank cannot recover).
        Distances are compared, not indices: equal-distance ties with
        other indices are not misses."""
        host = self._host_gallery()
        kk = min(k, self._n_rows)
        d2 = (np.einsum("qc,qc->q", q, q)[:, None]
              + np.einsum("nc,nc->n", host, host)[None]
              - 2.0 * q @ host.T)
        d_exact = np.sort(np.maximum(d2, 0.0), axis=1)[:, :kk]
        miss = d_exact < d_int8[:, :kk] - 1e-4  # [Q, kk]
        self.audit_stats["audited"] += 1
        n_rows = int(miss.sum())
        n_q = int(miss.any(axis=1).sum())
        self.audit_stats["missed_rows"] += n_rows
        self.audit_stats["miss_queries"] += n_q
        if n_rows:
            logging.warning(
                "int8 audit: %d/%d queries missed %d true top-%d rows "
                "(exact d2 beat the int8 result; raise the candidate "
                "oversampling if this recurs)", n_q, q.shape[0], n_rows, kk)

    def _search_int8(self, q: np.ndarray, k: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """int8 candidate scan on the device, then the exact fp32 re-rank
        of the candidates on the host copy (a stable sort), with faiss's
        +inf / -1 padding for k > rows."""
        kk = min(k, self._n_rows)
        # 4x oversampling (min 16) absorbs the cross term's rounding
        nc = min(self._pow2(4 * kk, lo=16), self._n_rows)
        qt = torch.from_numpy(q).to(self.device)
        if self._sharded():
            _, cand = sharded_l2_candidates_int8(
                self.gallery_mesh, qt, self._device_gallery_int8(), nc)
        else:
            _, cand = l2_candidates_int8(qt, *self._device_gallery_int8(),
                                         nc)
        cand = cand.cpu().numpy()  # [Q, nc]
        host = self._host_gallery()
        # a sharded gallery's padding rows come after the real ones; one
        # is a candidate only when a shard holds fewer real rows than its
        # local top-nc: out of the re-rank
        valid = cand < self._n_rows
        rows = host[np.where(valid, cand, 0)]  # [Q, nc, C] re-rank set
        d2 = np.maximum(
            np.einsum("qc,qc->q", q, q)[:, None]
            + np.einsum("qnc,qnc->qn", rows, rows)
            - 2.0 * np.einsum("qc,qnc->qn", q, rows), 0.0)
        d2 = np.where(valid, d2, np.inf)
        order = np.argsort(d2, axis=1, kind="stable")[:, :kk]
        d = np.take_along_axis(d2, order, axis=1).astype(np.float32)
        i = np.take_along_axis(cand, order, axis=1).astype(np.int64)
        i = np.where(np.isinf(d), -1, i)
        if kk < k:
            d = np.concatenate(
                [d, np.full((q.shape[0], k - kk), np.inf, np.float32)], 1)
            i = np.concatenate(
                [i, np.full((q.shape[0], k - kk), -1, np.int64)], 1)
        return d, i
