"""Hard-negative mining (``agplace_tpu/train/mining.py``).

Every ``cache_refresh_rate`` queries the miner embeds a sample of the
database and the queries with the current towers, in eval mode under
``torch.inference_mode()`` (the embed passes of ``embed.py``), then picks
for each query its best positive and its hardest negatives.  JAX builds a
second, eval-mode model for these passes; the port switches its one pair
of towers to eval here, and the train step switches them back.

Modes: ``random``; ``partial_sep`` (and ``partial`` / ``msls_weighted``,
which JAX routes to it): a sampled negative pool, the selection
(``select_triplets``) on the device; ``full``: the whole database embedded,
the negatives from a fresh pool unioned with each query's cache of earlier
hard negatives; ``full_gallery``: the hardest negatives over the whole
gallery (one device).  Equal distances go lowest index first, as
``lax.top_k`` and ``argmin`` order them (``retrieval/knn.py``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from agplace_tpu_torch.config import Config
from agplace_tpu_torch.data.base import PlaceDataset, pad_positives
from agplace_tpu_torch.device import resolve_device
from agplace_tpu_torch.embed import batched_embed_db, batched_embed_q
from agplace_tpu_torch.infer import make_infer_fns
from agplace_tpu_torch.retrieval.knn import (_ascending_topk,
                                             l2_topk_blocked, pairwise_sq_l2)

_BIG = 1e30


def best_positive(pos_d: torch.Tensor, pos_idx: torch.Tensor
                  ) -> torch.Tensor:
    """Each row's entry of ``pos_idx`` [nq, P] (-1 pads) at its least
    distance in ``pos_d`` [nq, P]: the first of equal minima, as
    ``argmin``."""
    pos_d = torch.where(pos_idx >= 0, pos_d, _BIG)
    slot = torch.argmin(pos_d, dim=1)
    return torch.gather(pos_idx, 1, slot[:, None])[:, 0]


def select_triplets(q_feats: torch.Tensor, db_feats: torch.Tensor,
                    pos_idx: torch.Tensor, neg_idx: torch.Tensor,
                    neg_forbidden: torch.Tensor, n_hard: int = 10):
    """(best positive slot [nq], hardest negative slots [nq, n_hard], which
    of those are forbidden [nq, n_hard]).  ``pos_idx`` [nq, P] holds
    positions into ``db_feats`` (-1 pads), ``neg_idx`` [nq, S] the
    negative pool, ``neg_forbidden`` [nq, S] its soft positives.  A
    forbidden slot wins only when the pool holds fewer than ``n_hard``
    allowed rows; the caller repairs those."""
    d2 = pairwise_sq_l2(q_feats, db_feats)
    best_pos = best_positive(torch.gather(d2, 1, pos_idx.clamp(min=0)),
                             pos_idx)
    neg_d = torch.gather(d2, 1, neg_idx)
    neg_d = torch.where(neg_forbidden, _BIG, neg_d)
    _, hard_slots = _ascending_topk(neg_d, n_hard)
    return (best_pos, torch.gather(neg_idx, 1, hard_slots),
            torch.gather(neg_forbidden, 1, hard_slots))


class TripletMiner:
    """Produces global-index triplets [nq, 2+nneg] (query, positive,
    negatives) for ``collate_train``."""

    def __init__(self, cfg: Config, ds: PlaceDataset, device="cuda"):
        """``device``: where the embed passes and the selection run, the
        card unless the caller passes ``"cpu"``."""
        self.cfg = cfg
        self.ds = ds
        self.device = resolve_device(device)
        self.nneg = cfg.train.negs_num_per_query
        self.neg_pool = min(cfg.train.neg_samples_num, ds.database_num)
        # queries with no hard positive are dropped up front
        self.valid_queries = np.array([
            i for i in range(ds.queries_num)
            if len(ds.hard_positives_per_query[i]) > 0])
        # `full`: each query's persistent hardest-negative memory
        self.neg_cache = [np.empty((0,), np.int64)
                          for _ in range(ds.queries_num)]

    def _embed(self, towers, db_ids, q_ids) -> Tuple[np.ndarray,
                                                      np.ndarray]:
        """(db descriptors, query descriptors) with the towers in eval
        mode: the database first, then the queries, as JAX does."""
        for t in towers:
            t.eval()
        embed_q, embed_db = make_infer_fns(*towers)
        bs = self.cfg.train.infer_batch_size
        db = batched_embed_db(self.ds, db_ids, embed_db, bs, self.device)
        q = batched_embed_q(self.ds, q_ids, embed_q, bs, self.cfg,
                            self.device)
        return db, q

    def _best_positive(self, q_feats: np.ndarray, db_feats: np.ndarray,
                       pos_idx: np.ndarray) -> np.ndarray:
        """``best_positive`` over distances taken as direct differences
        of the descriptors (JAX's random and full modes), on the
        device."""
        dev = self.device
        q = torch.as_tensor(q_feats, device=dev)
        idx = torch.as_tensor(pos_idx, device=dev)
        pos = torch.as_tensor(db_feats, device=dev)[idx.clamp(min=0)]
        pos_d = ((q[:, None, :] - pos) ** 2).sum(dim=-1)
        return best_positive(pos_d, idx).cpu().numpy()

    def mine_random(self, rng: np.random.Generator, n_queries: int,
                    towers=None) -> np.ndarray:
        """The best positive among each query's hard positives (by the
        towers' descriptors; uniform at random without towers), and
        negatives drawn without replacement minus the soft positives."""
        ds = self.ds
        qs = rng.choice(self.valid_queries, size=n_queries,
                        replace=n_queries > len(self.valid_queries))
        if towers is not None:
            all_pos = np.unique(np.concatenate(
                [ds.hard_positives_per_query[q] for q in qs]))
            slot_of = {int(g): i for i, g in enumerate(all_pos)}
            db_feats, q_feats = self._embed(towers, all_pos, qs)
            pos_idx, _ = pad_positives([
                np.array([slot_of[int(g)]
                          for g in ds.hard_positives_per_query[q]])
                for q in qs])
            best_pos = all_pos[self._best_positive(q_feats, db_feats,
                                                   pos_idx)]
        rows = []
        for r, q in enumerate(qs):
            if towers is not None:
                pos = int(best_pos[r])
            else:
                pos = int(rng.choice(ds.hard_positives_per_query[q]))
            soft = ds.soft_positives_per_query[q]
            n_draw = min(ds.database_num, self.nneg + len(soft))
            cand = rng.choice(ds.database_num, size=n_draw, replace=False)
            negs = np.setdiff1d(cand, soft, assume_unique=True)[:self.nneg]
            if len(negs) < self.nneg:  # tiny gallery: repeat the last
                if len(negs) == 0:
                    # every row is a soft positive: any row but the
                    # positive (a (q, pos, pos) triplet has no gradient)
                    others = np.delete(np.arange(ds.database_num), pos)
                    negs = (rng.choice(others, size=1) if len(others)
                            else np.array([pos]))
                negs = np.concatenate(
                    [negs, np.full(self.nneg - len(negs), negs[-1],
                                   negs.dtype)])
            rows.append([q, pos] + [int(n) for n in negs])
        return np.asarray(rows, np.int64)

    def mine_partial_sep(self, rng: np.random.Generator, n_queries: int,
                         towers) -> np.ndarray:
        ds = self.ds
        qs = rng.choice(self.valid_queries, size=n_queries,
                        replace=n_queries > len(self.valid_queries))
        sampled_negs = rng.choice(ds.database_num, size=self.neg_pool,
                                  replace=False)
        all_pos = np.unique(np.concatenate(
            [ds.hard_positives_per_query[q] for q in qs]))
        cache_ids = np.unique(np.concatenate([sampled_negs, all_pos]))
        slot_of = {int(g): i for i, g in enumerate(cache_ids)}
        db_feats, q_feats = self._embed(towers, cache_ids, qs)

        pos_idx, _ = pad_positives([
            np.array([slot_of[int(g)] for g in ds.hard_positives_per_query[q]])
            for q in qs])
        neg_idx = np.broadcast_to(
            np.array([slot_of[int(g)] for g in sampled_negs]),
            (len(qs), len(sampled_negs)))
        forbidden = np.stack([
            np.isin(sampled_negs, ds.soft_positives_per_query[q]) for q in qs])
        dev = self.device
        best, hard, bad = select_triplets(
            torch.as_tensor(q_feats, device=dev),
            torch.as_tensor(db_feats, device=dev),
            torch.as_tensor(pos_idx, device=dev),
            torch.as_tensor(np.ascontiguousarray(neg_idx), device=dev),
            torch.as_tensor(forbidden, device=dev), self.nneg)
        best_pos = cache_ids[best.cpu().numpy()]
        hard_negs = cache_ids[hard.cpu().numpy()]
        bad = bad.cpu().numpy()
        # a query whose soft positives cover more than S - nneg of the
        # pool got forbidden slots: replace them with random non-soft rows
        for r in np.nonzero(bad.any(axis=1))[0]:
            soft = ds.soft_positives_per_query[int(qs[r])]
            keep = hard_negs[r][~bad[r]]
            pool = np.setdiff1d(
                np.setdiff1d(np.arange(ds.database_num), soft), keep)
            slots = np.nonzero(bad[r])[0]
            if len(pool):
                fill = rng.choice(pool, size=len(slots),
                                  replace=len(pool) < len(slots))
            else:  # every row is soft: least bad, avoid the positive
                others = np.delete(np.arange(ds.database_num),
                                   int(best_pos[r]))
                fill = (rng.choice(others, size=len(slots)) if len(others)
                        else np.full(len(slots), best_pos[r]))
            hard_negs[r, slots] = fill
        return np.concatenate([qs[:, None], best_pos[:, None], hard_negs],
                              axis=1)

    def mine_full(self, rng: np.random.Generator, n_queries: int, towers,
                  whole_gallery: bool = False) -> np.ndarray:
        """The whole database embedded; the best positive per query; the
        hardest negatives within a fresh ``neg_samples_num`` draw minus
        the soft positives, unioned with the query's cache of earlier
        rounds (refreshed with the picks).  ``whole_gallery``
        (``full_gallery``): the hardest negatives over the whole gallery,
        searched nneg + max |soft positives| deep."""
        ds = self.ds
        qs = rng.choice(self.valid_queries, size=n_queries,
                        replace=n_queries > len(self.valid_queries))
        db_feats, q_feats = self._embed(
            towers, list(range(ds.database_num)), qs)
        pos_idx, _ = pad_positives(
            [np.asarray(ds.hard_positives_per_query[q]) for q in qs])
        best_pos = self._best_positive(q_feats, db_feats, pos_idx)
        rows = np.empty((len(qs), 2 + self.nneg), np.int64)
        rows[:, 0], rows[:, 1] = qs, best_pos
        if not whole_gallery:
            for r, q in enumerate(qs):
                draw = rng.choice(ds.database_num,
                                  size=min(ds.database_num, self.neg_pool),
                                  replace=False)
                cand = np.setdiff1d(draw, ds.soft_positives_per_query[q],
                                    assume_unique=True)
                cand = np.unique(np.concatenate(
                    [self.neg_cache[q], cand])).astype(np.int64)
                d = np.sum((db_feats[cand] - q_feats[r]) ** 2, axis=1)
                negs = cand[np.argsort(d, kind="stable")[:self.nneg]]
                self.neg_cache[q] = negs
                if len(negs) < self.nneg:  # pool emptied by the filter
                    filler = negs[-1] if len(negs) else int(best_pos[r])
                    negs = np.concatenate([negs, np.full(
                        self.nneg - len(negs), filler, np.int64)])
                rows[r, 2:] = negs
            return rows
        max_soft = max(len(ds.soft_positives_per_query[q]) for q in qs)
        k = min(ds.database_num, self.nneg + max_soft)
        _, cand = l2_topk_blocked(
            q_feats, torch.as_tensor(db_feats, device=self.device), k)
        for r, q in enumerate(qs):
            soft = set(ds.soft_positives_per_query[q].tolist())
            negs = [int(c) for c in cand[r] if int(c) not in soft]
            if len(negs) < self.nneg:  # tiny gallery (k capped): repeat
                filler = negs[-1] if negs else int(best_pos[r])
                negs += [filler] * (self.nneg - len(negs))
            rows[r, 2:] = negs[:self.nneg]
        return rows

    def mine(self, rng: np.random.Generator, n_queries: int,
             towers=None) -> np.ndarray:
        """Triplets by ``cfg.train.mining``; ``random`` without towers."""
        mining = self.cfg.train.mining
        if mining == "random" or towers is None:
            return self.mine_random(rng, n_queries, towers)
        if mining in ("full", "full_gallery"):
            return self.mine_full(rng, n_queries, towers,
                                  whole_gallery=mining == "full_gallery")
        if mining in ("partial_sep", "partial", "msls_weighted"):
            # with two distinct towers partial's selection is partial_sep's
            return self.mine_partial_sep(rng, n_queries, towers)
        raise NotImplementedError(mining)
