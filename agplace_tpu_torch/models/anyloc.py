"""AnyLoc / DINO toolkit (``agplace_tpu/models/anyloc.py``): ViT feature
extractors with facet taps (query / key / value / token, or the heads'
mean attention, at any layer) and a VLAD aggregator over their patch
descriptors, its vocabulary fitted with the port's k-means
(``retrieval/kmeans.py``).

The modules carry flax's scope names (``patch_embed``, ``q_3``,
``attn_2/query`` ...), so ``utils/convert.load_jax_variables`` loads a
JAX tree into them leaf for leaf.  flax's semantics are kept: LayerNorm
eps 1e-6 (``ViTExtractor``; HF's 1e-12 in ``CosPlaceViTExtractFeatures``),
the tanh GELU, fp32 throughout, and ``jax.image.resize``'s weights for
the positional-embedding resizes (``utils/image_resize.py``: bilinear,
antialiased when it shrinks; Keys' cubic with a = -0.5).  An extractor
stops after its tap's layer: the blocks after it change no output.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from agplace_tpu_torch.device import resolve_device
from agplace_tpu_torch.models.geoloc import ProjectHeads
from agplace_tpu_torch.models.layers import Conv2d, Dense, LayerNorm, gelu
from agplace_tpu_torch.retrieval.kmeans import kmeans
from agplace_tpu_torch.retrieval.knn import ip_topk, l2_topk
from agplace_tpu_torch.retrieval.recall import compute_recalls
from agplace_tpu_torch.utils.image_resize import resize_hw

_VIT_FACETS = ("query", "key", "value", "token", "attn")


class ViTExtractor(nn.Module):
    """DINO-style ViT patch features: the ``facet`` of block ``layer``
    (a layer past ``depth`` gives the final tokens), CLS dropped:
        token -> the block's output tokens                [B, N, D]
        query / key / value -> that projection, heads concatenated [B, N, D]
        attn -> the heads' mean attention, CLS kept      [B, 1+N, 1+N]
    ``stride`` < ``patch`` is the stride-patching trick: a denser grid
    from the same weights, the positional embedding (sized for 224 px)
    bilinearly resized to it."""

    def __init__(self, hidden: int = 384, depth: int = 12, heads: int = 6,
                 patch: int = 16, stride: int = 16, layer: int = 11,
                 facet: str = "token"):
        super().__init__()
        if facet not in _VIT_FACETS:
            raise ValueError(f"facet {facet!r} not in {_VIT_FACETS}")
        self.hidden, self.depth, self.heads = hidden, depth, heads
        self.layer, self.facet = layer, facet
        self.native = 224 // patch
        self.patch_embed = Conv2d(3, hidden, patch, stride, 0, True, None)
        self.cls = nn.Parameter(torch.zeros(1, 1, hidden))
        self.pos = nn.Parameter(torch.empty(1, self.native ** 2 + 1, hidden))
        self.init_std = {"cls": 0.0, "pos": 0.02}
        for i in range(depth):
            setattr(self, f"ln1_{i}", LayerNorm(hidden, 1e-6))
            for name in ("q", "k", "v", "proj"):
                setattr(self, f"{name}_{i}", Dense(hidden, hidden))
            setattr(self, f"ln2_{i}", LayerNorm(hidden, 1e-6))
            setattr(self, f"mlp1_{i}", Dense(hidden, 4 * hidden))
            setattr(self, f"mlp2_{i}", Dense(4 * hidden, hidden))

    def _pos(self, gh: int, gw: int) -> torch.Tensor:
        pos = self.pos
        if (gh, gw) == (self.native, self.native):
            return pos
        grid = pos[:, 1:].reshape(1, self.native, self.native, self.hidden)
        grid = resize_hw(grid, (gh, gw), "bilinear")
        return torch.cat([pos[:, :1], grid.reshape(1, gh * gw, -1)], dim=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, H, W, 3]
        b = x.shape[0]
        x = self.patch_embed(x.float())
        gh, gw = x.shape[1], x.shape[2]
        x = x.reshape(b, gh * gw, self.hidden)
        x = torch.cat([self.cls.expand(b, -1, -1), x], dim=1)
        x = x + self._pos(gh, gw)
        d_head = self.hidden // self.heads
        out = None
        for i in range(min(self.layer + 1, self.depth)):
            y = getattr(self, f"ln1_{i}")(x)
            q, k, v = (getattr(self, f"{n}_{i}")(y) for n in "qkv")
            if i == self.layer and self.facet in ("query", "key", "value"):
                out = {"query": q, "key": k, "value": v}[self.facet]
            qh, kh, vh = (t.reshape(b, -1, self.heads, d_head).transpose(1, 2)
                          for t in (q, k, v))
            attn = torch.softmax(qh @ kh.transpose(-1, -2)
                                 / math.sqrt(d_head), dim=-1)
            if i == self.layer and self.facet == "attn":
                out = attn.mean(dim=1)
            o = (attn @ vh).transpose(1, 2).reshape(b, -1, self.hidden)
            x = x + getattr(self, f"proj_{i}")(o)
            y = getattr(self, f"mlp1_{i}")(getattr(self, f"ln2_{i}")(x))
            x = x + getattr(self, f"mlp2_{i}")(gelu(y))
            if i == self.layer and self.facet == "token":
                out = x
        if out is None:  # layer past depth: the final tokens
            out = x
        return out if self.facet == "attn" else out[:, 1:]


class TappedAttention(nn.Module):
    """Multi-head self-attention with the q / k / v projections exposed
    (JAX's ``_TappedAttention``): flax ``MultiHeadDotProductAttention``'s
    tree (``query`` / ``key`` / ``value`` kernels [D, H, hd], ``out``
    [H, hd, D]), the scale applied after the product."""

    def __init__(self, hidden: int, heads: int):
        super().__init__()
        hd = hidden // heads
        self.query = ProjectHeads((hidden, heads, hd), False)
        self.key = ProjectHeads((hidden, heads, hd), False)
        self.value = ProjectHeads((hidden, heads, hd), False)
        self.out = ProjectHeads((heads, hd, hidden), True)
        self.hd = hd

    def forward(self, y: torch.Tensor):
        q, k, v = self.query(y), self.key(y), self.value(y)  # [B, N, H, hd]
        attn = torch.softmax(torch.einsum("bnhd,bmhd->bhnm", q, k)
                             / math.sqrt(self.hd), dim=-1)
        o = torch.einsum("bhnm,bmhd->bnhd", attn, v)
        b, n = y.shape[:2]
        taps = {f: t.reshape(b, n, -1) for f, t in
                (("query", q), ("key", k), ("value", v))}
        return self.out(o), taps


class CosPlaceViTExtractFeatures(nn.Module):
    """CosPlace-ViT intermediate-layer extractor (ViT-B/16 by default):
    block ``layer``'s query / key / value projection or output tokens,
    optionally without CLS and L2-normalised.  JAX sizes its positional
    embedding from the first input; the port from ``image_hw``.  Weights
    of ``utils/torch_convert.convert_vit_b16`` fit (deeper layers of the
    checkpoint have no place)."""

    def __init__(self, image_hw: Tuple[int, int] = (224, 224),
                 hidden: int = 768, heads: int = 12, patch: int = 16,
                 layer: int = 11, facet: str = "token",
                 use_cls: bool = False, norm_descs: bool = True,
                 ln_eps: float = 1e-12):
        super().__init__()
        if facet not in _VIT_FACETS[:4]:
            raise ValueError(f"facet {facet!r} not in {_VIT_FACETS[:4]}")
        self.hidden, self.layer, self.facet = hidden, layer, facet
        self.use_cls, self.norm_descs = use_cls, norm_descs
        self.embed = Conv2d(3, hidden, patch, patch, 0, True, None)
        n = (image_hw[0] // patch) * (image_hw[1] // patch) + 1
        self.cls = nn.Parameter(torch.zeros(1, 1, hidden))
        self.pos = nn.Parameter(torch.empty(1, n, hidden))
        self.init_std = {"cls": 0.0, "pos": 0.02}
        for i in range(layer + 1):
            setattr(self, f"ln1_{i}", LayerNorm(hidden, ln_eps))
            setattr(self, f"attn_{i}", TappedAttention(hidden, heads))
            setattr(self, f"ln2_{i}", LayerNorm(hidden, ln_eps))
            setattr(self, f"mlp1_{i}", Dense(hidden, 4 * hidden))
            setattr(self, f"mlp2_{i}", Dense(4 * hidden, hidden))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, H, W, 3]
        b = x.shape[0]
        x = self.embed(x.float())
        x = x.reshape(b, -1, self.hidden)
        x = torch.cat([self.cls.expand(b, -1, -1), x], dim=1)
        if x.shape[1] != self.pos.shape[1]:
            raise ValueError(f"{x.shape[1]} tokens; the positional "
                             f"embedding was sized for {self.pos.shape[1]}")
        x = x + self.pos
        out = None
        for i in range(self.layer + 1):
            y, taps = getattr(self, f"attn_{i}")(getattr(self, f"ln1_{i}")(x))
            if i == self.layer and self.facet != "token":
                out = taps[self.facet]
            x = x + y
            y = getattr(self, f"mlp1_{i}")(getattr(self, f"ln2_{i}")(x))
            x = x + getattr(self, f"mlp2_{i}")(gelu(y))
            if i == self.layer and self.facet == "token":
                out = x
        if not self.use_cls:
            out = out[:, 1:]
        if self.norm_descs:
            out = out / torch.clamp(torch.linalg.vector_norm(
                out, dim=-1, keepdim=True), min=1e-12)
        return out


# ----------------------------- MAE 2-D sine-cosine position embeddings

def get_1d_sincos_pos_embed_from_grid(embed_dim: int,
                                      pos: np.ndarray) -> np.ndarray:
    """[M] positions -> [M, embed_dim]: sin in the first half of the
    channels, cos in the second."""
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", np.asarray(pos).reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_2d_sincos_pos_embed_from_grid(embed_dim: int,
                                      grid: np.ndarray) -> np.ndarray:
    """grid[0] -> the first half of the channels, grid[1] the second."""
    assert embed_dim % 2 == 0
    emb_h = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[0])
    emb_w = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1)


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int,
                            cls_token: bool = False) -> np.ndarray:
    """[grid * grid (+1), embed_dim], w varying fastest; a zero row first
    for the CLS token."""
    coords = np.arange(grid_size, dtype=np.float32)
    grid = np.stack(np.meshgrid(coords, coords), axis=0)  # w first
    grid = grid.reshape(2, 1, grid_size, grid_size)
    pe = get_2d_sincos_pos_embed_from_grid(embed_dim, grid)
    if cls_token:
        pe = np.concatenate([np.zeros((1, embed_dim)), pe], axis=0)
    return pe


def interpolate_pos_embed(pos_embed: np.ndarray, num_patches: int,
                          num_extra_tokens: int = 1) -> np.ndarray:
    """[1, extra + N_old, D] -> [1, extra + num_patches, D]: the extra
    tokens pass through, the patch grid is resampled bicubically (Keys,
    a = -0.5, antialiased when it shrinks: ``jax.image.resize``'s)."""
    pos_embed = np.asarray(pos_embed, np.float32)
    n_tok, dim = pos_embed.shape[-2], pos_embed.shape[-1]
    orig_size = int((n_tok - num_extra_tokens) ** 0.5)
    new_size = int(num_patches ** 0.5)
    if orig_size == new_size:
        return pos_embed
    extra_tokens = pos_embed[:, :num_extra_tokens]
    grid = torch.from_numpy(np.ascontiguousarray(
        pos_embed[:, num_extra_tokens:].reshape(1, orig_size, orig_size,
                                                dim)))
    grid = resize_hw(grid, (new_size, new_size), "bicubic").numpy()
    return np.concatenate(
        [extra_tokens, grid.reshape(1, new_size * new_size, dim)], axis=1)


class DinoV2ExtractFeatures(nn.Module):
    """DINOv2-style extractor at ViT-B/14's widths by default: the
    ``ViTExtractor`` (as child ``vit``) with stride = patch."""

    def __init__(self, hidden: int = 768, depth: int = 12, heads: int = 12,
                 patch: int = 14, layer: int = 11, facet: str = "token"):
        super().__init__()
        self.vit = ViTExtractor(hidden=hidden, depth=depth, heads=heads,
                                patch=patch, stride=patch, layer=layer,
                                facet=facet)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.vit(x)


def _norm(d: torch.Tensor) -> torch.Tensor:
    return d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True),
                           min=1e-12)


class VLAD:
    """VLAD over patch descriptors on ``device`` (the card unless the
    caller passes ``"cpu"``): a k-means vocabulary (cosine or euclidean),
    hard or soft assignment, intra-normalisation, optional descriptor
    normalisation, and the ``c_centers.npy`` cache in ``cache_dir``.

    ``generate`` keeps both quirks of JAX's (and the reference's) code:
    hard labels come from the raw descriptors while the residuals use the
    ``norm_descs``-normalised ones, and the soft branch sums every
    cluster's residual ("(q c) d"): vlad[k] = sum_q soft[q, k] *
    (C * d_q - sum_c center_c)."""

    def __init__(self, num_clusters: int, desc_dim: Optional[int] = None,
                 intra_norm: bool = True, norm_descs: bool = True,
                 dist_mode: str = "cosine", vlad_mode: str = "hard",
                 soft_temp: float = 1.0, cache_dir: Optional[str] = None,
                 device="cuda"):
        if vlad_mode not in ("soft", "hard") or dist_mode not in (
                "cosine", "euclidean"):
            raise ValueError(f"vlad_mode {vlad_mode!r} (soft | hard), "
                             f"dist_mode {dist_mode!r} (cosine | euclidean)")
        self.num_clusters = num_clusters
        self.desc_dim = desc_dim
        self.intra_norm = intra_norm
        self.norm_descs = norm_descs
        self.mode = dist_mode
        self.vlad_mode = vlad_mode
        self.soft_temp = soft_temp
        self.cache_dir = cache_dir
        self.device = resolve_device(device)
        self.c_centers: Optional[torch.Tensor] = None

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def fit(self, train_descs, seed: int = 0, init_idx=None) -> "VLAD":
        """k-means vocabulary over [N, D] descriptors (25 Lloyd
        iterations from ``num_clusters`` distinct rows: drawn from
        ``seed``, or the rows ``init_idx``); None loads the cache."""
        if train_descs is None:
            cc = self._load_cache()
            if cc is None:
                raise ValueError("no training descriptors and no cache")
            self.c_centers = cc
            return self
        d = self._tensor(train_descs)
        if self.norm_descs:
            d = _norm(d)
        fit_d = _norm(d) if self.mode == "cosine" else d
        self.c_centers, _ = kmeans(
            fit_d, self.num_clusters,
            generator=torch.Generator().manual_seed(seed), init_idx=init_idx)
        self.desc_dim = d.shape[-1]
        self._save_cache()
        return self

    def fit_and_generate(self, train_descs: Sequence) -> torch.Tensor:
        """Fit on the stacked descriptors, then one VLAD per item."""
        self.fit(torch.cat([self._tensor(t) for t in train_descs]))
        return self.generate_multi(train_descs)

    def generate(self, query_descs) -> torch.Tensor:
        """[N, D] patch descriptors -> [K * D] VLAD."""
        if self.c_centers is None:
            raise ValueError("VLAD.generate before fit")
        raw = self._tensor(query_descs)
        c = self.c_centers
        d = _norm(raw) if self.norm_descs else raw
        residuals = d[:, None, :] - c[None]  # [N, K, D]
        if self.vlad_mode == "hard":
            if self.mode == "cosine":
                labels = torch.argmax(_norm(raw) @ _norm(c).T, dim=-1)
            else:
                labels = torch.argmin(
                    ((raw[:, None] - c[None]) ** 2).sum(-1), dim=-1)
            assign = torch.nn.functional.one_hot(
                labels, self.num_clusters).float()
            vlad = (assign[..., None] * residuals).sum(dim=0)  # [K, D]
        else:
            sim = _norm(raw) @ _norm(c).T
            e = torch.exp(self.soft_temp * sim)
            assign = e / e.sum(-1, keepdim=True)
            vlad = assign.T @ residuals.sum(dim=1)  # the (q c) d quirk
        if self.intra_norm:
            vlad = _norm(vlad)
        vlad = vlad.reshape(-1)
        return vlad / torch.clamp(torch.linalg.vector_norm(vlad), min=1e-12)

    def generate_multi(self, multi_descs: Sequence) -> torch.Tensor:
        return torch.stack([self.generate(d) for d in multi_descs])

    def _cache_path(self) -> Optional[str]:
        if self.cache_dir is None:
            return None
        os.makedirs(self.cache_dir, exist_ok=True)
        return f"{self.cache_dir}/c_centers.npy"

    def _save_cache(self) -> None:
        p = self._cache_path()
        if p is not None:
            np.save(p, self.c_centers.cpu().numpy())

    def _load_cache(self) -> Optional[torch.Tensor]:
        p = self._cache_path()
        if p is not None and os.path.exists(p):
            return self._tensor(np.load(p))
        return None


def get_top_k_recall(top_k: Sequence[int], db, qu,
                     gt_pos: Sequence[np.ndarray], method: str = "cosine"
                     ) -> Tuple[np.ndarray, np.ndarray, Dict[int, float]]:
    """AnyLoc's recall utility: exact top-max(top_k) search on the
    descriptors' device (inner product for ``cosine``, else squared L2;
    ties lowest index first) and {k: recall in [0, 1]}."""
    k = max(top_k)
    db, qu = torch.as_tensor(db), torch.as_tensor(qu)
    search = ip_topk if method == "cosine" else l2_topk
    dists, indices = search(qu.to(db.device), db, k)
    indices = indices.cpu().numpy()
    recalls_arr, _ = compute_recalls(indices, gt_pos, top_k)
    recalls = {n: r / 100.0 for n, r in zip(top_k, recalls_arr)}
    return dists.cpu().numpy(), indices, recalls
