"""Inference entry: build both towers from ``Config`` through the factory
and return the descriptor closures (``agplace_tpu/models/factory.py`` +
``train/step.py:make_infer_fns``).

    mm, db = build_towers(cfg, generator=torch.Generator())  # on the card
    embed_queries, embed_db = make_infer_fns(mm, db)
    q = embed_queries(images, prepare_query_vox(cfg, points))

The query tower is named ``mm`` whatever its family (JAX's checkpoint
key); under ``share_qdb`` there is no aerial tower (``db`` is None) and
``embed_db`` runs the query tower over the maps.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from agplace_tpu_torch.config import Config
from agplace_tpu_torch.device import resolve_device
from agplace_tpu_torch.models.factory import (make_db_model,
                                              make_query_model, query_apply,
                                              shared_db_apply, tower_width)
from agplace_tpu_torch.utils.spans import span


def compute_dtype(cfg: Config) -> torch.dtype:
    return (torch.bfloat16 if cfg.model.compute_dtype == "bfloat16"
            else torch.float32)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init with the flax initialisers' scales: conv and
    dense weights lecun-normal (std 1/sqrt(fan_in)), voxel conv kernels
    ([k,k,k,cin,cout], sparse [K,cin,cout]) kaiming-normal (std
    sqrt(2/fan_in)), norms ones/zeros, GeM p = 3.
    Running statistics keep their defaults (mean 0, var 1).  A module's
    ``init_std`` {leaf: std} overrides these (flax's own initialisers of
    attention kernels, positional embeddings, NetVLAD's clusters)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            owner, leaf = name.rpartition(".")[::2]
            std = getattr(module.get_submodule(owner) if owner else module,
                          "init_std", {}).get(leaf)
            if std is not None:
                p.copy_(torch.randn(p.shape, generator=generator) * std)
                continue
            if leaf == "p":
                p.fill_(3.0)
                continue
            if leaf == "bias" or (leaf == "weight" and p.ndim == 1):
                p.fill_(0.0 if leaf == "bias" else 1.0)
                continue
            if leaf == "kernel" and p.ndim == 5:
                std = math.sqrt(2.0 / (p.shape[0] ** 3 * p.shape[3]))
            elif leaf == "kernel" and p.ndim == 3:  # sparse [K, cin, cout]
                std = math.sqrt(2.0 / (p.shape[0] * p.shape[1]))
            elif leaf in ("kernel", "fc_kernel"):  # [in, out]
                std = 1.0 / math.sqrt(p.shape[0])
            elif leaf == "conv_w":  # ECA [k, 1, 1]
                std = 1.0 / math.sqrt(p.shape[0])
            elif p.ndim >= 2:  # OIHW conv or [out, in] dense
                std = 1.0 / math.sqrt(p[0].numel())
            else:  # learned scalar component weights keep their config value
                continue
            p.copy_(torch.randn(p.shape, generator=generator) * std)


def build_towers(cfg: Config, device="cuda",
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[nn.Module, Optional[nn.Module]]:
    """The query tower (``--modelq``) and the aerial tower (``--modeldb``;
    None under ``share_qdb``) in eval mode on ``device`` (the card;
    ``"cpu"`` runs the plain versions, and without a card anything else
    raises); weights are seeded from ``generator`` when given (load real
    weights with ``utils.convert.load_jax_variables``)."""
    device = resolve_device(device)
    dt = compute_dtype(cfg)
    mm = make_query_model(cfg, dt)
    db = None if cfg.model.share_qdb else make_db_model(cfg, dt)
    wq, wd = tower_width(mm), tower_width(db)
    if db is not None and None not in (wq, wd) and wq != wd:
        raise NotImplementedError(
            f"modelq={cfg.model.modelq!r} gives {wq}-wide descriptors and "
            f"modeldb={cfg.model.db.modeldb!r} {wd}-wide ones: JAX's train "
            f"step concatenates them and fails with a TypeError, and no "
            f"search can compare them")
    for tower in (mm, db):
        if tower is None:
            continue
        if generator is not None:
            init_weights(tower, generator)
        tower.to(device).eval()
        for p in tower.parameters():  # 2-D conv weights for cuDNN NHWC
            if p.ndim == 4:
                p.data = p.data.contiguous(memory_format=torch.channels_last)
    return mm, db


def make_infer_fns(mm: nn.Module, db: Optional[nn.Module]
                   ) -> Tuple[Callable, Callable]:
    """(embed_queries(images [B,H,W,3], vox) -> [B, C],
    embed_db(db_map [B,NMAP,H,W,3]) -> [B, C]), both under
    ``torch.inference_mode()``; with ``db`` None the query tower embeds
    the maps (``share_qdb``)."""

    def embed_queries(images: torch.Tensor, vox) -> torch.Tensor:
        with span("entry.embed_queries"), torch.inference_mode():
            return query_apply(mm, images, vox)["embedding"]

    def embed_db(db_map: torch.Tensor) -> torch.Tensor:
        with span("entry.embed_db"), torch.inference_mode():
            return db(db_map) if db is not None else shared_db_apply(
                mm, db_map)

    return embed_queries, embed_db
