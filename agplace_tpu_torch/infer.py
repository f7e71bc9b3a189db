"""Inference entry: build both towers from ``Config`` and return the
descriptor closures (``agplace_tpu/models/factory.py`` +
``train/step.py:make_infer_fns``).

    mm, db = build_towers(cfg, generator=torch.Generator())  # on the card
    embed_queries, embed_db = make_infer_fns(mm, db)
    q = embed_queries(images, prepare_query_vox(cfg, points))
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from agplace_tpu_torch.config import Config
from agplace_tpu_torch.device import resolve_device
from agplace_tpu_torch.models.dbvanilla2d import DBVanilla2D
from agplace_tpu_torch.models.mm import MM


def compute_dtype(cfg: Config) -> torch.dtype:
    return (torch.bfloat16 if cfg.model.compute_dtype == "bfloat16"
            else torch.float32)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init with the flax initialisers' scales: conv and
    dense weights lecun-normal (std 1/sqrt(fan_in)), voxel conv kernels
    ([k,k,k,cin,cout], sparse [K,cin,cout]) kaiming-normal (std
    sqrt(2/fan_in)), norms ones/zeros, GeM p = 3.
    Running statistics keep their defaults (mean 0, var 1)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
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
                 ) -> Tuple[MM, DBVanilla2D]:
    """The MM query tower and the DBVanilla2D aerial tower, in eval mode on
    ``device`` (the card; ``"cpu"`` runs the plain versions, and without a
    card anything else raises); weights are seeded from ``generator`` when
    given (load real weights with ``utils.convert.load_jax_variables``)."""
    device = resolve_device(device)
    if cfg.model.modelq != "mm" or cfg.model.db.modeldb != "vanilla2d":
        raise NotImplementedError("the port serves modelq='mm' with "
                                  "modeldb='vanilla2d'")
    dt = compute_dtype(cfg)
    mm = MM(cfg.model.mm, dtype=dt)
    db = DBVanilla2D(cfg.model.db, dim=cfg.model.features_dim,
                     nmap=cfg.data.nmap, output_l2=cfg.model.mm.output_l2,
                     final_l2=cfg.model.mm.final_l2, dtype=dt)
    for tower in (mm, db):
        if generator is not None:
            init_weights(tower, generator)
        tower.to(device).eval()
        for p in tower.parameters():  # 2-D conv weights for cuDNN NHWC
            if p.ndim == 4:
                p.data = p.data.contiguous(memory_format=torch.channels_last)
    return mm, db


def make_infer_fns(mm: MM, db: DBVanilla2D
                   ) -> Tuple[Callable, Callable]:
    """(embed_queries(images [B,H,W,3], vox BEVGrid) -> [B, C],
    embed_db(db_map [B,NMAP,H,W,3]) -> [B, C]), both under
    ``torch.inference_mode()``."""

    def embed_queries(images: torch.Tensor, vox) -> torch.Tensor:
        with torch.inference_mode():
            return mm(images, vox)["embedding"]

    def embed_db(db_map: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return db(db_map)

    return embed_queries, embed_db
