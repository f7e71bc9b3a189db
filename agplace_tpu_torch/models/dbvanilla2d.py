"""Aerial/database tower (``agplace_tpu/models/dbvanilla2d.py``): the 5-D
cache/test entry [B, NMAP, H, W, 3] -> [B, dim] and the 6-D train entry
[B, NDB, NMAP, H, W, 3] -> [B, NDB, dim], which folds B*NDB into the batch.
Per map type: truncated ResNet -> GeM -> MLP; per-map L2, then the mean
over map types."""

from __future__ import annotations

import torch
from torch import nn

from agplace_tpu_torch.config import DBConfig
from agplace_tpu_torch.models.image_fe import ImageFE
from agplace_tpu_torch.models.layers import Dense, LayerNorm, l2n
from agplace_tpu_torch.models.pooling import GeM


class MLP(nn.Module):
    """Linear -> LayerNorm -> ReLU -> Linear."""

    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.fc1 = Dense(cin, dim)
        self.ln = LayerNorm(dim)
        self.fc2 = Dense(dim, dim)

    def forward(self, x):
        return self.fc2(torch.relu(self.ln(self.fc1(x))))


class DBVanilla2D(nn.Module):
    def __init__(self, config: DBConfig, dim: int = 256, nmap: int = 1,
                 output_l2: bool = True, final_l2: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.nmap, self.out_dim = nmap, dim
        self.share = config.share_dbfe
        self.output_l2, self.final_l2 = output_l2, final_l2
        last = ImageFE.last_dim(config.image_fe, config.image_fe_layers)
        for i in range(1 if self.share else nmap):
            setattr(self, f"fe_{i}", ImageFE(
                config.image_fe, config.image_fe_layers, dtype,
                use_pallas_stem=config.stem_pallas))
            setattr(self, f"pool_{i}", GeM())
            setattr(self, f"mlp_{i}", MLP(last, dim))

    def forward(self, db_map: torch.Tensor) -> torch.Tensor:
        if db_map.ndim not in (5, 6):
            raise ValueError(f"db_map must be [B, NMAP, H, W, 3] (cache/"
                             f"test) or [B, NDB, NMAP, H, W, 3] (train), "
                             f"got {tuple(db_map.shape)}")
        lead = db_map.shape[:-4]  # (B,) or (B, NDB)
        if db_map.shape[-4] != self.nmap:
            raise ValueError(f"{db_map.shape[-4]} map types, expected "
                             f"{self.nmap}")
        db_map = db_map.reshape(-1, *db_map.shape[-4:])
        vecs = []
        for i in range(self.nmap):
            br = 0 if self.share else i
            featmap, _ = getattr(self, f"fe_{br}")(db_map[:, i])
            vec = getattr(self, f"pool_{br}")(featmap)
            vecs.append(getattr(self, f"mlp_{br}")(vec))
        out = torch.stack(vecs, dim=1)  # [B*NDB, NMAP, dim]
        if self.output_l2:
            out = l2n(out)
        out = out.mean(dim=1).reshape(*lead, -1)
        return l2n(out) if self.final_l2 else out
