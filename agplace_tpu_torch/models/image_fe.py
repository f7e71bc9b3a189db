"""Image feature extractor registry (``agplace_tpu/models/image_fe.py``),
resnet branch only: ``len(layers)`` stages of the trunk are kept."""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from agplace_tpu_torch.models.resnet import ResNetFeatures


class ImageFE(nn.Module):
    def __init__(self, fe_type: str = "resnet18",
                 layers: Tuple[int, ...] = (2, 2, 2),
                 dtype: torch.dtype = torch.float32,
                 use_pallas_stem: bool = False):
        super().__init__()
        if fe_type not in ("resnet18", "resnet34"):
            raise NotImplementedError(f"fe_type={fe_type}")
        self.fe = ResNetFeatures(fe_type, len(layers), dtype,
                                 use_pallas_stem)

    def forward(self, x):
        return self.fe(x)

    @staticmethod
    def last_dim(fe_type: str, layers: Tuple[int, ...]) -> int:
        return ResNetFeatures.last_dim(len(layers))
