"""Image feature extractors (``agplace_tpu/models/image_fe.py``): truncated
CNN trunks returning the final map and the per-stage maps, NHWC.

``ImageFE`` keys them by the ``--mm_imgfe`` / ``--dbimage_fe`` names:
resnet18 / 34 / 50 (``len(layers)`` stages, in the tower's dtype, K5 on the
stem tail when asked), convnext_tiny and squeezenet10 / 11.  The last two
take no dtype in JAX (flax's ``dtype=None``: the input's and the kernel's
common type), and neither do they here.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from agplace_tpu_torch.models.layers import (Conv2d, Dense, LayerNorm, gelu,
                                             max_pool_nhwc)
from agplace_tpu_torch.models.resnet import ResNetFeatures

_RESNETS = ("resnet18", "resnet34", "resnet50")
_CONVNEXT_DIMS = (96, 192, 384, 768)


class ConvNeXtBlock(nn.Module):
    """Depthwise 7x7 -> LayerNorm (eps 1e-6) -> 4x MLP with tanh GELU ->
    layer scale ``gamma`` -> residual."""

    def __init__(self, dim: int, layer_scale: float = 1e-6):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, 7, 1, 3, True, None, groups=dim)
        self.norm = LayerNorm(dim, eps=1e-6)
        self.pwconv1 = Dense(dim, 4 * dim)
        self.pwconv2 = Dense(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale))

    def forward(self, x):
        y = self.pwconv2(gelu(self.pwconv1(self.norm(self.dwconv(x)))))
        return x + self.gamma * y


class ConvNeXtTinyFeatures(nn.Module):
    """convnext_tiny with each stage's depth clipped to ``layers`` and the
    map after each of the ``len(layers)`` stages kept."""

    def __init__(self, layers: Tuple[int, ...] = (2, 2, 2)):
        super().__init__()
        depths, dims = (3, 3, 9, 3), _CONVNEXT_DIMS
        self.stem_conv = Conv2d(3, dims[0], 4, 4, 0, True, None)
        self.stem_norm = LayerNorm(dims[0], eps=1e-6)
        self.stages = []
        for s in range(min(len(layers), 4)):
            down = None
            if s > 0:
                setattr(self, f"down_norm{s}", LayerNorm(dims[s - 1], 1e-6))
                setattr(self, f"down_conv{s}",
                        Conv2d(dims[s - 1], dims[s], 2, 2, 0, True, None))
                down = (getattr(self, f"down_norm{s}"),
                        getattr(self, f"down_conv{s}"))
            blocks = []
            for i in range(min(layers[s], depths[s])):
                setattr(self, f"stage{s}_block{i}", ConvNeXtBlock(dims[s]))
                blocks.append(getattr(self, f"stage{s}_block{i}"))
            self.stages.append((down, blocks))

    def forward(self, x):
        x = self.stem_norm(self.stem_conv(x))
        maps = []
        for down, blocks in self.stages:
            if down is not None:
                x = down[1](down[0](x))
            for blk in blocks:
                x = blk(x)
            maps.append(x)
        return x, maps


class FireModule(nn.Module):
    """squeeze 1x1 -> relu -> (expand 1x1, expand 3x3) -> relu, concat."""

    def __init__(self, cin: int, squeeze: int, expand: int):
        super().__init__()
        self.squeeze = Conv2d(cin, squeeze, 1, 1, 0, True, None)
        self.expand1 = Conv2d(squeeze, expand, 1, 1, 0, True, None)
        self.expand3 = Conv2d(squeeze, expand, 3, 1, 1, True, None)

    def forward(self, x):
        s = torch.relu(self.squeeze(x))
        return torch.cat([torch.relu(self.expand1(s)),
                          torch.relu(self.expand3(s))], dim=-1)


# version -> (stem width, stem kernel, fire (squeeze, expand) per group);
# a 3x3/2 ceil-mode max-pool before each group, a map after each group
_SQUEEZE = {
    "1_0": (96, 7, (((16, 64), (16, 64), (32, 128)),
                    ((32, 128), (48, 192), (48, 192), (64, 256)),
                    ((64, 256),))),
    "1_1": (64, 3, (((16, 64), (16, 64)), ((32, 128), (32, 128)),
                    ((48, 192), (48, 192), (64, 256), (64, 256)))),
}


class SqueezeNetFeatures(nn.Module):
    """torchvision's squeezenet1_0 / 1_1 trunk (unpadded stem, ceil-mode
    max-pools) and the reference's 1x1 512 -> 256 head ``fc``; maps after
    the first two fire groups and after the head."""

    def __init__(self, version: str = "1_1"):
        super().__init__()
        width, k, groups = _SQUEEZE[version]
        self.conv0 = Conv2d(3, width, k, 2, 0, True, None)
        c, i, self.groups = width, 0, []
        for group in groups:
            fires = []
            for s, e in group:
                setattr(self, f"fire{i}", FireModule(c, s, e))
                fires.append(getattr(self, f"fire{i}"))
                c, i = 2 * e, i + 1
            self.groups.append(fires)
        self.fc = Conv2d(c, 256, 1, 1, 0, True, None)

    def forward(self, x):
        x = torch.relu(self.conv0(x))
        maps = []
        for g, fires in enumerate(self.groups):
            x = max_pool_nhwc(x, 3, 2, ceil_mode=True)
            for fire in fires:
                x = fire(x)
            if g < len(self.groups) - 1:
                maps.append(x)
        x = self.fc(x)
        maps.append(x)
        return x, maps


class ImageFE(nn.Module):
    def __init__(self, fe_type: str = "resnet18",
                 layers: Tuple[int, ...] = (2, 2, 2),
                 dtype: torch.dtype = torch.float32,
                 use_pallas_stem: bool = False):
        super().__init__()
        if fe_type in _RESNETS:
            self.fe = ResNetFeatures(fe_type, len(layers), dtype,
                                     use_pallas_stem)
        elif fe_type == "convnext_tiny":
            self.fe = ConvNeXtTinyFeatures(tuple(layers))
        elif fe_type in ("squeezenet10", "squeezenet11"):
            self.fe = SqueezeNetFeatures("1_0" if fe_type == "squeezenet10"
                                         else "1_1")
        else:
            raise NotImplementedError(f"fe_type={fe_type}")

    def forward(self, x):
        return self.fe(x)

    @staticmethod
    def last_dim(fe_type: str, layers: Tuple[int, ...]) -> int:
        if fe_type in _RESNETS:
            return ResNetFeatures.last_dim(fe_type, len(layers))
        if fe_type == "convnext_tiny":
            return _CONVNEXT_DIMS[min(len(layers), 4) - 1]
        if fe_type in ("squeezenet10", "squeezenet11"):
            return 256
        raise NotImplementedError(fe_type)

    @staticmethod
    def map_dims(fe_type: str, layers: Tuple[int, ...]) -> Tuple[int, ...]:
        """The widths of the per-stage maps the trunk returns."""
        if fe_type == "squeezenet10":
            return (256, 512, 256)
        if fe_type == "squeezenet11":
            return (128, 256, 256)
        return ImageFE.stage_dims(fe_type, layers)

    @staticmethod
    def stage_dims(fe_type: str, layers: Tuple[int, ...]):
        n = len(layers)
        if fe_type in ("resnet18", "resnet34"):
            return tuple(64 * 2 ** i for i in range(n))
        if fe_type == "resnet50":
            return tuple(256 * 2 ** i for i in range(n))
        if fe_type == "convnext_tiny":
            return _CONVNEXT_DIMS[:n]
        raise NotImplementedError(fe_type)
