"""ResNet trunk (``agplace_tpu/models/resnet.py:28-169``), NHWC.

Module and parameter names follow the flax tree (``conv1``, ``bn1``,
``layer{s}_{b}``, ``downsample_conv``/``downsample_bn``) so the weight
bridge maps paths one to one.  The convolutions are cuDNN (XLA ran them
outside any Pallas kernel).  The stem tail (BN, relu, maxpool 3x3/2) runs
unfused, or, with ``use_pallas_stem`` in eval mode on bf16 activations of
even size, as K5 (``ops/stem_pool.py``), with JAX's gate
(``resnet.py:134-138``).  Training mode takes batch statistics in every
BN (``models/norm.py``).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from agplace_tpu_torch.models.layers import Conv2d
from agplace_tpu_torch.models.norm import BatchNorm2D
from agplace_tpu_torch.ops import stem_pool

_BASIC_STAGES = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3)}


class BasicBlock(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int, downsample: bool,
                 dtype: torch.dtype):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 3, stride, 1, False, dtype)
        self.bn1 = BatchNorm2D(planes)
        self.conv2 = Conv2d(planes, planes, 3, 1, 1, False, dtype)
        self.bn2 = BatchNorm2D(planes)
        if downsample:
            self.downsample_conv = Conv2d(cin, planes, 1, stride, 0, False,
                                          dtype)
            self.downsample_bn = BatchNorm2D(planes)
        self.downsample = downsample

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        idn = (self.downsample_bn(self.downsample_conv(x))
               if self.downsample else x)
        return torch.relu(out + idn)


class ResNetFeatures(nn.Module):
    """Stem + the first ``num_stages`` residual stages; returns (final map,
    per-stage maps), all NHWC."""

    def __init__(self, arch: str = "resnet18", num_stages: int = 3,
                 dtype: torch.dtype = torch.float32,
                 use_pallas_stem: bool = False):
        super().__init__()
        if arch not in _BASIC_STAGES:
            raise NotImplementedError(f"arch={arch} (port has basic-block "
                                      f"resnets only)")
        self.conv1 = Conv2d(3, 64, 7, 2, 3, False, dtype)
        self.bn1 = BatchNorm2D(64)
        self.num_stages = num_stages
        self.use_pallas_stem = use_pallas_stem
        in_ch = 64
        for stage in range(num_stages):
            planes = 64 * 2 ** stage
            stride = 1 if stage == 0 else 2
            for b in range(_BASIC_STAGES[arch][stage]):
                ds = b == 0 and (stride != 1 or in_ch != planes)
                setattr(self, f"layer{stage + 1}_{b}", BasicBlock(
                    in_ch if b == 0 else planes, planes,
                    stride if b == 0 else 1, ds, dtype))
            in_ch = planes
        self.blocks = [[getattr(self, f"layer{s + 1}_{b}")
                        for b in range(_BASIC_STAGES[arch][s])]
                       for s in range(num_stages)]

    def forward(self, x) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        x = self.conv1(x)
        if (self.use_pallas_stem and not self.training
                and x.dtype == torch.bfloat16
                and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0):
            x = stem_pool.fused_affine_relu_maxpool(x, *self.bn1.affine())
        else:
            x = torch.relu(self.bn1(x)).permute(0, 3, 1, 2)
            x = F.max_pool2d(x, 3, 2, 1).permute(0, 2, 3, 1)
        maps = []
        for stage in self.blocks:
            for blk in stage:
                x = blk(x)
            maps.append(x)
        return x, maps

    @staticmethod
    def last_dim(num_stages: int) -> int:
        return 64 * 2 ** (num_stages - 1)
