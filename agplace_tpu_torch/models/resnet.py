"""ResNet trunks (``agplace_tpu/models/resnet.py:28-174``), NHWC: resnet18 /
34 of basic blocks, resnet50 / 101 of bottlenecks (expansion 4).

Module and parameter names follow the flax tree (``conv1``, ``bn1``,
``layer{s}_{b}``, ``downsample_conv``/``downsample_bn``) so the weight
bridge maps paths one to one.  The convolutions are cuDNN (XLA ran them
outside any Pallas kernel).  The stem tail (BN, relu, maxpool 3x3/2) runs
unfused, or, with ``use_pallas_stem`` in eval mode on bf16 activations of
even size, as K5 (``ops/stem_pool.py``), with JAX's gate
(``resnet.py:134-138``).  Training mode takes batch statistics in every
BN (``models/norm.py``).

Each conv's BN, with the block's residual and relu where they follow, is
one ``epilogue``: in eval mode, one pass of ``ops/bn_act.py``'s kernel
over the conv's output on the card, bit-equal to the eager chain that runs
on the CPU and in training.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from agplace_tpu_torch.models.layers import Conv2d, max_pool_nhwc
from agplace_tpu_torch.models.norm import BatchNorm2D
from agplace_tpu_torch.ops import bn_act, stem_pool


def epilogue(training: bool, y: torch.Tensor, bn: BatchNorm2D,
             residual: Optional[torch.Tensor] = None,
             residual_bn: Optional[BatchNorm2D] = None) -> torch.Tensor:
    """relu(bn(y) [+ residual | + residual_bn(residual)]) of a fresh conv
    output ``y``.  In eval mode, where nothing needs a gradient,
    ``bn_act.fused_bn_act`` writes it over ``y`` (the kernel on the card,
    the eager chain on the CPU); training mode and autograd take the eager
    chain (batch statistics, a backward)."""
    if training or (torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (y, residual, *bn.parameters(),
                      *(residual_bn.parameters() if residual_bn is not None
                        else ())))):
        out = bn(y)
        if residual is not None:
            out = out + (residual if residual_bn is None
                         else residual_bn(residual))
        return torch.relu(out)
    return bn_act.fused_bn_act(
        y, *bn.affine(), residual,
        None if residual_bn is None else residual_bn.affine(), out=y)


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
        out = epilogue(self.training, self.conv1(x), self.bn1)
        out = self.conv2(out)
        if self.downsample:
            return epilogue(self.training, out, self.bn2,
                            self.downsample_conv(x), self.downsample_bn)
        return epilogue(self.training, out, self.bn2, x)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (the stride) -> 1x1 to ``planes * 4``, each with BN."""

    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int, downsample: bool,
                 dtype: torch.dtype):
        super().__init__()
        cout = planes * self.expansion
        self.conv1 = Conv2d(cin, planes, 1, 1, 0, False, dtype)
        self.bn1 = BatchNorm2D(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride, 1, False, dtype)
        self.bn2 = BatchNorm2D(planes)
        self.conv3 = Conv2d(planes, cout, 1, 1, 0, False, dtype)
        self.bn3 = BatchNorm2D(cout)
        if downsample:
            self.downsample_conv = Conv2d(cin, cout, 1, stride, 0, False,
                                          dtype)
            self.downsample_bn = BatchNorm2D(cout)
        self.downsample = downsample

    def forward(self, x):
        out = epilogue(self.training, self.conv1(x), self.bn1)
        out = epilogue(self.training, self.conv2(out), self.bn2)
        out = self.conv3(out)
        if self.downsample:
            return epilogue(self.training, out, self.bn3,
                            self.downsample_conv(x), self.downsample_bn)
        return epilogue(self.training, out, self.bn3, x)


# arch -> (block, blocks per stage, expansion)
RESNET_SPECS = {
    "resnet18": (BasicBlock, (2, 2, 2, 2), 1),
    "resnet34": (BasicBlock, (3, 4, 6, 3), 1),
    "resnet50": (Bottleneck, (3, 4, 6, 3), 4),
    "resnet101": (Bottleneck, (3, 4, 23, 3), 4),
}


class ResNetFeatures(nn.Module):
    """Stem + the first ``num_stages`` residual stages; returns (final map,
    per-stage maps), all NHWC."""

    def __init__(self, arch: str = "resnet18", num_stages: int = 3,
                 dtype: torch.dtype = torch.float32,
                 use_pallas_stem: bool = False):
        super().__init__()
        if arch not in RESNET_SPECS:
            raise NotImplementedError(f"arch={arch}")
        block, sizes, expansion = RESNET_SPECS[arch]
        self.conv1 = Conv2d(3, 64, 7, 2, 3, False, dtype)
        self.bn1 = BatchNorm2D(64)
        self.num_stages = num_stages
        self.use_pallas_stem = use_pallas_stem
        in_ch = 64
        for stage in range(num_stages):
            planes = 64 * 2 ** stage
            stride = 1 if stage == 0 else 2
            for b in range(sizes[stage]):
                ds = b == 0 and (stride != 1 or in_ch != planes * expansion)
                setattr(self, f"layer{stage + 1}_{b}", block(
                    in_ch if b == 0 else planes * expansion, planes,
                    stride if b == 0 else 1, ds, dtype))
            in_ch = planes * expansion
        self.blocks = [[getattr(self, f"layer{s + 1}_{b}")
                        for b in range(sizes[s])]
                       for s in range(num_stages)]

    def forward(self, x) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        x = self.conv1(x)
        if (self.use_pallas_stem and not self.training
                and x.dtype == torch.bfloat16
                and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0):
            x = stem_pool.fused_affine_relu_maxpool(x, *self.bn1.affine())
        else:
            x = max_pool_nhwc(epilogue(self.training, x, self.bn1), 3, 2, 1)
        maps = []
        for stage in self.blocks:
            for blk in stage:
                x = blk(x)
            maps.append(x)
        return x, maps

    @staticmethod
    def last_dim(arch: str, num_stages: int) -> int:
        return 64 * 2 ** (num_stages - 1) * RESNET_SPECS[arch][2]
