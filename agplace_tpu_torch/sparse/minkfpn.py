"""Sparse FPN voxel backbone over padded ``SparseVoxels``
(``agplace_tpu/sparse/minkfpn.py``, reference ``models/minkfpn.py``):

    conv0 (k=5) -> BN -> relu
    per stage i: k=2 s=2 conv (channels kept) -> BN -> relu -> blocks
    final 1x1 conv planes[-1] -> out_channels, replacing out_maps[-1]
    ``num_top_down`` levels: transposed conv (k=2, s=2) + lateral 1x1

The only backend that takes a cloud beyond the grid extent as it is (the
voxels stay where they are; ``quantize`` clamps to +-63).  Returns (final
SparseVoxels, its keys, per-stage (SparseVoxels, keys)).
"""

from __future__ import annotations

from typing import List, Tuple

from torch import nn

from agplace_tpu_torch.data.voxels import SparseVoxels
from agplace_tpu_torch.sparse.modules import (BLOCKS, Keyed, MaskedBatchNorm,
                                              SparseConv, SparseConvTranspose,
                                              build_k3_table)
from agplace_tpu_torch.sparse.voxels import check_top_down, sort_by_key


class MinkFPN(nn.Module):
    def __init__(self, in_channels: int = 1, out_channels: int = 256,
                 planes: Tuple[int, ...] = (64, 128, 256),
                 layers: Tuple[int, ...] = (1, 1, 1), num_top_down: int = 0,
                 conv0_kernel_size: int = 5, block: str = "eca"):
        super().__init__()
        if len(layers) != len(planes):
            raise ValueError(f"planes={planes} layers={layers}")
        check_top_down(num_top_down, len(planes))
        if block not in BLOCKS:
            raise NotImplementedError(
                f"sparse backend blocks: {sorted(BLOCKS)}; got {block!r}")
        n = self.n_stages = len(planes)
        self.ntd = num_top_down
        self.conv0 = SparseConv(in_channels, planes[0], conv0_kernel_size)
        self.bn0 = MaskedBatchNorm(planes[0])
        c = planes[0]
        lateral_c = []
        self.stages = []
        for i in range(n):
            down = SparseConv(c, c, 2, stride=2)
            setattr(self, f"down{i}", down)
            setattr(self, f"down_bn{i}", MaskedBatchNorm(c))
            blocks = []
            for b in range(layers[i]):
                blk = BLOCKS[block](c, planes[i])
                setattr(self, f"block{i}_{b}", blk)
                blocks.append(blk)
                c = planes[i]
            if n - 1 - num_top_down <= i < n - 1:
                lateral_c.append(c)
            self.stages.append((down, getattr(self, f"down_bn{i}"), blocks))
        self.lateral_top = SparseConv(c, out_channels, 1)
        for ndx in range(num_top_down):
            setattr(self, f"tconv{ndx}",
                    SparseConvTranspose(out_channels, out_channels))
            setattr(self, f"lateral{ndx}",
                    SparseConv(lateral_c[-ndx - 1], out_channels, 1))

    @staticmethod
    def _bn_relu(sv: SparseVoxels, bn: MaskedBatchNorm) -> SparseVoxels:
        return sv.replace(feats=bn(sv.feats, sv.mask).relu())

    def forward(self, sv: SparseVoxels
                ) -> Tuple[SparseVoxels, object, List[Keyed]]:
        n = self.n_stages
        sv, keys = sort_by_key(sv)
        sv, keys = self.conv0(sv, keys)
        sv = self._bn_relu(sv, self.bn0)
        laterals = []
        out_maps = []
        for i, (down, down_bn, blocks) in enumerate(self.stages):
            sv, keys = down(sv, keys)
            sv = self._bn_relu(sv, down_bn)
            table = build_k3_table(sv, keys)  # shared by the level's blocks
            for blk in blocks:
                sv, keys = blk(sv, keys, table)
            if n - 1 - self.ntd <= i < n - 1:
                laterals.append((sv, keys))
            out_maps.append((sv, keys))
        sv, keys = self.lateral_top(sv, keys)
        out_maps[-1] = (sv, keys)
        for ndx in range(self.ntd):
            fine, fine_keys = laterals[-ndx - 1]
            up = getattr(self, f"tconv{ndx}")(sv, keys, fine.coords,
                                              fine.mask, fine.stride)
            lat, _ = getattr(self, f"lateral{ndx}")(fine, fine_keys)
            sv, keys = up.replace(feats=up.feats + lat.feats), fine_keys
            out_maps[-2 - ndx] = (sv, keys)
        return sv, keys, out_maps
