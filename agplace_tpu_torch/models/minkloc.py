"""The MinkLoc family (``agplace_tpu/models/minkloc.py``) on the port's
sparse backend (``sparse/``):

* ``MinkLoc``: the sparse FPN -> GeM / MAC / SPoC -> optional LayerNorm
  (eps 1e-6), relu and linear layer, over ``SparseVoxels``;
* ``ResnetFPN``: a ResNet's stages, lateral 1x1 convs and 2x2 / 2
  transposed convs top-down, pooled to one vector;
* ``MinkLocMultimodal``: a MinkLoc cloud descriptor and a ResnetFPN image
  descriptor, concatenated (or added);
* ``ExtraBlock``: a strided sparse conv widening to ``num_heads`` x C,
  GeM-pooled to [B, num_heads, C].

JAX's factory gives these towers no dtype: the image branch runs in fp32,
the sparse convs in their own bf16 compute dtype, as JAX's do.  JAX builds
their ResNets without ``use_pallas_stem``, and so does the port.  The
dropout option (``dropout_p``) in training needs a ``dropout`` rng that
JAX's train step never passes; the port refuses it there.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from agplace_tpu_torch.data.voxels import SparseVoxels
from agplace_tpu_torch.models.layers import Conv2d, Dense, LayerNorm
from agplace_tpu_torch.models.pooling import GeM
from agplace_tpu_torch.models.resnet import ResNetFeatures
from agplace_tpu_torch.sparse.minkfpn import MinkFPN
from agplace_tpu_torch.sparse.modules import MinkGeM, SparseConv
from agplace_tpu_torch.sparse.voxels import (masked_global_avg,
                                             masked_global_max)


class ExtraBlock(nn.Module):
    def __init__(self, in_features: int, num_heads: int = 4,
                 kernel_size: int = 2, stride: int = 2):
        super().__init__()
        self.in_features, self.num_heads = in_features, num_heads
        self.conv = SparseConv(in_features, num_heads * in_features,
                               kernel_size, stride)
        self.gem = MinkGeM()

    def forward(self, sv: SparseVoxels, keys):
        out, _ = self.conv(sv, keys)
        return self.gem(out).reshape(-1, self.num_heads, self.in_features)


class MinkLoc(nn.Module):
    def __init__(self, feature_size: int = 256, output_dim: int = 256,
                 planes: Tuple[int, ...] = (32, 64, 64),
                 layers: Tuple[int, ...] = (1, 1, 1), num_top_down: int = 1,
                 conv0_kernel_size: int = 5, block: str = "eca",
                 pooling_method: str = "GeM", linear_block: bool = False,
                 dropout_p: Optional[float] = None):
        super().__init__()
        if pooling_method not in ("GeM", "MAC", "SPoC"):
            raise NotImplementedError(pooling_method)
        self.backbone = MinkFPN(1, feature_size, planes, layers,
                                num_top_down, conv0_kernel_size, block)
        self.pooling_method = pooling_method
        if pooling_method == "GeM":
            self.pooling = MinkGeM()
        self.dropout_p = dropout_p
        self.linear_block = linear_block
        if linear_block:
            self.ln = LayerNorm(feature_size, eps=1e-6)
            self.linear = Dense(feature_size, output_dim)
        self.out_dim = output_dim if linear_block else feature_size

    def forward(self, vox: SparseVoxels) -> torch.Tensor:
        feat_map, _, _ = self.backbone(vox)
        if self.pooling_method == "GeM":
            x = self.pooling(feat_map)
        elif self.pooling_method == "MAC":
            x = masked_global_max(feat_map)
        else:
            x = masked_global_avg(feat_map)
        if self.dropout_p is not None and self.training:
            raise NotImplementedError(
                "MinkLoc dropout in training: JAX's train step passes no "
                "'dropout' rng and fails there")
        if self.linear_block:
            x = self.linear(torch.relu(self.ln(x)))
        return x


class ConvTranspose2x2(nn.Module):
    """flax ``nn.ConvTranspose(features, (2, 2), strides=(2, 2))`` on NHWC:
    output pixel (2i + a, 2j + c) = x[i, j] @ kernel[1 - a, 1 - c] + bias
    (flax's transposed conv does not flip its kernel).  ``kernel`` keeps
    flax's [2, 2, Cin, Cout]."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(2, 2, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.init_std = {"kernel": (4 * cin) ** -0.5}

    def forward(self, x):
        b, h, w, _ = x.shape
        y = torch.einsum("bijc,adco->biajdo", x, self.kernel.flip(0, 1))
        return y.reshape(b, 2 * h, 2 * w, -1) + self.bias


class ResnetFPN(nn.Module):
    def __init__(self, out_channels: int = 256, lateral_dim: int = 256,
                 arch: str = "resnet18", fh_num_bottom_up: int = 4,
                 fh_num_top_down: int = 1, add_fc_block: bool = False,
                 pool_method: str = "gem"):
        super().__init__()
        if pool_method not in ("gem", "spoc", "max"):
            raise NotImplementedError(pool_method)
        nb = self.nb = fh_num_bottom_up
        self.ntd, self.pool_method = fh_num_top_down, pool_method
        self.fe = ResNetFeatures(arch, nb)
        dims = [ResNetFeatures.last_dim(arch, s + 1) for s in range(nb)]
        setattr(self, f"lat_{nb}", Conv2d(dims[-1], lateral_dim, 1, 1, 0,
                                          True, None))
        for step in range(fh_num_top_down):
            lvl = nb - 1 - step
            setattr(self, f"tconv_{lvl + 1}",
                    ConvTranspose2x2(lateral_dim, lateral_dim))
            setattr(self, f"lat_{lvl}", Conv2d(dims[lvl - 1], lateral_dim,
                                               1, 1, 0, True, None))
        if pool_method == "gem":
            self.pool = GeM()
        self.add_fc_block = add_fc_block
        if add_fc_block:
            self.fc = Dense(lateral_dim, out_channels)
        self.out_dim = out_channels if add_fc_block else lateral_dim

    def forward(self, x) -> torch.Tensor:  # [B, H, W, 3]
        _, maps = self.fe(x)
        feat = getattr(self, f"lat_{self.nb}")(maps[-1])
        for step in range(self.ntd):
            lvl = self.nb - 1 - step
            feat = getattr(self, f"tconv_{lvl + 1}")(feat)
            feat = feat + getattr(self, f"lat_{lvl}")(maps[lvl - 1])
        if self.pool_method == "gem":
            v = self.pool(feat)
        elif self.pool_method == "spoc":
            v = feat.mean(dim=(1, 2))
        else:
            v = feat.amax(dim=(1, 2))
        return self.fc(v) if self.add_fc_block else v


class MinkLocMultimodal(nn.Module):
    """(vox, image) -> {"embedding", "cloud_embedding",
    "image_embedding"}; either input may be None."""

    def __init__(self, cloud_fe_size: int = 256, image_fe_size: int = 256,
                 output_dim: int = 512, fuse_method: str = "concat"):
        super().__init__()
        if fuse_method not in ("concat", "add"):
            raise NotImplementedError(fuse_method)
        self.fuse_method = fuse_method
        self.cloud_fe = MinkLoc(cloud_fe_size, cloud_fe_size)
        self.image_fe = ResnetFPN(image_fe_size, image_fe_size)
        self.out_dim = (cloud_fe_size + image_fe_size
                        if fuse_method == "concat" else cloud_fe_size)

    def forward(self, vox: Optional[SparseVoxels], image):
        cloud_v = self.cloud_fe(vox) if vox is not None else None
        image_v = self.image_fe(image) if image is not None else None
        if cloud_v is not None and image_v is not None:
            fused = (torch.cat([cloud_v, image_v], dim=-1)
                     if self.fuse_method == "concat" else cloud_v + image_v)
        else:
            fused = cloud_v if cloud_v is not None else image_v
        return {"embedding": fused, "cloud_embedding": cloud_v,
                "image_embedding": image_v}
