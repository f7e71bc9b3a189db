"""GeoLocalizationNet (``agplace_tpu/models/geoloc.py``): the DVGLB family
of a backbone (resnet18 / 50 / 101 to conv4 or conv5, VGG16, AlexNet,
ViT-B/16, CCT-14) and an aggregation head (``pooling.GlobalHead``), then an
optional linear layer, with the reference's L2 placements.

JAX's factory gives this tower no dtype, so it runs in fp32 whatever
``compute_dtype`` says.  The port's factory passes the compute dtype on,
and CCT and the NetVLAD head behind it compute their products in it (the
bf16 serving path of ``cct384`` + ``netvlad``); every other backbone and
head, and NetVLAD behind another backbone, stays fp32 as in JAX.  The stem
tail runs unfused: JAX builds these ResNets without ``use_pallas_stem``.

Two sizes are fixed when JAX first traces the tower: ViT's positional
embedding (its token count) and MixVPR's mixer width (the map's h * w).
The port sizes both from ``image_hw`` when it builds the tower (the
factory passes ``q_resize`` or ``db_resize`` squared); an input of another
size raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from agplace_tpu_torch.models.cct import CCT, tokenizer_side
from agplace_tpu_torch.models.layers import (Conv2d, Dense, LayerNorm, gelu,
                                             l2n, max_pool_nhwc)
from agplace_tpu_torch.models.pooling import POOLS, GlobalHead
from agplace_tpu_torch.models.resnet import ResNetFeatures
from agplace_tpu_torch.utils.spans import span

# backbone -> (arch, stages, output width)
RESNET_BACKBONES = {
    "resnet18conv4": ("resnet18", 3, 256),
    "resnet18conv5": ("resnet18", 4, 512),
    "resnet50conv4": ("resnet50", 3, 1024),
    "resnet50conv5": ("resnet50", 4, 2048),
    "resnet101conv4": ("resnet101", 3, 1024),
    "resnet101conv5": ("resnet101", 4, 2048),
}

_VGG16 = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
          512, 512, 512, "M", 512, 512, 512]


class VGG16Features(nn.Module):
    """VGG16's 13 convs and four interior max-pools, ending at conv5_3
    with no relu (DVGLB's ``features[:-2]``)."""

    def __init__(self):
        super().__init__()
        self.layers = []
        c, i = 3, 0
        for v in _VGG16:
            if v == "M":
                self.layers.append(None)
                continue
            setattr(self, f"conv{i}", Conv2d(c, v, 3, 1, 1, True, None))
            self.layers.append(getattr(self, f"conv{i}"))
            c, i = v, i + 1
        self.n_convs = i

    def forward(self, x):
        i = 0
        for conv in self.layers:
            if conv is None:
                x = max_pool_nhwc(x, 2, 2)
                continue
            x = conv(x)
            i += 1
            if i < self.n_convs:
                x = torch.relu(x)
        return x


class AlexNetFeatures(nn.Module):
    """AlexNet's five convs ending at conv4 (256) with no relu and no
    final pool (``features[:-2]``)."""

    def __init__(self):
        super().__init__()
        self.conv0 = Conv2d(3, 64, 11, 4, 2, True, None)
        self.conv1 = Conv2d(64, 192, 5, 1, 2, True, None)
        self.conv2 = Conv2d(192, 384, 3, 1, 1, True, None)
        self.conv3 = Conv2d(384, 256, 3, 1, 1, True, None)
        self.conv4 = Conv2d(256, 256, 3, 1, 1, True, None)

    def forward(self, x):
        x = max_pool_nhwc(torch.relu(self.conv0(x)), 3, 2)
        x = max_pool_nhwc(torch.relu(self.conv1(x)), 3, 2)
        x = torch.relu(self.conv3(torch.relu(self.conv2(x))))
        return self.conv4(x)


class ProjectHeads(nn.Module):
    """flax ``DenseGeneral`` of a ``MultiHeadDotProductAttention``, its
    kernel kept in flax's shape: ``[in, heads, head_dim]`` (query, key,
    value; ``heads_in`` False) or ``[heads, head_dim, out]`` (out)."""

    def __init__(self, shape: Tuple[int, int, int], heads_in: bool):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.zeros(
            shape[2:] if heads_in else shape[1:]))
        self.heads_in = heads_in
        fan_in = shape[0] * shape[1] if heads_in else shape[0]
        self.init_std = {"kernel": fan_in ** -0.5}

    def forward(self, x):
        k = self.kernel.to(x.dtype)
        if self.heads_in:  # [B, N, H, D] -> [B, N, out]
            return torch.einsum("bnhd,hdo->bno", x, k) + self.bias
        return torch.einsum("bnc,chd->bnhd", x, k) + self.bias


class Attention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (self-attention, no dropout):
    q scaled by 1/sqrt(head_dim) before the product."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        hd = dim // heads
        self.query = ProjectHeads((dim, heads, hd), False)
        self.key = ProjectHeads((dim, heads, hd), False)
        self.value = ProjectHeads((dim, heads, hd), False)
        self.out = ProjectHeads((heads, hd, dim), True)
        self.scale = hd ** -0.5

    def forward(self, x):
        q = self.query(x) * self.scale
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, self.key(x)),
                          dim=-1)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, self.value(x)))


class ViTBackbone(nn.Module):
    """ViT-B/16 tokens [B, 1 + N, C], CLS first; ``trunc_te`` keeps the
    first encoder layers.  LayerNorm eps 1e-12 (HF ViT's)."""

    def __init__(self, image_hw=(224, 224), hidden: int = 768,
                 layers: int = 12, heads: int = 12, patch: int = 16,
                 trunc_te: Optional[int] = None, ln_eps: float = 1e-12):
        super().__init__()
        self.embed = Conv2d(3, hidden, patch, patch, 0, True, None)
        n = (image_hw[0] // patch) * (image_hw[1] // patch) + 1
        self.cls = nn.Parameter(torch.zeros(1, 1, hidden))
        self.pos = nn.Parameter(torch.empty(1, n, hidden))
        self.init_std = {"cls": 0.0, "pos": 0.02}
        self.n_layers = trunc_te or layers
        for i in range(self.n_layers):
            setattr(self, f"ln1_{i}", LayerNorm(hidden, ln_eps))
            setattr(self, f"attn_{i}", Attention(hidden, heads))
            setattr(self, f"ln2_{i}", LayerNorm(hidden, ln_eps))
            setattr(self, f"mlp1_{i}", Dense(hidden, 4 * hidden))
            setattr(self, f"mlp2_{i}", Dense(4 * hidden, hidden))
        self.ln_f = LayerNorm(hidden, ln_eps)

    def forward(self, x):
        b = x.shape[0]
        x = self.embed(x)
        x = x.reshape(b, -1, x.shape[-1])
        x = torch.cat([self.cls.expand(b, -1, -1).to(x.dtype), x], dim=1)
        if x.shape[1] != self.pos.shape[1]:
            raise ValueError(f"{x.shape[1]} tokens; the positional "
                             f"embedding was sized for {self.pos.shape[1]}")
        x = x + self.pos
        for i in range(self.n_layers):
            x = x + getattr(self, f"attn_{i}")(getattr(self, f"ln1_{i}")(x))
            y = getattr(self, f"mlp1_{i}")(getattr(self, f"ln2_{i}")(x))
            x = x + getattr(self, f"mlp2_{i}")(gelu(y))
        return self.ln_f(x)


def backbone_output_dim(backbone: str) -> int:
    if backbone in RESNET_BACKBONES:
        return RESNET_BACKBONES[backbone][2]
    dims = {"vgg16": 512, "alexnet": 256, "vit": 768, "cct384": 384}
    if backbone not in dims:
        raise NotImplementedError(backbone)
    return dims[backbone]


def _down(size: int, k: int, s: int, p: int) -> int:
    return (size + 2 * p - k) // s + 1


def feature_side(backbone: str, size: int) -> int:
    """The side of the backbone's map (ViT, CCT: of the square token map
    the heads see) for an input side ``size``."""
    if backbone in RESNET_BACKBONES:
        size = _down(_down(size, 7, 2, 3), 3, 2, 1)
        for _ in range(RESNET_BACKBONES[backbone][1] - 1):
            size = _down(size, 3, 2, 1)
        return size
    if backbone == "vgg16":
        return size // 16
    if backbone == "alexnet":
        return _down(_down(_down(size, 11, 4, 2), 3, 2, 0), 3, 2, 0)
    if backbone == "vit":
        return size // 16
    if backbone == "cct384":
        return tokenizer_side(size)
    raise NotImplementedError(backbone)


class GeoLocalizationNet(nn.Module):
    """backbone -> (L2) -> aggregation -> (L2 / linear + L2), for inputs
    of ``image_hw``; returns [B, D] fp32.  ``dtype`` reaches CCT and a
    NetVLAD head behind it (module docstring)."""

    def __init__(self, backbone: str = "resnet18conv4",
                 aggregation: str = "gem", netvlad_clusters: int = 64,
                 fc_output_dim: Optional[int] = None,
                 l2: str = "before_pool", trunc_te: Optional[int] = None,
                 image_hw: Tuple[int, int] = (224, 224),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.backbone_name, self.aggregation_name = backbone, aggregation
        self.l2 = l2
        # the other backbones and heads are built in fp32, as JAX's factory
        dt = dtype if backbone == "cct384" else torch.float32
        if backbone in RESNET_BACKBONES:
            arch, stages, _ = RESNET_BACKBONES[backbone]
            self.backbone = ResNetFeatures(arch, stages)
        elif backbone == "vgg16":
            self.backbone = VGG16Features()
        elif backbone == "alexnet":
            self.backbone = AlexNetFeatures()
        elif backbone == "vit":
            self.backbone = ViTBackbone(image_hw, trunc_te=trunc_te)
        elif backbone == "cct384":
            self.backbone = CCT(image_hw, num_layers=trunc_te or 14,
                                dtype=dt)
        else:
            raise NotImplementedError(backbone)
        # the token backbones' own pooled outputs end the tower
        self.tokens_out = (backbone == "vit" and aggregation == "cls") or (
            backbone == "cct384" and aggregation in ("seqpool", "cls"))
        dim = backbone_output_dim(backbone)
        self.out_dim = dim
        if self.tokens_out:
            return
        h, w = (feature_side(backbone, s) for s in image_hw)
        if backbone in ("vit", "cct384"):  # the square token map
            h = w = int((h * w) ** 0.5)
        self.aggregation = GlobalHead(aggregation, dim, netvlad_clusters,
                                      hw=h * w, dtype=dt)
        self.out_dim = self._head_dim(aggregation, dim, netvlad_clusters,
                                      h, w)
        self.has_fc = fc_output_dim is not None
        if self.has_fc:
            self.fc = Dense(self.out_dim, fc_output_dim)
            self.out_dim = fc_output_dim

    @staticmethod
    def _head_dim(agg, dim, clusters, h, w) -> int:
        if agg == "convap":  # the 2 x 2 pool's cells, unpadded
            return dim * _down(h, h // 2, h // 2, 0) * _down(w, w // 2,
                                                             w // 2, 0)
        if agg == "mixvpr":
            return dim * 4
        if agg in ("netvlad", "crn"):
            return dim * clusters
        return dim

    def _square(self, tokens):
        b, n = tokens.shape[0], tokens.shape[1]
        side = int(n ** 0.5)
        return tokens[:, :side * side].reshape(b, side, side, -1)

    def forward(self, x):  # [B, H, W, 3] -> [B, D]
        name = self.backbone_name
        if name in RESNET_BACKBONES:
            feat, _ = self.backbone(x)
        elif name == "vit":
            tokens = self.backbone(x)
            if self.tokens_out:
                return l2n(tokens[:, 0])
            if int((tokens.shape[1] - 1) ** 0.5) ** 2 != tokens.shape[1] - 1:
                raise ValueError("ViT's patch tokens do not form a square "
                                 "map (JAX's reshape fails there too)")
            feat = self._square(tokens[:, 1:])
        elif name == "cct384":
            tokens, pooled = self.backbone(x)
            if self.tokens_out:
                return l2n(pooled)
            feat = self._square(tokens)
        else:
            feat = self.backbone(x)
        with span("geoloc.aggregation"):
            if self.aggregation_name in POOLS:
                if self.l2 == "before_pool":
                    feat = l2n(feat)
                out = self.aggregation(feat)
                if self.l2 == "after_pool":
                    out = l2n(out)
            else:
                out = self.aggregation(feat)
        if self.has_fc:
            out = l2n(self.fc(out))
        return out
