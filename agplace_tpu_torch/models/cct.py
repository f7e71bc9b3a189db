"""Compact Convolutional Transformer, cct_14_7x2_384 (``agplace_tpu/models/
cct.py``): a two-conv 7x7 tokenizer (3 -> 64 -> 384, each conv then relu
then a 3x3 / 2 max-pool), a learnable (or sine) positional embedding, 14
encoder layers of the reference's order (pre-norm attention with a fused
bias-free qkv, a stream LayerNorm, then the MLP with tanh GELU) and
sequence pooling.  The attention's scale follows its product, as JAX's.

``dtype`` is the products' precision: the two tokenizer convs, qkv, proj,
mlp1, mlp2, QK^T and AV take operands in it, accumulate in fp32 and
return it.  LayerNorm, softmax and GELU compute in fp32 (a bf16 input is
widened; a bf16 output is the next product's rounded operand), relu and
the max-pools are exact in either, and the residual stream, the positional
add and the pooling head stay fp32.  At bf16 the scores are rounded once
by their product, and their scale (1/8 at the head size 64) is a power of
two, so scaling them is exact.  At fp32 (JAX's, the default) every cast is
the identity.

Stochastic depth draws, in JAX, from a ``dropout`` rng that its train step
never passes, so JAX fails to train CCT at two layers or more (the rate of
layer 0 is 0).  The port refuses there too: a training forward through a
layer with a non-zero rate raises.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from agplace_tpu_torch.models.layers import (Conv2d, Dense, LayerNorm, gelu,
                                             max_pool_nhwc)
from agplace_tpu_torch.utils.spans import span


def sinusoidal_embedding(n_channels: int, dim: int) -> np.ndarray:
    """CCT's fixed sine positional embedding, [1, n_channels, dim]."""
    pe = np.array([
        [p / (10000 ** (2 * (i // 2) / dim)) for i in range(dim)]
        for p in range(n_channels)
    ])
    pe[:, 0::2] = np.sin(pe[:, 0::2])
    pe[:, 1::2] = np.cos(pe[:, 1::2])
    return pe[None].astype(np.float32)


def tokenizer_side(size: int, n_conv_layers: int = 2) -> int:
    """The tokenizer's output side for an input side: each layer's conv
    (k7 s2 p3) and max-pool (k3 s2 p1) take ceil(size / 2)."""
    for _ in range(2 * n_conv_layers):
        size = (size - 1) // 2 + 1
    return size


class CCTTokenizer(nn.Module):
    def __init__(self, embed_dim: int = 384, kernel_size: int = 7,
                 stride: int = 2, n_conv_layers: int = 2,
                 in_planes: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        ch = [3] + [in_planes] * (n_conv_layers - 1) + [embed_dim]
        self.convs = []
        for i in range(n_conv_layers):
            setattr(self, f"conv{i}", Conv2d(ch[i], ch[i + 1], kernel_size,
                                             stride, kernel_size // 2,
                                             False, dtype))
            self.convs.append(getattr(self, f"conv{i}"))

    def forward(self, x):
        for conv in self.convs:
            x = max_pool_nhwc(torch.relu(conv(x)), 3, 2, 1)
        b, h, w, c = x.shape
        return x.reshape(b, h * w, c)


class CCT(nn.Module):
    """Returns (tokens [B, N, C], the sequence-pooled vector [B, C]), both
    fp32, for inputs of ``image_hw`` (the learnable embedding's size), its
    products in ``dtype``."""

    def __init__(self, image_hw=(224, 224), embed_dim: int = 384,
                 num_layers: int = 14, num_heads: int = 6,
                 mlp_ratio: float = 3.0, stochastic_depth: float = 0.1,
                 positional_embedding: str = "learnable",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = embed_dim
        self.heads, self.num_layers = num_heads, num_layers
        self.tokenizer = CCTTokenizer(c, dtype=dtype)
        n = tokenizer_side(image_hw[0]) * tokenizer_side(image_hw[1])
        if positional_embedding == "learnable":
            self.pos = nn.Parameter(torch.empty(1, n, c))
            self.init_std = {"pos": 0.2}
        else:
            self.register_buffer("pos", torch.from_numpy(
                sinusoidal_embedding(n, c)), persistent=False)
        self.dpr = np.linspace(0, stochastic_depth, num_layers)
        hidden = int(c * mlp_ratio)
        for i in range(num_layers):
            setattr(self, f"pre_norm_{i}", LayerNorm(c, 1e-5))
            setattr(self, f"qkv_{i}", Dense(c, 3 * c, False, dtype))
            setattr(self, f"proj_{i}", Dense(c, c, dtype=dtype))
            setattr(self, f"norm1_{i}", LayerNorm(c, 1e-5))
            setattr(self, f"mlp1_{i}", Dense(c, hidden, dtype=dtype))
            setattr(self, f"mlp2_{i}", Dense(hidden, c, dtype=dtype))
        self.ln_f = LayerNorm(c, 1e-5)
        self.attention_pool = Dense(c, 1)

    def forward(self, x):
        with span("geoloc.tokenizer"):
            tokens = self.tokenizer(x)
        b, n, c = tokens.shape
        if n != self.pos.shape[1]:
            raise ValueError(f"{n} tokens; the positional embedding was "
                             f"sized for {self.pos.shape[1]}")
        with span("geoloc.encoder"):
            tokens = self._encode(tokens.float() + self.pos)
        attn = torch.softmax(self.attention_pool(tokens), dim=1)
        return tokens, (attn * tokens).sum(dim=1)

    def _encode(self, tokens):
        b, n, c = tokens.shape
        h = self.heads
        hd = c // h
        scale = hd ** -0.5
        for i in range(self.num_layers):
            if self.training and self.dpr[i] > 0.0:
                raise NotImplementedError(
                    "CCT stochastic depth in training: JAX's train step "
                    "passes no 'dropout' rng and fails here "
                    "(agplace_tpu/models/cct.py:124-129)")
            y = getattr(self, f"pre_norm_{i}")(tokens)
            qkv = getattr(self, f"qkv_{i}")(y).reshape(b, n, 3, h, hd)
            q, k, v = qkv.unbind(dim=2)
            with span("geoloc.attn"):
                attn = torch.softmax(torch.einsum(
                    "bnhd,bmhd->bhnm", q, k) * scale, dim=-1)
                y = torch.einsum("bhnm,bmhd->bnhd", attn, v)
            y = getattr(self, f"proj_{i}")(y.reshape(b, n, c))
            tokens = getattr(self, f"norm1_{i}")(tokens + y)
            y = getattr(self, f"mlp2_{i}")(gelu(
                getattr(self, f"mlp1_{i}")(tokens)))
            tokens = tokens + y
        return self.ln_f(tokens)
