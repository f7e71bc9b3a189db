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
the identity.  The attention core is ``ops/attention.attention_plain``,
the eager einsum / softmax chain, except in bf16 inference, where it goes
to ``ops/attention.fused_attention``: on the card one kernel that keeps
the scores on chip, on the CPU the same eager chain.  In bf16 inference
too, each seam between layers (the residual add of a branch into the
stream, the LayerNorm after it and the rounding of that norm to the next
Dense's operand) is one ``LayerNorm`` call on
``ops/residual_layer_norm.fused_residual_layer_norm``: mlp2's branch is
added by the next layer's ``pre_norm`` (the last one by ``ln_f``), and
``pre_norm`` and ``norm1`` hand their Dense its bf16 operand.  The
stream and the norms stay fp32.

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
from agplace_tpu_torch.ops import attention
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
        self.dtype = dtype
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

    def _fused(self, qkv) -> bool:
        """Whether a layer's attention core goes to
        ``attention.fused_attention`` (the kernel on the card, the eager
        chain on the CPU): bf16 products in inference, where nothing needs
        a gradient.  fp32 (JAX's, and training's), training mode and
        autograd take ``attention.attention_plain``, the eager einsums."""
        return (qkv.dtype == torch.bfloat16 and not self.training
                and not (torch.is_grad_enabled() and qkv.requires_grad))

    def _fused_seams(self, tokens) -> bool:
        """Whether the seams between layers go to
        ``residual_layer_norm.fused_residual_layer_norm`` (``_encode_fused``):
        ``_fused``'s rule, asked before the first product, of the stream
        and every parameter.  Elsewhere ``_encode`` keeps the eager add,
        LayerNorm and cast."""
        return (self.dtype == torch.bfloat16 and not self.training
                and not (torch.is_grad_enabled() and (
                    tokens.requires_grad
                    or any(p.requires_grad for p in self.parameters()))))

    def _attend(self, i, x):
        """Layer i's attention from its normed input: qkv, the core,
        proj; the branch [B, N, C] in the products' dtype."""
        b, n, c = x.shape
        h = self.heads
        qkv = getattr(self, f"qkv_{i}")(x).reshape(b, n, 3, h, c // h)
        with span("geoloc.attn"):
            y = (attention.fused_attention(qkv) if self._fused(qkv)
                 else attention.attention_plain(qkv))
        return getattr(self, f"proj_{i}")(y.reshape(b, n, c))

    def _mlp(self, i, x):
        return getattr(self, f"mlp2_{i}")(gelu(
            getattr(self, f"mlp1_{i}")(x)))

    def _encode(self, tokens):
        if self._fused_seams(tokens):
            return self._encode_fused(tokens)
        for i in range(self.num_layers):
            if self.training and self.dpr[i] > 0.0:
                raise NotImplementedError(
                    "CCT stochastic depth in training: JAX's train step "
                    "passes no 'dropout' rng and fails here "
                    "(agplace_tpu/models/cct.py:124-129)")
            y = self._attend(i, getattr(self, f"pre_norm_{i}")(tokens))
            tokens = getattr(self, f"norm1_{i}")(tokens + y)
            tokens = tokens + self._mlp(i, tokens)
        return self.ln_f(tokens)

    def _encode_fused(self, tokens):
        """``_encode`` with one LayerNorm call a seam: the same values, the
        stream's add deferred into the next norm, each Dense after a norm
        handed its bf16 operand."""
        y = None  # mlp2's branch, not yet added to the stream
        for i in range(self.num_layers):
            pre = getattr(self, f"pre_norm_{i}")
            if y is None:
                _, a = pre(tokens, stream=None, operand=True)
            else:
                tokens, a = pre(tokens, y, stream="sum", operand=True)
            y = self._attend(i, a)
            tokens, a = getattr(self, f"norm1_{i}")(tokens, y, operand=True)
            y = self._mlp(i, a)
        return self.ln_f(tokens) if y is None else self.ln_f(tokens, y)[0]
