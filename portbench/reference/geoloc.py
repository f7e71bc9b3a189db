"""Plain PyTorch reference of the camera-only cross-view tower: CCT-14/7x2 at
384 px and a NetVLAD head.

CCT as SHI-Labs' ``cct_14_7x2_384`` (Hassani et al., 2021, "Escaping the
Big Data Paradigm with Compact Transformers"): a tokenizer of two bias-free
7x7 / 2 convs (3 -> 64 -> 384), each followed by ReLU and a 3x3 / 2
max-pool (padding 1), the map flattened row by row into tokens, a learnable
positional embedding, then ``layers`` encoder layers of

    src = norm1(src + proj(attention(pre_norm(src))))
    src = src + linear2(gelu(linear1(src)))

(attention: a bias-free fused qkv, ``heads`` heads, softmax(q k^T * d^-0.5)
v, proj with a bias; LayerNorm eps 1e-5) and a final LayerNorm.  NetVLAD as
the Deep Visual Geo-localization Benchmark's (Berton et al., CVPR 2022):
each descriptor L2-normalised, soft assignment by a bias-free 1x1 conv, for
each cluster the residuals against its centroid weighted by their
assignment and summed, intra-normalisation, L2.  The clusters are taken a
block at a time so that the residuals fit.

One departure: GELU is the tanh form, as the measured program computes it;
SHI-Labs' CCT uses the erf form.

Precision (``precision``, the configuration's compute dtype, or a lower one
for the control):

* the tower's products (the tokenizer convs, qkv, proj, the MLP's two
  layers, QK^T, AV) take operands rounded to ``precision``, accumulate in
  fp32, and round their output to bf16 where ``precision`` is below fp32,
  as a bf16 GEMM returns;
* NetVLAD's two products (the assignment, the aggregation) take the
  descriptors and the assignments rounded to ``precision`` and keep an
  fp32 result; the centroids enter the residuals in fp32;
* LayerNorm, softmax, GELU, ReLU, the max-pools, the residual stream, the
  positional add and every normalisation run in fp32.

Parameters come as a dict keyed by the measured tower's ``state_dict``
names (``mm.`` prefixed).  Nothing here imports the measured program.
"""

from __future__ import annotations

import functools
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.model import round_to

Params = Dict[str, torch.Tensor]
EPS_LN = 1e-5
BACKBONE = "mm.backbone."
VLAD = "mm.aggregation.netvlad."
LOW = ("bfloat16", "fp8")  # precisions whose products return bf16


class TowerProducts(nn.Module):
    """``fn(*operands)`` on operands rounded to ``precision``, the output
    rounded to bf16 below fp32."""

    def __init__(self, precision: str):
        super().__init__()
        self.precision = precision

    def forward(self, fn, *operands):
        y = fn(*(round_to(o, self.precision) for o in operands))
        return self.out(y)

    def out(self, y):
        return round_to(y, "bfloat16") if self.precision in LOW else y


def l2n(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(
        min=1e-12)


class GeoLocReference(nn.Module):
    """The tower's forward over a parameter dict.  ``arch``: ``layers``,
    ``heads`` and ``vlad_block`` (clusters a block)."""

    def __init__(self, precision: str, arch: dict):
        super().__init__()
        self.precision = precision
        self.arch = arch
        self.tower_products = TowerProducts(precision)

    def layer_norm(self, x, P: Params, name: str):
        return F.layer_norm(x, x.shape[-1:], P[name + ".weight"],
                            P[name + ".bias"], EPS_LN)

    def linear(self, x, P: Params, name: str):
        bias = P.get(name + ".bias")
        args = (x, P[name + ".weight"]) + (() if bias is None else (bias,))
        return self.tower_products(F.linear, *args)

    def tokenize(self, P: Params, images) -> torch.Tensor:
        """images [B, H, W, 3] -> tokens [B, N, C]."""
        x = images.permute(0, 3, 1, 2)
        for i in range(2):
            x = self.tower_products(
                functools.partial(F.conv2d, stride=2, padding=3), x,
                P[f"{BACKBONE}tokenizer.conv{i}.weight"])
            x = F.max_pool2d(torch.relu(x), 3, 2, 1)
        return x.flatten(2).transpose(1, 2)

    def encoder_layer(self, t, P: Params, i: int):
        b, n, c = t.shape
        h = self.arch["heads"]
        d = c // h
        name = f"{BACKBONE}%s_{i}"
        qkv = self.linear(self.layer_norm(t, P, name % "pre_norm"), P,
                          name % "qkv")
        q, k, v = qkv.reshape(b, n, 3, h, d).permute(2, 0, 3, 1, 4)
        scores = self.tower_products(torch.matmul, q, k.transpose(-2, -1))
        attn = torch.softmax(self.tower_products.out(scores * d ** -0.5),
                             dim=-1)
        o = self.tower_products(torch.matmul, attn, v)
        o = o.transpose(1, 2).reshape(b, n, c)
        t = self.layer_norm(t + self.linear(o, P, name % "proj"), P,
                            name % "norm1")
        hidden = self.linear(t, P, name % "mlp1")
        return t + self.linear(F.gelu(hidden, approximate="tanh"), P,
                               name % "mlp2")

    def netvlad(self, t, P: Params) -> torch.Tensor:
        """tokens [B, N, C] -> [B, K * C], per cluster."""
        p = self.precision
        x = round_to(l2n(t), p)
        centroids = P[VLAD + "centroids"]
        soft = torch.softmax(x @ round_to(P[VLAD + "assign_w"], p), dim=-1)
        soft = round_to(soft, p)
        kb = self.arch["vlad_block"]
        parts = []
        for k0 in range(0, centroids.shape[0], kb):
            residual = x[:, :, None, :] - centroids[None, None, k0:k0 + kb]
            parts.append(torch.einsum("bnk,bnkc->bkc",
                                      soft[:, :, k0:k0 + kb], residual))
        vlad = l2n(torch.cat(parts, dim=1))
        return l2n(vlad.reshape(vlad.shape[0], -1))

    def encode(self, P: Params, images) -> torch.Tensor:
        """images [B, H, W, 3] (normalised) -> tokens [B, N, C] after the
        final LayerNorm."""
        t = self.tokenize(P, images) + P[BACKBONE + "pos"]
        for i in range(self.arch["layers"]):
            t = self.encoder_layer(t, P, i)
        return self.layer_norm(t, P, BACKBONE + "ln_f")

    def forward(self, P: Params, images) -> torch.Tensor:
        """images [B, H, W, 3] (normalised) -> descriptors [B, K * C]."""
        return self.netvlad(self.encode(P, images), P)


def flops(counts) -> float:
    """Every product's FLOPs from ``FlopCounterMode.get_flop_counts()`` of
    a run of the reference (all of them at the configuration's
    precision)."""
    return float(sum(counts["Global"].values()))
