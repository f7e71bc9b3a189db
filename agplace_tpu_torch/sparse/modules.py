"""Sparse conv / norm / attention layers over ``SparseVoxels``
(``agplace_tpu/sparse/modules.py``): the generalized sparse convolution as
gather -> GEMM -> accumulate over a neighbour table, masked batch norm, ECA,
GeM, and the FPN blocks (ECA basic, basic, ASPP, ConvNeXt).

The gather-GEMM is a plain product, as JAX computes it outside any Pallas
kernel.  ``sparse_conv_apply`` keeps JAX's chunking of the offsets under
``_GATHER_BUDGET_ELEMS`` and its fp32 accumulation across chunks: the
gathered rows and the kernel are rounded to ``compute_dtype`` and
multiplied as fp32 (bf16 products are exact there), so the bf16 sums round
where JAX's do.  The 1x1 convs multiply the feats as they are, in fp32.

Parameter names follow flax (``kernel`` [K, Cin, Cout] or [Cin, Cout] for
1x1; norms ``weight`` / ``bias`` / ``running_mean`` / ``running_var``;
ECA ``conv_w``; GeM ``p``), so ``utils.convert`` carries JAX's trees over.
Modules read ``compute_dtype`` at call time: setting it to fp32 on a built
model gives the fp32-conv twin.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from agplace_tpu_torch.data.voxels import SparseVoxels
from agplace_tpu_torch.models.norm import BatchNorm2D, masked_moments
from agplace_tpu_torch.sparse.voxels import (build_neighbor_table,
                                             build_point_grid,
                                             downsample_coords, grid_lookup,
                                             kernel_offsets,
                                             masked_global_avg, pack_coords)

Keyed = Tuple[SparseVoxels, torch.Tensor]


def _mask(feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask[..., None], feats, 0.0)


def gather_neighbors(feats: torch.Tensor, table: torch.Tensor,
                     k: int) -> torch.Tensor:
    """feats [B, N, C], table [B, No, K] -> the rows at offset ``k``
    [B, No, C], zero where the neighbour is absent."""
    idx = table[:, :, k].long()
    g = torch.gather(feats, 1, idx.clamp(min=0)[..., None].expand(
        -1, -1, feats.shape[-1]))
    return torch.where((idx >= 0)[..., None], g, 0.0)


_GATHER_BUDGET_ELEMS = 256 * 1024 * 1024  # cap the [B,No,Kc,Cin] im2col buf


def sparse_conv_apply(feats: torch.Tensor, table: torch.Tensor,
                      kernel: torch.Tensor,
                      compute_dtype: torch.dtype = torch.bfloat16
                      ) -> torch.Tensor:
    """feats [B, N, Cin], table [B, No, K], kernel [K, Cin, Cout] ->
    [B, No, Cout] in the feats dtype.  Each chunk of offsets is one gather
    (a flattened row index; absent neighbours read an appended zero row)
    and one product, accumulated in fp32."""
    k_all, cin, cout = kernel.shape
    b, no, _ = table.shape
    n = feats.shape[1]
    in_dtype = feats.dtype
    rows = torch.cat([feats.to(compute_dtype).reshape(b * n, cin),
                      feats.new_zeros((1, cin), dtype=compute_dtype)])
    kern = kernel.to(compute_dtype).float()
    base = (torch.arange(b, device=table.device) * n)[:, None, None]
    chunk = max(1, min(k_all, _GATHER_BUDGET_ELEMS // max(b * no * cin, 1)))
    out = torch.zeros((b * no, cout), dtype=torch.float32,
                      device=feats.device)
    for s in range(0, k_all, chunk):
        kc = min(chunk, k_all - s)
        idx = table[:, :, s:s + kc].long()
        flat = torch.where(idx >= 0, idx + base, b * n).reshape(-1)
        g = rows.index_select(0, flat).float().reshape(b * no, kc * cin)
        out = out + g @ kern[s:s + kc].reshape(kc * cin, cout)
    return out.reshape(b, no, cout).to(in_dtype)


class SparseConv(nn.Module):
    """``ME.MinkowskiConvolution``: stride 1 keeps the (key-sorted) input
    coordinates; stride 2 takes the distinct floor-aligned coarser ones
    (ascending), at the same capacity.  1x1 kernels are [Cin, Cout]."""

    def __init__(self, cin: int, features: int, kernel_size: int = 3,
                 stride: int = 1,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.k, self.s = kernel_size, stride
        self.pointwise = kernel_size == 1 and stride == 1
        self.kernel = nn.Parameter(torch.empty(
            *((cin, features) if self.pointwise
              else (kernel_size ** 3, cin, features))))
        self.compute_dtype = compute_dtype

    def forward(self, sv: SparseVoxels, sorted_keys: torch.Tensor,
                table: Optional[torch.Tensor] = None) -> Keyed:
        if self.pointwise:
            dt = torch.promote_types(sv.feats.dtype, self.kernel.dtype)
            out = (sv.feats.to(dt) @ self.kernel.to(dt)).float()
            return sv.replace(feats=_mask(out, sv.mask)), sorted_keys
        if self.s == 1:
            out_coords, out_mask, out_stride = sv.coords, sv.mask, sv.stride
        else:
            out_coords, out_mask = downsample_coords(sv, self.s)
            out_stride = sv.stride * self.s
        if table is None:
            table = build_neighbor_table(
                sv, sorted_keys, out_coords, out_mask,
                kernel_offsets(self.k, sv.stride, sv.coords.device))
        out = sparse_conv_apply(sv.feats, table, self.kernel,
                                self.compute_dtype)
        out_sv = SparseVoxels(coords=out_coords, feats=_mask(out, out_mask),
                              mask=out_mask, stride=out_stride)
        if self.s == 1:
            return out_sv, sorted_keys
        return out_sv, pack_coords(out_coords, out_mask)


class SparseConvTranspose(nn.Module):
    """``ME.MinkowskiConvolutionTranspose`` (k=2, s=2) for the FPN top-down
    pass: each fine coordinate reads its coarse parent through the kernel
    tap of its offset in the parent cell (kernel [8, Cin, Cout], tap
    ``4 dx + 2 dy + dz``)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(8, cin, features))

    def forward(self, coarse: SparseVoxels, coarse_keys: torch.Tensor,
                fine_coords: torch.Tensor, fine_mask: torch.Tensor,
                fine_stride: int) -> SparseVoxels:
        del coarse_keys
        step = coarse.stride
        parent = torch.div(fine_coords, step, rounding_mode="floor") * step
        grid = build_point_grid(coarse.coords, coarse.mask)
        idx = grid_lookup(grid, parent, fine_mask).long()
        cin = coarse.channels
        g = torch.gather(coarse.feats, 1, idx.clamp(min=0)[..., None].expand(
            -1, -1, cin))
        g = torch.where((idx >= 0)[..., None], g, 0.0)
        off = torch.div(fine_coords - parent, fine_stride,
                        rounding_mode="floor")
        tap = (off[..., 0] * 4 + off[..., 1] * 2 + off[..., 2]).long()
        live = (tap >= 0) & (tap < 8) & fine_mask  # JAX: no tap matches
        tap = tap.clamp(0, 7)
        cout = self.kernel.shape[-1]
        dt = torch.promote_types(g.dtype, self.kernel.dtype)
        # every tap's product, then each row's own: one wide GEMM
        wide = g.to(dt) @ self.kernel.to(dt).permute(1, 0, 2).reshape(
            cin, 8 * cout)
        out = torch.gather(wide.reshape(*tap.shape, 8, cout).float(), -2,
                           tap[..., None, None].expand(
                               *tap.shape, 1, cout))[..., 0, :]
        return SparseVoxels(coords=fine_coords,
                            feats=_mask(out, live).to(g.dtype),
                            mask=fine_mask, stride=fine_stride)


class MaskedBatchNorm(BatchNorm2D):
    """``ME.MinkowskiBatchNorm``: statistics over the valid rows of the
    batch (training), ``(x - mean) * rsqrt(var + eps) * scale + bias`` in
    fp32, zero at the padding."""

    def forward(self, feats: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean, var = masked_moments(feats, mask[..., None], (0, 1),
                                       self.group)
            self.track(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps)
        out = (feats - mean) * inv * self.weight + self.bias
        return _mask(out, mask)


def eca_kernel_size(channels: int, gamma: float = 2.0, b: float = 1.0
                    ) -> int:
    t = int(abs((math.log2(channels) + b) / gamma))
    return t if t % 2 else t + 1


def eca_gate(y: torch.Tensor, conv_w: torch.Tensor) -> torch.Tensor:
    """sigmoid of the zero-padded 1-D channel conv of pooled ``y`` [B, C]
    (fp32) with ``conv_w`` [k, 1, 1]."""
    k = conv_w.shape[0]
    y = F.conv1d(y.float()[:, None, :], conv_w.float().reshape(1, 1, k),
                 padding=(k - 1) // 2)
    return torch.sigmoid(y[:, 0])


class ECALayer(nn.Module):
    """Efficient channel attention: masked average, 1-D channel conv,
    sigmoid, multiply, zero at the padding."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv_w = nn.Parameter(torch.empty(eca_kernel_size(channels),
                                               1, 1))

    def forward(self, sv: SparseVoxels) -> SparseVoxels:
        y = eca_gate(masked_global_avg(sv), self.conv_w)
        return sv.replace(feats=_mask(sv.feats * y[:, None, :].to(
            sv.feats.dtype), sv.mask))


def build_k3_table(sv: SparseVoxels, sorted_keys: torch.Tensor
                   ) -> torch.Tensor:
    """The k=3 neighbour table of a set on itself, shared by the stride-1
    k=3 convs of a level."""
    return build_neighbor_table(sv, sorted_keys, sv.coords, sv.mask,
                                kernel_offsets(3, sv.stride,
                                               sv.coords.device))


class _Residual(nn.Module):
    """conv1 -> norm1 -> relu -> conv2 -> norm2 (-> ECA), plus the
    identity or a 1x1 + BN downsample; relu; zero at the padding."""

    def __init__(self, cin: int, planes: int, eca: bool):
        super().__init__()
        self.conv1 = SparseConv(cin, planes, 3)
        self.norm1 = MaskedBatchNorm(planes)
        self.conv2 = SparseConv(planes, planes, 3)
        self.norm2 = MaskedBatchNorm(planes)
        if eca:
            self.eca = ECALayer(planes)
        self.use_eca = eca
        self.need_ds = cin != planes
        if self.need_ds:
            self.downsample_conv = SparseConv(cin, planes, 1)
            self.downsample_bn = MaskedBatchNorm(planes)

    def forward(self, sv: SparseVoxels, sorted_keys: torch.Tensor,
                table: Optional[torch.Tensor] = None) -> Keyed:
        if table is None:
            table = build_k3_table(sv, sorted_keys)
        out, _ = self.conv1(sv, sorted_keys, table)
        out = out.replace(feats=torch.relu(self.norm1(out.feats, out.mask)))
        out, _ = self.conv2(out, sorted_keys, table)
        out = out.replace(feats=self.norm2(out.feats, out.mask))
        if self.use_eca:
            out = self.eca(out)
        residual = sv
        if self.need_ds:
            residual, _ = self.downsample_conv(residual, sorted_keys)
            residual = residual.replace(feats=self.downsample_bn(
                residual.feats, residual.mask))
        feats = torch.relu(out.feats + residual.feats)
        return sv.replace(feats=_mask(feats, sv.mask)), sorted_keys


class ECABasicBlock(_Residual):
    """ME BasicBlock with ECA after conv2."""

    def __init__(self, cin: int, planes: int):
        super().__init__(cin, planes, eca=True)


class SparseBasicBlock(_Residual):
    """Plain ME BasicBlock."""

    def __init__(self, cin: int, planes: int):
        super().__init__(cin, planes, eca=False)


class MinkGeM(nn.Module):
    """GeM over the valid rows: clamp(eps) ** p, masked mean, ** (1/p)."""

    def __init__(self, p_init: float = 3.0, eps: float = 1e-6):
        super().__init__()
        self.p = nn.Parameter(torch.full((1,), p_init))
        self.eps = eps

    def forward(self, sv: SparseVoxels) -> torch.Tensor:
        clamped = torch.clamp(sv.feats, min=self.eps) ** self.p
        return masked_global_avg(sv.replace(feats=clamped)) ** (1.0 / self.p)


class SparseASPP(nn.Module):
    """Three parallel convs (k = 3, 5, 7), each BN + relu, summed."""

    def __init__(self, cin: int, planes: int):
        super().__init__()
        for i, k in enumerate((3, 5, 7)):
            setattr(self, f"conv{i + 1}", SparseConv(cin, planes, k))
            setattr(self, f"bn{i + 1}", MaskedBatchNorm(planes))

    def forward(self, sv: SparseVoxels, sorted_keys: torch.Tensor,
                table: Optional[torch.Tensor] = None) -> Keyed:
        feats = None
        for i in (1, 2, 3):
            conv = getattr(self, f"conv{i}")
            o, _ = conv(sv, sorted_keys, table if conv.k == 3 else None)
            r = torch.relu(getattr(self, f"bn{i}")(o.feats, o.mask))
            feats = r if feats is None else feats + r
        return sv.replace(feats=_mask(feats, sv.mask)), sorted_keys


class SparseConvNextBlock(nn.Module):
    """conv k -> BN -> 1x1 expand 4x -> relu -> 1x1 project, plus the
    identity (a 1x1 when the channels change); no final relu."""

    def __init__(self, cin: int, planes: int, kernel_size: int = 3):
        super().__init__()
        self.conv1 = SparseConv(cin, planes, kernel_size)
        self.bn = MaskedBatchNorm(planes)
        self.conv2 = SparseConv(planes, 4 * planes, 1)
        self.conv3 = SparseConv(4 * planes, planes, 1)
        self.need_ds = cin != planes
        if self.need_ds:
            self.downsample_conv = SparseConv(cin, planes, 1)

    def forward(self, sv: SparseVoxels, sorted_keys: torch.Tensor,
                table: Optional[torch.Tensor] = None) -> Keyed:
        out, _ = self.conv1(sv, sorted_keys, table)
        out = out.replace(feats=self.bn(out.feats, out.mask))
        out, _ = self.conv2(out, sorted_keys)
        out = out.replace(feats=torch.relu(out.feats))
        out, _ = self.conv3(out, sorted_keys)
        residual = sv
        if self.need_ds:
            residual, _ = self.downsample_conv(residual, sorted_keys)
        feats = out.feats + residual.feats
        return sv.replace(feats=_mask(feats, sv.mask)), sorted_keys


BLOCKS = {"eca": ECABasicBlock, "basic": SparseBasicBlock,
          "aspp": SparseASPP, "convnext": SparseConvNextBlock}
