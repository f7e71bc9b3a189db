"""Masked dense-grid voxel backend (``agplace_tpu/sparse/dense_grid.py``):
the MinkFPN on a clamped [X, Y, Z] grid with features zeroed at empty cells
and masks re-applied after every biased op, which equals the generalized
sparse conv on the occupied set.

Representation:
    feats [B, X, Y, Z, C]   (zeros at empty cells)
    mask  [B, X, Y, Z] bool
Cell (i, j, k) holds the voxel of quantised coordinate
(i - X//2, j - Y//2, k - Z//2) * stride.

The convs are cuDNN's, as JAX leaves them to XLA: ``F.conv3d`` in
``compute_dtype`` (bf16 on the CPU runs as an fp32 conv of the rounded
operands, rounded once), and JAX's z-folded route where Z <= k//2 + 1 (a
2-D conv of the folded grid with ``bev_grid``'s block-banded kernel).
Kernels keep the flax shape [k, k, k, cin, cout]: the tree is the BEV
backend's, so weights carry over unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from agplace_tpu_torch.data.voxels import SparseVoxels, me_down_align
from agplace_tpu_torch.models.norm import BatchNorm2D, masked_moments
from agplace_tpu_torch.sparse.bev_grid import (_ConvParam, _ECAParam,
                                               bev_conv2d, mask_down)
from agplace_tpu_torch.sparse.modules import eca_gate
from agplace_tpu_torch.sparse.voxels import check_top_down

DEFAULT_EXTENT = (128, 128, 16)


@dataclasses.dataclass
class DenseVoxelGrid:
    feats: torch.Tensor  # [B, X, Y, Z, C]
    mask: torch.Tensor  # [B, X, Y, Z] bool
    stride: int = 1

    @property
    def channels(self) -> int:
        return self.feats.shape[-1]

    def replace(self, **kw) -> "DenseVoxelGrid":
        return dataclasses.replace(self, **kw)


def mask_grid(feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask[..., None], feats, 0.0)


def densify(sv: SparseVoxels, extent: Tuple[int, int, int] = DEFAULT_EXTENT,
            ones_feats: bool = False) -> DenseVoxelGrid:
    """SparseVoxels -> dense grid by one scatter.  Coordinates outside the
    extent are clamped to the boundary cell, where their features add up;
    padding rows go to one extra slot, dropped.  ``ones_feats``: every valid
    feature is the constant 1, so the features are the occupancy."""
    x, y, z = extent
    b, n, _ = sv.coords.shape
    c = torch.div(sv.coords, max(sv.stride, 1), rounding_mode="floor")
    ii = torch.clamp(c[..., 0] + x // 2, 0, x - 1)
    jj = torch.clamp(c[..., 1] + y // 2, 0, y - 1)
    kk = torch.clamp(c[..., 2] + z // 2, 0, z - 1)
    cells = x * y * z
    flat = torch.where(sv.mask, (ii * y + jj) * z + kk, cells).long()
    mask = torch.zeros((b, cells + 1), dtype=torch.bool,
                       device=sv.coords.device)
    mask.scatter_(1, flat, True)
    mask = mask[:, :cells].reshape(b, x, y, z)
    ch = sv.channels
    if ones_feats and ch == 1:
        return DenseVoxelGrid(feats=mask[..., None].to(sv.feats.dtype),
                              mask=mask, stride=sv.stride)
    feats = torch.zeros((b, cells + 1, ch), dtype=sv.feats.dtype,
                        device=sv.feats.device)
    feats.scatter_add_(1, flat[..., None].expand(-1, -1, ch), sv.feats)
    return DenseVoxelGrid(feats=feats[:, :cells].reshape(b, x, y, z, ch),
                          mask=mask, stride=sv.stride)


def grid_global_avg(g: DenseVoxelGrid) -> torch.Tensor:
    """Per-channel mean over occupied cells (fp32 sums) in the feats dtype."""
    m = g.mask[..., None].float()
    s = (g.feats.float() * m).sum(dim=(1, 2, 3))
    n = torch.clamp(m.sum(dim=(1, 2, 3)), min=1.0)
    return (s / n).to(g.feats.dtype)


def grid_global_max(g: DenseVoxelGrid) -> torch.Tensor:
    neg = torch.finfo(g.feats.dtype).min
    return torch.where(g.mask[..., None], g.feats, neg).amax(dim=(1, 2, 3))


def conv3d_ndhwc(x: torch.Tensor, kern: torch.Tensor, stride: int,
                 pads, dtype: torch.dtype) -> torch.Tensor:
    """[B, X, Y, Z, C] conv with a [k, k, k, cin, cout] kernel and per-dim
    (lo, hi) padding, computed and returned in ``dtype``."""
    xc = x.to(dtype).permute(0, 4, 1, 2, 3)
    if all(lo == hi for lo, hi in pads):
        padding = tuple(lo for lo, _ in pads)
    else:
        (x0, x1), (y0, y1), (z0, z1) = pads
        xc = F.pad(xc, (z0, z1, y0, y1, x0, x1))
        padding = 0
    w = kern.to(dtype).permute(4, 3, 0, 1, 2)
    if dtype == torch.bfloat16 and x.device.type == "cpu":
        y = F.conv3d(xc.float(), w.float(), None, stride, padding).to(dtype)
    else:
        y = F.conv3d(xc, w, None, stride, padding)
    return y.permute(0, 2, 3, 4, 1)


class GridConv(_ConvParam):
    """Masked ME-equivalent 3-D conv: odd k at stride 1 (centred, output
    mask = input mask) or k = 2 at stride 2 (ME floor alignment, output
    mask = any child occupied)."""

    def __init__(self, cin: int, features: int, kernel_size: int = 3,
                 stride: int = 1, mask_output: bool = True,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__(kernel_size, cin, features)
        self.k, self.s = kernel_size, stride
        self.mask_output = mask_output
        self.compute_dtype = compute_dtype

    def forward(self, g: DenseVoxelGrid) -> DenseVoxelGrid:
        k, s, cdt = self.k, self.s, self.compute_dtype
        b, x, y, z, cin = g.feats.shape
        cout = self.kernel.shape[-1]
        if k % 2 == 1 and s == 1 and z <= max(k // 2, 1) + 1:
            # JAX's z-fold route: a banded 2-D conv over [X, Y, Z*C]
            pad = (k // 2, k // 2)
            out = bev_conv2d(g.feats.reshape(b, x, y, z * cin),
                             self.folded(z, "s1", cdt), 1, pad, pad, cdt)
            out = out.reshape(b, x, y, z, cout)
            out_mask = g.mask
        elif k % 2 == 1 and s == 1:
            out = conv3d_ndhwc(g.feats, self.kernel, 1, [(k // 2,) * 2] * 3,
                               cdt).to(g.feats.dtype)
            out_mask = g.mask
        elif k == 2 and s == 2:
            pads = [me_down_align(d)[:2] for d in (x, y, z)]
            out = conv3d_ndhwc(g.feats, self.kernel, 2, pads,
                               cdt).to(g.feats.dtype)
            out_mask = mask_down(g.mask, *pads)
        else:
            raise NotImplementedError((k, s))
        if self.mask_output:
            out = mask_grid(out, out_mask)
        return DenseVoxelGrid(feats=out, mask=out_mask, stride=g.stride * s)


class GridBatchNorm(BatchNorm2D):
    """BN over occupied cells (``ME.MinkowskiBatchNorm``), the fp32 affine
    applied in the feats dtype, output masked."""

    def forward(self, g: DenseVoxelGrid) -> DenseVoxelGrid:
        if self.training:
            mean, var = masked_moments(g.feats, g.mask[..., None],
                                       (0, 1, 2, 3), self.group)
            self.track(mean, var)
            s, b = self.batch_affine(mean, var)
        else:
            s, b = self.affine()
        out = g.feats * s.to(g.feats.dtype) + b.to(g.feats.dtype)
        return g.replace(feats=mask_grid(out, g.mask))


class GridECALayer(_ECAParam):
    def forward(self, g: DenseVoxelGrid) -> DenseVoxelGrid:
        y = eca_gate(grid_global_avg(g), self.conv_w)
        feats = g.feats * y[:, None, None, None, :].to(g.feats.dtype)
        return g.replace(feats=mask_grid(feats, g.mask))


class _GridResidual(nn.Module):
    """conv1 -> BN -> relu -> conv2 -> BN (-> ECA), plus the identity or a
    1x1 + BN downsample; relu; masked."""

    def __init__(self, cin: int, planes: int, eca: bool,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        cdt = compute_dtype
        self.conv1 = GridConv(cin, planes, 3, mask_output=False,
                              compute_dtype=cdt)
        self.norm1 = GridBatchNorm(planes)
        self.conv2 = GridConv(planes, planes, 3, mask_output=False,
                              compute_dtype=cdt)
        self.norm2 = GridBatchNorm(planes)
        self.use_eca = eca
        if eca:
            self.eca = GridECALayer(planes)
        self.need_ds = cin != planes
        if self.need_ds:
            self.downsample_conv = GridConv(cin, planes, 1, mask_output=False,
                                            compute_dtype=cdt)
            self.downsample_bn = GridBatchNorm(planes)

    def forward(self, g: DenseVoxelGrid) -> DenseVoxelGrid:
        out = self.norm1(self.conv1(g))
        out = out.replace(feats=mask_grid(torch.relu(out.feats), out.mask))
        out = self.norm2(self.conv2(out))
        if self.use_eca:
            out = self.eca(out)
        residual = g
        if self.need_ds:
            residual = self.downsample_bn(self.downsample_conv(residual))
        feats = torch.relu(out.feats + residual.feats)
        return g.replace(feats=mask_grid(feats, g.mask))


class GridECABasicBlock(_GridResidual):
    def __init__(self, cin: int, planes: int,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__(cin, planes, True, compute_dtype)


class GridBasicBlock(_GridResidual):
    def __init__(self, cin: int, planes: int,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__(cin, planes, False, compute_dtype)


class GridASPP(nn.Module):
    """Three parallel convs (k = 3, 5, 7) cin -> planes, each BN + relu,
    summed, masked."""

    def __init__(self, cin: int, planes: int,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        for i, k in enumerate((3, 5, 7)):
            setattr(self, f"conv{i + 1}",
                    GridConv(cin, planes, k, mask_output=False,
                             compute_dtype=compute_dtype))
            setattr(self, f"bn{i + 1}", GridBatchNorm(planes))

    def forward(self, g: DenseVoxelGrid) -> DenseVoxelGrid:
        feats = None
        for i in (1, 2, 3):
            o = getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(g))
            r = torch.relu(o.feats)
            feats = r if feats is None else feats + r
        return g.replace(feats=mask_grid(feats, g.mask))


class GridConvNextBlock(nn.Module):
    """conv k -> BN -> 1x1 expand 4x -> relu -> 1x1 project, plus the
    identity (a 1x1 when the channels change); no final relu."""

    def __init__(self, cin: int, planes: int, kernel_size: int = 3,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        cdt = compute_dtype
        self.conv1 = GridConv(cin, planes, kernel_size, mask_output=False,
                              compute_dtype=cdt)
        self.bn = GridBatchNorm(planes)
        self.conv2 = GridConv(planes, 4 * planes, 1, mask_output=False,
                              compute_dtype=cdt)
        self.conv3 = GridConv(4 * planes, planes, 1, mask_output=False,
                              compute_dtype=cdt)
        self.need_ds = cin != planes
        if self.need_ds:
            self.downsample_conv = GridConv(cin, planes, 1, mask_output=False,
                                            compute_dtype=cdt)

    def forward(self, g: DenseVoxelGrid) -> DenseVoxelGrid:
        out = self.bn(self.conv1(g))
        out = self.conv2(out)
        out = self.conv3(out.replace(feats=torch.relu(out.feats)))
        residual = self.downsample_conv(g) if self.need_ds else g
        return g.replace(feats=mask_grid(out.feats + residual.feats, g.mask))


class GridMinkGeM(nn.Module):
    """GeM over occupied cells -> [B, C] fp32."""

    def __init__(self, p_init: float = 3.0, eps: float = 1e-6):
        super().__init__()
        self.p = nn.Parameter(torch.full((1,), p_init))
        self.eps = eps

    def forward(self, g: DenseVoxelGrid) -> torch.Tensor:
        clamped = torch.clamp(g.feats.float(), min=self.eps) ** self.p
        return grid_global_avg(g.replace(feats=clamped)) ** (1.0 / self.p)


class GridConvTranspose(nn.Module):
    """k = 2, s = 2 transposed conv of the FPN top-down pass: upsample the
    coarse grid 2x, crop the ME alignment cells, mask to the fine
    occupancy.  JAX's ``lax.conv_transpose`` does not flip the kernel, so
    fine cell 2i + a reads coarse cell i through tap 1 - a (per dim): one
    product of the coarse rows with the 8 taps, interleaved."""

    def __init__(self, cin: int, features: int,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(2, 2, 2, cin, features))
        self.compute_dtype = compute_dtype

    def forward(self, coarse: DenseVoxelGrid,
                fine_mask: torch.Tensor) -> DenseVoxelGrid:
        cdt = self.compute_dtype
        b, x, y, z, cin = coarse.feats.shape
        cout = self.kernel.shape[-1]
        w = self.kernel.to(cdt).flip(0, 1, 2).permute(3, 0, 1, 2, 4).reshape(
            cin, 8 * cout)
        a = coarse.feats.to(cdt).reshape(-1, cin)
        if cdt == torch.bfloat16 and a.device.type == "cpu":
            up = (a.float() @ w.float()).to(cdt)
        else:
            up = a @ w
        up = up.reshape(b, x, y, z, 2, 2, 2, cout).permute(
            0, 1, 4, 2, 5, 3, 6, 7).reshape(b, 2 * x, 2 * y, 2 * z, cout)
        up = up.to(coarse.feats.dtype)
        fx, fy, fz = fine_mask.shape[1:]
        lx, ly, lz = (me_down_align(d)[0] for d in (fx, fy, fz))
        up = up[:, lx:lx + fx, ly:ly + fy, lz:lz + fz]
        return DenseVoxelGrid(feats=mask_grid(up, fine_mask), mask=fine_mask,
                              stride=coarse.stride // 2)


BLOCKS = {"eca": GridECABasicBlock, "basic": GridBasicBlock,
          "aspp": GridASPP, "convnext": GridConvNextBlock}


class DenseMinkFPN(nn.Module):
    """MinkFPN on the masked dense grid (reference ``models/minkfpn.py``):
    conv0 -> BN -> relu; per stage a k2s2 down (channels kept) -> BN -> relu
    -> blocks; a final 1x1; ``num_top_down`` levels of transposed conv +
    lateral 1x1.  Returns (final grid, per-stage maps)."""

    def __init__(self, in_channels: int = 1, out_channels: int = 256,
                 planes: Tuple[int, ...] = (64, 128, 256),
                 layers: Tuple[int, ...] = (1, 1, 1), num_top_down: int = 0,
                 conv0_kernel_size: int = 5, block: str = "eca",
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        check_top_down(num_top_down, len(planes))
        cdt = compute_dtype
        n = self.n_stages = len(planes)
        self.ntd = num_top_down
        self.conv0 = GridConv(in_channels, planes[0], conv0_kernel_size,
                              mask_output=False, compute_dtype=cdt)
        self.bn0 = GridBatchNorm(planes[0])
        c, lateral_c = planes[0], []
        self.stages = []
        for i in range(n):
            down = GridConv(c, c, 2, 2, mask_output=False, compute_dtype=cdt)
            setattr(self, f"down{i}", down)
            setattr(self, f"down_bn{i}", GridBatchNorm(c))
            blocks = []
            for j in range(layers[i]):
                blk = BLOCKS[block](c, planes[i], compute_dtype=cdt)
                setattr(self, f"block{i}_{j}", blk)
                blocks.append(blk)
                c = planes[i]
            if n - 1 - num_top_down <= i < n - 1:
                lateral_c.append(c)
            self.stages.append((down, getattr(self, f"down_bn{i}"), blocks))
        self.lateral_top = GridConv(c, out_channels, 1, compute_dtype=cdt)
        for ndx in range(num_top_down):
            setattr(self, f"tconv{ndx}",
                    GridConvTranspose(out_channels, out_channels, cdt))
            setattr(self, f"lateral{ndx}",
                    GridConv(lateral_c[-ndx - 1], out_channels, 1,
                             compute_dtype=cdt))

    @staticmethod
    def _bn_relu(g: DenseVoxelGrid, bn: GridBatchNorm) -> DenseVoxelGrid:
        g = bn(g)
        return g.replace(feats=mask_grid(torch.relu(g.feats), g.mask))

    def forward(self, g: DenseVoxelGrid
                ) -> Tuple[DenseVoxelGrid, List[DenseVoxelGrid]]:
        n = self.n_stages
        g = self._bn_relu(self.conv0(g), self.bn0)
        laterals = []
        out_maps = []
        for i, (down, down_bn, blocks) in enumerate(self.stages):
            g = self._bn_relu(down(g), down_bn)
            for blk in blocks:
                g = blk(g)
            if n - 1 - self.ntd <= i < n - 1:
                laterals.append(g)
            out_maps.append(g)
        g = self.lateral_top(g)
        out_maps[-1] = g
        for ndx in range(self.ntd):
            fine = laterals[-ndx - 1]
            up = getattr(self, f"tconv{ndx}")(g, fine.mask)
            lat = getattr(self, f"lateral{ndx}")(fine)
            g = up.replace(feats=mask_grid(up.feats + lat.feats, fine.mask))
            out_maps[-2 - ndx] = g
        return g, out_maps

