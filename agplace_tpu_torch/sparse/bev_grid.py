"""BEV-folded voxel backend (``agplace_tpu/sparse/bev_grid.py``).

Representation (the JAX "z-major fold"):
    feats [B, X, Y, Z*C]   channel index z*C + c
    mask  [B, X, Y, Z]     bool

3-D kernels keep the flax parameter shape ``[k, k, k, cin, cout]`` and are
folded at run time into block-banded 2-D kernels ``[k, k, Z*cin, Z'*cout]``
(``fold_w2_stride1`` / ``fold_w2_k2s2``), so every voxel conv is a plain
NHWC 2-D conv.  The convs outside the kernels (down1, down2, lateral_top,
proj_vox_fuse, and the unfused paths) are cuDNN on the folded weights, as
the JAX package leaves them to XLA.  They always run in ``compute_dtype``
(bf16) and round their result to bf16 before casting to the feats dtype,
like ``BEVConv``.

Three kernels plug in here, in eval mode only, as in JAX: K2
(``ops/bev_down.py``) or, with ``use_pallas_head``, K4 (``ops/bev_head.py``)
at the stage-0 site of ``BEVMinkFPN``, and K3 (``ops/bev_block_sm.py``) in
``BEVECABasicBlock``.  Training mode runs the unfused path, its BN
statistics taken over the occupied cells (``bn_apply``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from agplace_tpu_torch.data.voxels import me_down_align
from agplace_tpu_torch.models.layers import conv2d_nhwc
from agplace_tpu_torch.models.norm import BatchNorm2D
from agplace_tpu_torch.ops import bev_block_sm, bev_down, bev_head

Pad = Tuple[int, int]


@dataclasses.dataclass
class BEVGrid:
    feats: torch.Tensor  # [B, X, Y, Z*C]
    mask: torch.Tensor  # [B, X, Y, Z] bool
    z: int = 1
    stride: int = 1

    @property
    def channels(self) -> int:
        return self.feats.shape[-1] // self.z

    def replace(self, **kw) -> "BEVGrid":
        return dataclasses.replace(self, **kw)


def mask_bev(feats: torch.Tensor, mask: torch.Tensor, z: int) -> torch.Tensor:
    """Zero features at unoccupied cells (broadcast over the folded C)."""
    b, x, y, zc = feats.shape
    f = feats.reshape(b, x, y, z, zc // z)
    return torch.where(mask[..., None], f, 0).reshape(b, x, y, zc)


def bev_global_avg(g: BEVGrid) -> torch.Tensor:
    """Per-channel mean over occupied cells -> [B, C], accumulated in fp32
    and rounded to the feats dtype."""
    b, x, y, zc = g.feats.shape
    f = g.feats.reshape(b, x, y, g.z, zc // g.z).float()
    m = g.mask[..., None].float()
    s = (f * m).sum(dim=(1, 2, 3))
    n = torch.clamp(m.sum(dim=(1, 2, 3)), min=1.0)
    return (s / n).to(g.feats.dtype)


def fold_w2_stride1(kern: torch.Tensor, z: int) -> torch.Tensor:
    """[k,k,k,cin,cout] -> block-banded [k,k,z*cin,z*cout] (stride 1)."""
    k, cin, cout = kern.shape[0], kern.shape[3], kern.shape[4]
    w2 = kern.new_zeros((k, k, z * cin, z * cout))
    for zo in range(z):
        for t in range(k):
            zi = zo + t - k // 2
            if 0 <= zi < z:
                w2[:, :, zi * cin:(zi + 1) * cin,
                   zo * cout:(zo + 1) * cout] = kern[:, :, t]
    return w2


def fold_w2_k2s2(kern: torch.Tensor, z: int) -> torch.Tensor:
    """[2,2,2,cin,cout] -> [2,2,z*cin,z_out*cout] for the k=2 s=2 down,
    with the ME z pairing z_in = 2*z_out + t - lo (``me_down_align``)."""
    cin, cout = kern.shape[3], kern.shape[4]
    lo, _, z_out = me_down_align(z)
    w2 = kern.new_zeros((2, 2, z * cin, z_out * cout))
    for zo in range(z_out):
        for t in range(2):
            zi = 2 * zo + t - lo
            if 0 <= zi < z:
                w2[:, :, zi * cin:(zi + 1) * cin,
                   zo * cout:(zo + 1) * cout] = kern[:, :, t]
    return w2


def bev_conv2d(feats: torch.Tensor, w2: torch.Tensor, stride: int,
               pad_x: Pad, pad_y: Pad,
               compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Conv of a folded map with a folded HWIO kernel, computed in
    ``compute_dtype``, returned in the feats dtype (unmasked)."""
    x = feats.to(compute_dtype)
    if pad_x[0] == pad_x[1] == pad_y[0] == pad_y[1]:
        padding = pad_x[0]
    else:
        x = F.pad(x, (0, 0, pad_y[0], pad_y[1], pad_x[0], pad_x[1]))
        padding = 0
    w = w2.permute(3, 2, 0, 1)
    return conv2d_nhwc(x, w, None, stride, padding,
                       compute_dtype).to(feats.dtype)


def mask_down(mask: torch.Tensor, pad_x: Pad, pad_y: Pad,
              pad_z: Pad) -> torch.Tensor:
    """Output occupancy of a k=2 s=2 down: any occupied parent over
    2x2x2 (after the ME alignment padding)."""
    m = F.pad(mask[:, None].float(),
              (pad_z[0], pad_z[1], pad_y[0], pad_y[1], pad_x[0], pad_x[1]))
    return F.max_pool3d(m, 2, 2)[:, 0] > 0


def bn_apply(g: BEVGrid, bn: BatchNorm2D) -> torch.Tensor:
    """BN over the folded layout (``_bn_apply``), unmasked output: the fp32
    affine tiled over z, applied in the feats dtype.  In training mode the
    statistics are the batch's over the occupied cells only, shared across
    z (the count clamped to at least 1, the variance to at least 0), and
    the running statistics move towards them."""
    if bn.training:
        b, x, y, zc = g.feats.shape
        f = g.feats.reshape(b, x, y, g.z, zc // g.z).float()
        m = g.mask[..., None].float()
        cnt = torch.clamp(m.sum(), min=1.0)
        mean = (f * m).sum(dim=(0, 1, 2, 3)) / cnt
        var = torch.clamp((f.square() * m).sum(dim=(0, 1, 2, 3)) / cnt
                          - mean.square(), min=0.0)
        bn.track(mean, var)
        s, b = bn.batch_affine(mean, var, g.z)
    else:
        s, b = bn.affine(g.z)
    return g.feats * s.to(g.feats.dtype) + b.to(g.feats.dtype)


def eca_apply(g: BEVGrid, conv_w: torch.Tensor) -> torch.Tensor:
    """``_eca_apply``: masked global average (rounded to the feats dtype),
    1-D channel conv, sigmoid, multiply (no output mask)."""
    k = conv_w.shape[0]
    y = bev_global_avg(g).float()[:, None, :]  # [B, 1, C]
    y = F.conv1d(y, conv_w.float().reshape(1, 1, k), padding=(k - 1) // 2)
    yz = torch.sigmoid(y[:, 0]).repeat(1, g.z).to(g.feats.dtype)
    return g.feats * yz[:, None, None, :]


class _ConvParam(nn.Module):
    """Holder of a BEV 3-D kernel ``[k,k,k,cin,cout]`` (flax ``kernel``)
    with a cache of its folded 2-D forms.  The cache is used only when no
    gradient is recorded, and it is keyed on the kernel's storage and
    version, so an in-place weight update invalidates it."""

    def __init__(self, k: int, cin: int, cout: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(k, k, k, cin, cout))
        self._folded = {}

    def folded(self, z: int, kind: str, dtype: torch.dtype) -> torch.Tensor:
        fold = fold_w2_stride1 if kind == "s1" else fold_w2_k2s2
        if torch.is_grad_enabled() and self.kernel.requires_grad:
            return fold(self.kernel.to(dtype), z)
        key = (z, kind, dtype)
        tag = (self.kernel.data_ptr(), self.kernel._version,
               torch.is_inference_mode_enabled())
        hit = self._folded.get(key)
        if hit is None or hit[0] != tag:
            hit = (tag, fold(self.kernel.detach().to(dtype), z).contiguous())
            self._folded[key] = hit
        return hit[1]


class BEVConv(_ConvParam):
    """Masked ME-equivalent conv in the folded layout: odd k at stride 1, or
    k=2 s=2 with the ME alignment padding and the max-pool output mask."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 stride: int = 1, mask_output: bool = True,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__(kernel_size, cin, cout)
        self.k, self.s = kernel_size, stride
        self.mask_output = mask_output
        self.compute_dtype = compute_dtype

    def forward(self, g: BEVGrid) -> BEVGrid:
        k, s, z = self.k, self.s, g.z
        if k % 2 == 1 and s == 1:
            z_out, out_mask = z, g.mask
            pad_x = pad_y = (k // 2, k // 2)
            w2 = self.folded(z, "s1", self.compute_dtype)
        elif k == 2 and s == 2:
            lo_z, hi_z, z_out = me_down_align(z)
            pad_x = me_down_align(g.feats.shape[1])[:2]
            pad_y = me_down_align(g.feats.shape[2])[:2]
            out_mask = mask_down(g.mask, pad_x, pad_y, (lo_z, hi_z))
            w2 = self.folded(z, "k2s2", self.compute_dtype)
        else:
            raise NotImplementedError((k, s))
        out = bev_conv2d(g.feats, w2, s, pad_x, pad_y, self.compute_dtype)
        if self.mask_output:
            out = mask_bev(out, out_mask, z_out)
        return BEVGrid(feats=out, mask=out_mask, z=z_out,
                       stride=g.stride * s)


class _ECAParam(nn.Module):
    """ECA 1-D channel-conv weight ``conv_w`` [k, 1, 1], k from the channel
    count (``bev_grid.py:307-313``)."""

    def __init__(self, channels: int, gamma: float = 2.0, b: float = 1.0):
        super().__init__()
        t = int(abs((math.log2(channels) + b) / gamma))
        self.conv_w = nn.Parameter(torch.empty(t if t % 2 else t + 1, 1, 1))


class BEVECABasicBlock(nn.Module):
    """ECA basic block.  In eval mode ``use_pallas`` routes to the K3
    wrapper (``ops/bev_block_sm.py``); otherwise the unfused block runs,
    its BN on the running statistics in eval mode and on the batch's in
    training mode (``bev_grid.py:496-512`` of the JAX package)."""

    def __init__(self, cin: int, planes: int, use_pallas: bool = False,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv1 = _ConvParam(3, cin, planes)
        self.norm1 = BatchNorm2D(planes)
        self.conv2 = _ConvParam(3, planes, planes)
        self.norm2 = BatchNorm2D(planes)
        self.eca = _ECAParam(planes)
        self.need_ds = cin != planes
        if self.need_ds:
            self.downsample_conv = _ConvParam(1, cin, planes)
            self.downsample_bn = BatchNorm2D(planes)
        self.use_pallas = use_pallas
        self.compute_dtype = compute_dtype

    def _conv(self, p: _ConvParam, feats: torch.Tensor, z: int):
        k = p.kernel.shape[0]
        return bev_conv2d(feats, p.folded(z, "s1", self.compute_dtype), 1,
                          (k // 2, k // 2), (k // 2, k // 2),
                          self.compute_dtype)

    def _forward_unfused(self, g: BEVGrid) -> BEVGrid:
        z = g.z
        out = bn_apply(g.replace(feats=self._conv(self.conv1, g.feats, z)),
                       self.norm1)
        out = mask_bev(torch.relu(out), g.mask, z)
        out = bn_apply(g.replace(feats=self._conv(self.conv2, out, z)),
                       self.norm2)
        out = eca_apply(g.replace(feats=out), self.eca.conv_w)
        residual = g.feats
        if self.need_ds:
            residual = bn_apply(g.replace(feats=self._conv(
                self.downsample_conv, residual, z)), self.downsample_bn)
        return g.replace(feats=mask_bev(torch.relu(out + residual), g.mask,
                                        z))

    def forward(self, g: BEVGrid) -> BEVGrid:
        if self.training or not self.use_pallas:
            return self._forward_unfused(g)
        z, cdt = g.z, self.compute_dtype
        s1, b1 = self.norm1.affine(z)
        s2, b2 = self.norm2.affine(z)
        kw = {}
        if self.need_ds:
            sd, bd = self.downsample_bn.affine(z)
            kw = dict(wd=self.downsample_conv.folded(z, "s1", cdt),
                      scale_d=sd, bias_d=bd)
        args = (g.feats, g.mask, self.conv1.folded(z, "s1", cdt),
                self.conv2.folded(z, "s1", cdt), s1, b1, s2, b2,
                self.eca.conv_w[:, 0, 0])
        out = bev_block_sm.fused_eca_block_sm(*args, z=z, **kw)
        return g.replace(feats=out.to(g.feats.dtype))


class BEVMinkGeM(nn.Module):
    """GeM over occupied cells -> [B, C] fp32."""

    def __init__(self, p_init: float = 3.0, eps: float = 1e-6):
        super().__init__()
        self.p = nn.Parameter(torch.full((1,), p_init))
        self.eps = eps

    def forward(self, g: BEVGrid) -> torch.Tensor:
        clamped = torch.clamp(g.feats.float(), min=self.eps) ** self.p
        pooled = bev_global_avg(g.replace(feats=clamped)).float()
        return pooled ** (1.0 / self.p)


class BEVMinkFPN(nn.Module):
    """MinkFPN in the folded layout with ``num_top_down=0`` and ECA blocks
    (the live configuration).  Returns (final BEVGrid, per-stage maps)."""

    def __init__(self, in_channels: int = 1, out_channels: int = 256,
                 planes: Tuple[int, ...] = (64, 128, 256),
                 layers: Tuple[int, ...] = (1, 1, 1), num_top_down: int = 0,
                 conv0_kernel_size: int = 5, block: str = "eca",
                 use_pallas: bool = False, use_pallas_head: bool = False,
                 use_fused_down: bool = True,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if num_top_down != 0 or block != "eca":
            raise NotImplementedError(
                f"num_top_down={num_top_down}, block={block!r}: the port "
                f"has the live configuration (0, 'eca') only")
        cdt = compute_dtype
        self.n_stages = len(planes)
        self.k0 = conv0_kernel_size
        self.use_pallas_head = use_pallas_head
        self.use_fused_down = use_fused_down
        self.conv0 = BEVConv(in_channels, planes[0], conv0_kernel_size,
                             mask_output=False, compute_dtype=cdt)
        self.bn0 = BatchNorm2D(planes[0])
        c = planes[0]
        self.stages = []
        for i in range(self.n_stages):
            down = BEVConv(c, c, 2, 2, mask_output=False, compute_dtype=cdt)
            setattr(self, f"down{i}", down)
            setattr(self, f"down_bn{i}", BatchNorm2D(c))
            blocks = []
            for b in range(layers[i]):
                blk = BEVECABasicBlock(c, planes[i], use_pallas, cdt)
                setattr(self, f"block{i}_{b}", blk)
                blocks.append(blk)
                c = planes[i]
            self.stages.append((down, getattr(self, f"down_bn{i}"), blocks))
        self.lateral_top = BEVConv(c, out_channels, 1, mask_output=False,
                                   compute_dtype=cdt)

    @staticmethod
    def _bn_relu_mask(g: BEVGrid, bn: BatchNorm2D) -> BEVGrid:
        f = torch.relu(bn_apply(g, bn))
        return g.replace(feats=mask_bev(f, g.mask, g.z))

    def forward(self, g: BEVGrid) -> Tuple[BEVGrid, List[BEVGrid]]:
        x, y = g.feats.shape[1], g.feats.shape[2]
        # the JAX stage-0 gates (bev_grid.py:669-681) minus the TPU check:
        # eval mode, spatial dims that need no ME alignment padding; the
        # fused head (K4) takes k0 in (3, 5) and wins over the fused down
        # (K2)
        fusible = (not self.training and x % 2 == 0 and y % 2 == 0
                   and (x // 2) % 2 == 0 and (y // 2) % 2 == 0)
        fuse_head = self.use_pallas_head and fusible and self.k0 in (3, 5)
        fuse_down = (self.use_fused_down and not fuse_head and fusible
                     and self.k0 % 2 == 1 and self.k0 >= 3)
        down0, down_bn0, _ = self.stages[0]
        fused = fuse_head or fuse_down
        if fused:
            z0 = g.z
            z_down = me_down_align(z0)[2]
            cdt = self.conv0.compute_dtype
            s0, b0 = self.bn0.affine(z0)
            sd, bd = down_bn0.affine(z_down)
            kernel = (bev_head.fused_head if fuse_head
                      else bev_down.fused_conv0_down0)
            feats, mask = kernel(
                g.feats, g.mask, self.conv0.folded(z0, "s1", cdt), s0, b0,
                down0.folded(z0, "k2s2", cdt), sd, bd, z=z0)
            g = BEVGrid(feats=feats.to(g.feats.dtype), mask=mask, z=z_down,
                        stride=g.stride * 2)
        else:
            g = self._bn_relu_mask(self.conv0(g), self.bn0)
        out_maps = []
        for i, (down, down_bn, blocks) in enumerate(self.stages):
            if not (fused and i == 0):
                g = self._bn_relu_mask(down(g), down_bn)
            for blk in blocks:
                g = blk(g)
            out_maps.append(g)
        # bias-free 1x1 of a masked map: exact without an output mask
        g = self.lateral_top(g)
        out_maps[-1] = g
        return g, out_maps
