"""K2 — fused stage-0 epilogue + masked down0 of the BEV FPN.

Port of ``agplace_tpu/ops/pallas/bev_down.py:fused_conv0_down0``.  conv0
runs outside the kernel as one full-resolution cuDNN conv (XLA ran it
outside the Pallas call); the CUDA kernel ``csrc/bev_down.cu`` applies BN0,
relu and the z-mask while it gathers each 2x2 window, runs the down0
product in fp32, and applies the down BN, relu and the output mask.
``conv0_down0_plain`` is the plain version: the unfused prefix
``BEVConv -> BN -> relu -> mask -> BEVConv(k2s2) -> BN -> relu -> mask``
(``bev_grid.py:720-740``).
"""

from __future__ import annotations

import torch

from agplace_tpu_torch.data.voxels import me_down_align
from agplace_tpu_torch.ops import _build
from agplace_tpu_torch.sparse import bev_grid as bg

_BF16 = torch.bfloat16


def conv0_down0_plain(feats, mask, w0_folded, scale0, bias0, wd_folded,
                      scale_d, bias_d, *, z: int):
    fd = feats.dtype
    k0 = w0_folded.shape[0]
    h = bg.bev_conv2d(feats, w0_folded, 1, (k0 // 2,) * 2, (k0 // 2,) * 2)
    h = bg.mask_bev(torch.relu(h * scale0.to(fd) + bias0.to(fd)), mask, z)
    lo_z, hi_z, zo = me_down_align(z)
    mask_out = bg.mask_down(mask, (0, 0), (0, 0), (lo_z, hi_z))
    d = bg.bev_conv2d(h, wd_folded, 2, (0, 0), (0, 0))
    d = bg.mask_bev(torch.relu(d * scale_d.to(fd) + bias_d.to(fd)),
                    mask_out, zo)
    return d, mask_out


def check_stage0_args(name, feats, w0_folded, wd_folded, z: int):
    """The CUDA kernels' shape rules for the BEV stage 0 (K2's and P2's):
    spatial dims that need no ME padding, channel widths on the tiles."""
    _, x, y, _ = feats.shape
    zc1, zc2 = int(w0_folded.shape[3]), int(wd_folded.shape[3])
    zo = me_down_align(z)[2]
    _build.check(me_down_align(x)[:2] == (0, 0)
                 and me_down_align(y)[:2] == (0, 0),
                 f"{name}: spatial dims {x}x{y} need ME padding")
    _build.check(zc1 % 32 == 0 and (zc1 // z) % 8 == 0
                 and (zc2 // zo) % 8 == 0 and zc2 % 8 == 0,
                 f"{name}: channel widths {zc1}->{zc2} at z={z} not "
                 f"multiples of the kernel's tiles")
    _build.check(tuple(wd_folded.shape) == (2, 2, zc1, zc2),
                 f"{name}: wd {tuple(wd_folded.shape)}")


def fused_conv0_down0(feats, mask, w0_folded, scale0, bias0, wd_folded,
                      scale_d, bias_d, *, z: int):
    """feats [B,X,Y,Z*C0] (masked), mask [B,X,Y,Z] bool, w0_folded
    [k0,k0,Z*C0,Z*C1], scale0/bias0 [Z*C1] fp32, wd_folded
    [2,2,Z*C1,Zo*C2], scale_d/bias_d [Zo*C2] fp32.  X and Y must need no
    ME alignment padding.  Returns (feats [B,X/2,Y/2,Zo*C2], mask_out
    [B,X/2,Y/2,Zo]); bf16 from the kernel, the feats dtype from the plain
    version."""
    ins = (feats, mask, w0_folded, scale0, bias0, wd_folded, scale_d,
           bias_d)
    if not _build.on_cuda(*ins):
        return conv0_down0_plain(*ins, z=z)
    b, x, y, _ = feats.shape
    k0 = int(w0_folded.shape[0])
    zc1, zc2 = int(w0_folded.shape[3]), int(wd_folded.shape[3])
    lo_z, hi_z, zo = me_down_align(z)
    _build.check(feats.dtype == _BF16, "fused_conv0_down0: bf16 feats")
    check_stage0_args("fused_conv0_down0", feats, w0_folded, wd_folded, z)
    g0 = bg.bev_conv2d(feats, w0_folded, 1, (k0 // 2,) * 2,
                       (k0 // 2,) * 2).contiguous()
    mask_out = bg.mask_down(mask, (0, 0), (0, 0), (lo_z, hi_z)).contiguous()
    out = torch.empty((b, x // 2, y // 2, zc2), dtype=_BF16,
                      device=feats.device)
    _build.call("agp_bev_down", g0, mask.contiguous(),
                scale0.float().contiguous(), bias0.float().contiguous(),
                wd_folded.to(_BF16).contiguous(),
                scale_d.float().contiguous(), bias_d.float().contiguous(),
                mask_out, out, b, x, y, zc1, z, zc2, zo)
    fused_conv0_down0.launches += 1
    return out, mask_out


fused_conv0_down0.launches = 0
