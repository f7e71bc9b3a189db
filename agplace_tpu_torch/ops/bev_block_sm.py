"""K3 — the eval-mode BEV ECA basic block.

Port of ``agplace_tpu/ops/pallas/bev_block_sm.py:fused_eca_block_sm``.  The
CUDA version (``csrc/bev_block_sm.cu``) runs the block as four hand-written
phases (conv3x3+BN+relu+mask; conv3x3+BN with the masked ECA pool in its
epilogue; the ECA fold/conv/sigmoid; attention multiply + residual + relu +
mask, with the 1x1 downsample conv+BN in the last phase's GEMM).  There is
no shape gate: the TPU VMEM gate ``sm_block_vmem_ok`` has no counterpart.
``eca_block_plain`` is the plain version, the JAX module's unfused path
(``bev_grid.py:496-512``).
"""

from __future__ import annotations

import torch

from agplace_tpu_torch.ops import _build
from agplace_tpu_torch.sparse import bev_grid as bg

_BF16 = torch.bfloat16


def eca_block_plain(x, mask, w1, w2, scale1, bias1, scale2, bias2, w_eca,
                    z: int, wd=None, scale_d=None, bias_d=None):
    fd = x.dtype
    g = bg.BEVGrid(feats=x, mask=mask, z=z)
    h = bg.bev_conv2d(x, w1, 1, (1, 1), (1, 1))
    h = h * scale1.to(fd) + bias1.to(fd)
    h = bg.mask_bev(torch.relu(h), mask, z)
    out = bg.bev_conv2d(h, w2, 1, (1, 1), (1, 1))
    out = out * scale2.to(fd) + bias2.to(fd)
    out = bg.eca_apply(g.replace(feats=out), w_eca.reshape(-1, 1, 1))
    r = x
    if wd is not None:
        r = bg.bev_conv2d(x, wd, 1, (0, 0), (0, 0))
        r = r * scale_d.to(fd) + bias_d.to(fd)
    return bg.mask_bev(torch.relu(out + r), mask, z)


def check_block_args(name, x, w1, w2, z: int, wd=None):
    """The CUDA phases' shape rules for an ECA block (K3's and P1's);
    returns (B, X, Y, Z*Cin, Z*Cout)."""
    b, xd, yd, zci = x.shape
    zco = int(w2.shape[3])
    _build.check(x.dtype == _BF16, f"{name}: bf16 x")
    _build.check(tuple(w1.shape) == (3, 3, zci, zco)
                 and tuple(w2.shape) == (3, 3, zco, zco),
                 f"{name}: w1 {tuple(w1.shape)} w2 {tuple(w2.shape)}")
    _build.check(zci % 32 == 0 and zco % 32 == 0 and (zco // z) % 8 == 0,
                 f"{name}: widths {zci}->{zco} at z={z} not multiples of the "
                 f"kernel's tiles")
    if wd is None:
        _build.check(zci == zco,
                     f"{name}: identity residual needs Cin == Cout")
    else:
        _build.check(tuple(wd.shape) == (1, 1, zci, zco),
                     f"{name}: wd {tuple(wd.shape)}")
    return b, xd, yd, zci, zco


def eca_combine(x, m, g, pool, w_eca, z: int, wd=None, scale_d=None,
                bias_d=None):
    """Phases 3 and 4 on the card: the ECA attention from the masked pool
    [B, Z*Cout] fp32, then relu(g*att + r) * mask with r = x or the 1x1
    residual conv + BN in the combine's GEMM.  Returns [B,X,Y,Z*Cout]."""
    b, xd, yd, zci = x.shape
    zco = int(g.shape[3])
    att = torch.empty((b, zco), dtype=_BF16, device=x.device)
    w_e = w_eca.float().contiguous()
    _build.call("agp_block_eca", pool, m, w_e, int(w_e.shape[0]), att, b,
                xd * yd * z, z, zco // z)
    out = torch.empty_like(g)
    if wd is not None:
        _build.call("agp_block_combine_ds", x, m, wd.to(_BF16).contiguous(),
                    scale_d.float().contiguous(), bias_d.float().contiguous(),
                    g, att, out, b, xd, yd, zci, zco, z)
    else:
        _build.call("agp_block_combine_id", g, x, att, m, out, b, xd, yd,
                    zco, z)
    return out


def fused_eca_block_sm(x, mask, w1, w2, scale1, bias1, scale2, bias2,
                       w_eca, z: int, wd=None, scale_d=None, bias_d=None):
    """x [B,X,Y,Z*Cin] (masked), mask [B,X,Y,Z] bool, w1 [3,3,Z*Cin,Z*Cout]
    and w2 [3,3,Z*Cout,Z*Cout] folded, scale/bias [Z*Cout] fp32 (BN eval
    affines), w_eca [k].  Channel-changing blocks pass the 1x1 residual: wd
    [1,1,Z*Cin,Z*Cout], scale_d/bias_d.  Returns [B,X,Y,Z*Cout]."""
    ds = () if wd is None else (wd, scale_d, bias_d)
    if not _build.on_cuda(x, mask, w1, w2, scale1, bias1, scale2, bias2,
                          w_eca, *ds):
        return eca_block_plain(x, mask, w1, w2, scale1, bias1, scale2,
                               bias2, w_eca, z, wd, scale_d, bias_d)
    b, xd, yd, zci, zco = check_block_args("fused_eca_block_sm", x, w1, w2,
                                           z, wd)
    x = x.contiguous()
    m = mask.contiguous()
    h = torch.empty((b, xd, yd, zco), dtype=_BF16, device=x.device)
    _build.call("agp_block_conv1", x, m, w1.to(_BF16).contiguous(),
                scale1.float().contiguous(), bias1.float().contiguous(), h,
                b, xd, yd, zci, zco, z)
    g = torch.empty_like(h)
    pool = torch.zeros((b, zco), dtype=torch.float32, device=x.device)
    _build.call("agp_block_conv2_pool", h, m, w2.to(_BF16).contiguous(),
                scale2.float().contiguous(), bias2.float().contiguous(), g,
                pool, b, xd, yd, zco, z)
    out = eca_combine(x, m, g, pool, w_eca, z, wd, scale_d, bias_d)
    fused_eca_block_sm.launches += 1
    return out


fused_eca_block_sm.launches = 0
