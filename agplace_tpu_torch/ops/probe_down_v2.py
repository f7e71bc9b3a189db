"""P2 — BEV stage 0 as one concat GEMM over the four conv0 parity planes.

Port of the probe kernel ``scripts/probe_down_v2.py:make_v2`` (``fused_v2``,
whose Pallas call is at ``:143``), an alternative formulation of K2
(``ops/bev_down.py``).  conv0 runs outside the kernel as four bare stride-2
convs, one per output parity (cuDNN bf16, as XLA ran them outside the
Pallas call, ``:94-104``).  The CUDA kernel ``csrc/probe_down_v2.cu`` reads
the four contiguous planes as one K = 4*Z*C1 operand, applies the wide BN0
affine, relu and the z-mask on the way in, and the down BN, relu and the
output mask in its epilogue.  ``down_concat_plain`` is the plain version,
the probe kernel's arithmetic in PyTorch.  No model path calls P2, as in
JAX; ``scripts/probe_torch_down_v2.py`` times it against K2.
"""

from __future__ import annotations

import torch

from agplace_tpu_torch.data.voxels import me_down_align
from agplace_tpu_torch.ops import _build, bev_down
from agplace_tpu_torch.sparse import bev_grid as bg

_BF16 = torch.bfloat16


def parity_planes(feats, w0_folded):
    """conv0 as four bare stride-2 convs in bf16.  Plane ``2*px + py`` is
    the full-resolution 'same' conv at the cells ``(2*xo + px, 2*yo + py)``:
    its padding is ``(h - px, k0 - 2 - h + px)`` on x (and likewise on y)
    with ``h = k0 // 2``.  Each is [B, X/2, Y/2, Z*C1]."""
    k0 = int(w0_folded.shape[0])
    h = k0 // 2
    fb = feats.to(_BF16)
    return [bg.bev_conv2d(fb, w0_folded, 2, (h - px, k0 - 2 - h + px),
                          (h - py, k0 - 2 - h + py))
            for px in range(2) for py in range(2)]


def _parity_mask(mask, c1: int):
    """[B, X, Y, Z] -> [B, X/2, Y/2, 4*Z*C1]: the z-mask of each parity
    plane, in the planes' concatenation order, expanded over C1."""
    b, x, y, z = mask.shape
    m = (mask.reshape(b, x // 2, 2, y // 2, 2, z).permute(0, 1, 3, 2, 4, 5)
         .reshape(b, x // 2, y // 2, 4 * z))
    return m.repeat_interleave(c1, dim=-1)


def down_concat_plain(feats, mask, w0_folded, scale0, bias0, wd_folded,
                      scale_d, bias_d, *, z: int):
    b, x, y, _ = feats.shape
    zc1, zc2 = int(w0_folded.shape[3]), int(wd_folded.shape[3])
    lo_z, hi_z, zo = me_down_align(z)
    g = torch.cat(parity_planes(feats, w0_folded), dim=-1)
    s0 = scale0.to(_BF16).repeat(4)  # the wide affine over 4*Z*C1
    b0 = bias0.to(_BF16).repeat(4)
    act = torch.where(_parity_mask(mask, zc1 // z), torch.relu(g * s0 + b0),
                      0)
    wd = wd_folded.to(_BF16).reshape(4 * zc1, zc2)
    acc = act.float().reshape(-1, 4 * zc1) @ wd.float()
    out = (acc.to(_BF16) * scale_d.to(_BF16) + bias_d.to(_BF16))
    mask_out = bg.mask_down(mask, (0, 0), (0, 0), (lo_z, hi_z))
    out = bg.mask_bev(torch.relu(out).reshape(b, x // 2, y // 2, zc2),
                      mask_out, zo)
    return out, mask_out


def fused_down_concat(feats, mask, w0_folded, scale0, bias0, wd_folded,
                      scale_d, bias_d, *, z: int):
    """The arguments of K2's ``fused_conv0_down0``: feats [B,X,Y,Z*C0],
    mask [B,X,Y,Z] bool, w0_folded [k0,k0,Z*C0,Z*C1], scale0/bias0 [Z*C1]
    fp32, wd_folded [2,2,Z*C1,Zo*C2], scale_d/bias_d [Zo*C2] fp32.
    Returns (feats [B,X/2,Y/2,Zo*C2] bf16, mask_out [B,X/2,Y/2,Zo])."""
    ins = (feats, mask, w0_folded, scale0, bias0, wd_folded, scale_d,
           bias_d)
    if not _build.on_cuda(*ins):
        return down_concat_plain(*ins, z=z)
    b, x, y, _ = feats.shape
    zc1, zc2 = int(w0_folded.shape[3]), int(wd_folded.shape[3])
    lo_z, hi_z, zo = me_down_align(z)
    bev_down.check_stage0_args("fused_down_concat", feats, w0_folded,
                               wd_folded, z)
    planes = [p.contiguous() for p in parity_planes(feats, w0_folded)]
    mask_out = bg.mask_down(mask, (0, 0), (0, 0), (lo_z, hi_z)).contiguous()
    out = torch.empty((b, x // 2, y // 2, zc2), dtype=_BF16,
                      device=feats.device)
    _build.call("agp_down_concat", *planes, mask.contiguous(),
                scale0.float().repeat(4), bias0.float().repeat(4),
                wd_folded.to(_BF16).contiguous(),
                scale_d.float().contiguous(), bias_d.float().contiguous(),
                mask_out, out, b, x, y, zc1, z, zc2, zo)
    fused_down_concat.launches += 1
    return out, mask_out


fused_down_concat.launches = 0
