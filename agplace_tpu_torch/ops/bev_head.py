"""K4 — the fused BEV-FPN head: conv0 + BN0 + relu + mask + down0 + BN + relu
+ mask, with the full-resolution conv0 activation never written.

Port of ``agplace_tpu/ops/pallas/bev_head.py:fused_head``.  The CUDA kernel
(``csrc/bev_head.cu``) computes conv0 itself, as an implicit GEMM over the
occupancy grid, one output parity at a time, keeps each parity's
activation in shared memory and feeds it straight into the down0 GEMM.

``head_plain`` is the plain version, with the TPU kernel's rounding
(``bev_head.py:146-163``): conv0 accumulated in fp32, the BN0 affine in
fp32 with fp32 scale and bias, relu, mask, ONE bf16 round; down0
accumulated in fp32, its affine in fp32, relu, the output mask, one round.
K2 (``ops/bev_down.py``) rounds elsewhere — conv0's output before its
affine, the affine itself in bf16, the down0 sum before its affine — so the
two differ by isolated bf16 ulps and neither is the other's plain version.
"""

from __future__ import annotations

import torch

from agplace_tpu_torch.data.voxels import me_down_align
from agplace_tpu_torch.ops import _build
from agplace_tpu_torch.sparse import bev_grid as bg

_BF16 = torch.bfloat16
_F32 = torch.float32


def head_plain(feats, mask, w0_folded, scale0, bias0, wd_folded, scale_d,
               bias_d, *, z: int):
    k0 = int(w0_folded.shape[0])
    # bf16 operands, fp32 accumulation, result left unrounded
    x = feats.to(_BF16).float()
    w0 = w0_folded.to(_BF16).float()
    h = bg.bev_conv2d(x, w0, 1, (k0 // 2,) * 2, (k0 // 2,) * 2, _F32)
    h = torch.relu(h * scale0.float() + bias0.float())
    h = bg.mask_bev(h, mask, z).to(_BF16)
    lo_z, hi_z, zo = me_down_align(z)
    mask_out = bg.mask_down(mask, (0, 0), (0, 0), (lo_z, hi_z))
    d = bg.bev_conv2d(h.float(), wd_folded.to(_BF16).float(), 2, (0, 0),
                      (0, 0), _F32)
    d = torch.relu(d * scale_d.float() + bias_d.float())
    return bg.mask_bev(d, mask_out, zo).to(_BF16), mask_out


# the kernel's tiles (csrc/bev_head.cu): conv0 depth k0*k0*Z*C0 padded to
# a multiple of 16 and at most 128; Z*C1 in {64, 128, 192, 256} and Zo*C2
# in {64, 128}, with C1 and C2 multiples of 8
_K0_MAX = 128


def fused_head(feats, mask, w0_folded, scale0, bias0, wd_folded, scale_d,
               bias_d, *, z: int):
    """feats [B,X,Y,Z*C0] (masked; cast to bf16, as JAX does), mask
    [B,X,Y,Z] bool, w0_folded [k0,k0,Z*C0,Z*C1], scale0/bias0 [Z*C1] fp32,
    wd_folded [2,2,Z*C1,Zo*C2], scale_d/bias_d [Zo*C2] fp32.  Returns
    (feats [B,X/2,Y/2,Zo*C2] bf16, mask_out [B,X/2,Y/2,Zo]).  Gated on
    either device as the TPU kernel is: k0 odd and <= 5, even X and Y that
    need no ME alignment padding (its parity split pairs (2m, 2m+1))."""
    b, x, y, zc0 = feats.shape
    k0 = int(w0_folded.shape[0])
    _build.check(k0 % 2 == 1 and k0 <= 5,
                 f"fused_head: conv0 kernel size {k0} (odd and <= 5)")
    _build.check(me_down_align(x)[:2] == (0, 0)
                 and me_down_align(y)[:2] == (0, 0),
                 f"fused_head: spatial dims {x}x{y} need ME padding")
    ins = (feats, mask, w0_folded, scale0, bias0, wd_folded, scale_d,
           bias_d)
    if not _build.on_cuda(*ins):
        return head_plain(*ins, z=z)
    zc1, zc2 = int(w0_folded.shape[3]), int(wd_folded.shape[3])
    lo_z, hi_z, zo = me_down_align(z)
    kk = k0 * k0 * zc0
    kp = -(-kk // 16) * 16
    _build.check(kp <= _K0_MAX and zc1 % 64 == 0 and zc1 <= 256
                 and zc2 in (64, 128) and zc1 % (8 * z) == 0
                 and zc2 % (8 * zo) == 0,
                 f"fused_head: conv0 depth {kk}, widths {zc1}->{zc2} outside "
                 f"the kernel's tiles")
    _build.check(tuple(w0_folded.shape) == (k0, k0, zc0, zc1)
                 and tuple(wd_folded.shape) == (2, 2, zc1, zc2),
                 f"fused_head: w0 {tuple(w0_folded.shape)} wd "
                 f"{tuple(wd_folded.shape)}")
    dev = feats.device
    w0p = torch.zeros((kp, zc1), dtype=_BF16, device=dev)
    w0p[:kk] = w0_folded.reshape(kk, zc1)
    mask_out = bg.mask_down(mask, (0, 0), (0, 0), (lo_z, hi_z)).contiguous()
    out = torch.empty((b, x // 2, y // 2, zc2), dtype=_BF16, device=dev)
    _build.call("agp_bev_head", feats.to(_BF16).contiguous(),
                mask.contiguous(), w0p, scale0.float().contiguous(),
                bias0.float().contiguous(), wd_folded.to(_BF16).contiguous(),
                scale_d.float().contiguous(), bias_d.float().contiguous(),
                mask_out, out, b, x, y, zc0, k0, kp, zc1, z, zc2, zo)
    fused_head.launches += 1
    return out, mask_out


fused_head.launches = 0
