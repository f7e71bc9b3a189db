"""P1 — the eval ECA block with each 3x3 conv as an im2col-concat GEMM.

Port of the probe kernel ``scripts/probe_block_sm_v2.py:make_v2``
(``fused_v2``, whose Pallas call is at ``:178``), an alternative formulation
of K3 (``ops/bev_block_sm.py``).  It computes K3's block with K3's rounding
points; only the conv differs: the nine taps go in groups of ``chunk`` (1, 3
or 9), each group is one product over ``chunk * Zcin`` concatenated
channels, the groups are summed in fp32 and the sum is rounded to bf16 once
(``probe_block_sm_v2.py:62-80``).  The JAX module's ``CHUNK`` environment
variable is the ``chunk`` argument here.

The CUDA version keeps K3's phase split (the ECA pool is a reduction over a
whole batch item).  Its two conv phases are new (``csrc/probe_block_sm_v2.cu``:
a block stages a halo'd input patch in shared memory once per channel slab
and forms every tap from shifted views of it); the ECA phase and the
combine (with the 1x1 downsample in its GEMM) are K3's own
(``csrc/eca.cuh``, ``csrc/bev_block_sm.cu``).  ``eca_block_concat_plain``
is the plain version, the probe kernel's arithmetic in PyTorch.  No model
path calls P1, as in JAX; ``scripts/probe_torch_block_sm_v2.py`` times it
against K3.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from agplace_tpu_torch.ops import _build, bev_block_sm
from agplace_tpu_torch.sparse import bev_grid as bg

_BF16 = torch.bfloat16
CHUNKS = (1, 3, 9)
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on the H100


def _conv3x3_concat(src, w, chunk: int):
    """'same' 3x3 conv of src [B,X,Y,K] (bf16) with w [3,3,K,N]: one fp32
    product per group of ``chunk`` taps over their concatenated windows,
    the groups summed in fp32.  Returns fp32 [B,X,Y,N]."""
    b, xd, yd, _ = src.shape
    pad = F.pad(src, (0, 0, 1, 1, 1, 1))
    w = w.to(_BF16)
    taps = [(dx, dy) for dx in range(3) for dy in range(3)]
    acc = None
    for i0 in range(0, 9, chunk):
        grp = taps[i0:i0 + chunk]
        cols = torch.cat([pad[:, dx:dx + xd, dy:dy + yd] for dx, dy in grp],
                         dim=-1)
        wg = torch.cat([w[dx, dy] for dx, dy in grp], dim=0)
        d = cols.reshape(-1, cols.shape[-1]).float() @ wg.float()
        acc = d if acc is None else acc + d
    return acc.reshape(b, xd, yd, -1)


def eca_block_concat_plain(x, mask, w1, w2, scale1, bias1, scale2, bias2,
                           w_eca, z: int, wd=None, scale_d=None, bias_d=None,
                           chunk: int = 3):
    b, _, _, zci = x.shape
    zco = int(w2.shape[3])
    c = zco // z
    x = x.to(_BF16)
    h = _conv3x3_concat(x, w1, chunk).to(_BF16)
    h = bg.mask_bev(torch.relu(h * scale1.to(_BF16) + bias1.to(_BF16)), mask,
                    z)
    g = _conv3x3_concat(h, w2, chunk).to(_BF16)
    g = g * scale2.to(_BF16) + bias2.to(_BF16)
    # ECA: fp32 masked mean of g (not rounded), 1-D channel conv, sigmoid
    s_zc = bg.mask_bev(g, mask, z).float().sum(dim=(1, 2))
    cnt = torch.clamp(mask.float().sum(dim=(1, 2, 3)), min=1.0)[:, None]
    pooled = s_zc.reshape(b, z, c).sum(dim=1) / cnt
    k = int(w_eca.shape[0])
    half = (k - 1) // 2
    padded = F.pad(pooled, (half, k - 1 - half))
    att = torch.zeros_like(pooled)
    for t in range(k):
        att = att + w_eca[t].float() * padded[:, t:t + c]
    att_zc = torch.sigmoid(att).repeat(1, z).to(_BF16)[:, None, None, :]
    r = x
    if wd is not None:
        r = (x.reshape(-1, zci).float()
             @ wd.to(_BF16).reshape(zci, zco).float()).to(_BF16)
        r = (r * scale_d.to(_BF16) + bias_d.to(_BF16)).reshape(g.shape)
    return bg.mask_bev(torch.relu(g * att_zc + r), mask, z)


def smem_bytes(chunk: int) -> int:
    """Shared memory of one block of P1's conv phases (from the kernel)."""
    return _build.lib().agp_p1_smem_bytes(chunk)


def fused_eca_block_concat(x, mask, w1, w2, scale1, bias1, scale2, bias2,
                           w_eca, z: int, wd=None, scale_d=None, bias_d=None,
                           chunk: int = 3):
    """K3's arguments (``fused_eca_block_sm``) plus ``chunk``, the taps per
    concatenated group (1, 3 or 9).  Returns [B,X,Y,Z*Cout] bf16."""
    _build.check(chunk in CHUNKS, f"fused_eca_block_concat: chunk {chunk} "
                 f"not in {CHUNKS}")
    ds = () if wd is None else (wd, scale_d, bias_d)
    if not _build.on_cuda(x, mask, w1, w2, scale1, bias1, scale2, bias2,
                          w_eca, *ds):
        return eca_block_concat_plain(x, mask, w1, w2, scale1, bias1, scale2,
                                      bias2, w_eca, z, wd, scale_d, bias_d,
                                      chunk)
    b, xd, yd, zci, zco = bev_block_sm.check_block_args(
        "fused_eca_block_concat", x, w1, w2, z, wd, 32, 32)
    _build.check(smem_bytes(chunk) <= SMEM_LIMIT,
                 f"fused_eca_block_concat: chunk {chunk} needs "
                 f"{smem_bytes(chunk)} bytes of shared memory")
    x = x.contiguous()
    m = mask.contiguous()
    h = torch.empty((b, xd, yd, zco), dtype=_BF16, device=x.device)
    _build.call("agp_p1_conv1", x, m, w1.to(_BF16).contiguous(),
                scale1.float().contiguous(), bias1.float().contiguous(), h,
                b, xd, yd, zci, zco, z, chunk)
    g = torch.empty_like(h)
    pool = torch.zeros((b, zco), dtype=torch.float32, device=x.device)
    _build.call("agp_p1_conv2_pool", h, m, w2.to(_BF16).contiguous(),
                scale2.float().contiguous(), bias2.float().contiguous(), g,
                pool, b, xd, yd, zco, z, chunk)
    # the ECA phase and the combine are K3's (their math is identical)
    out = bev_block_sm.eca_combine(x, m, g, pool, w_eca, z, wd, scale_d,
                                   bias_d)
    fused_eca_block_concat.launches += 1
    return out


fused_eca_block_concat.launches = 0
