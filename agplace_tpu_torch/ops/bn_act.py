"""The eval-mode epilogue of a ResNet conv in one pass: BatchNorm's affine,
an optional residual (itself through its own BatchNorm, or not) and ReLU.

No TPU kernel stands behind it (XLA fuses the chain into the conv there);
it takes the eager chain of ``models/resnet.py`` off the card's
elementwise passes.  The CUDA kernel (``csrc/bn_act.cu``) reads each input
map once and writes the result once, bit-equal to ``bn_act_plain``, which
*is* that chain in PyTorch ops: ``x * s.to(dt) + b.to(dt)`` (``norm.py``),
``+ idn``, ``torch.relu``.  Its three instances follow the operands:
``residual`` None (a block's ``bn1``, the stem tail), a residual as it is
(the identity shortcut) or a residual with its own ``residual_affine``
(the downsample shortcut, whose BN is never stored).

``fused_bn_act.launches`` counts the kernel's launches.  ``bn_act_grid`` is
the launch geometry, its one source; ``resnet18_epilogues`` lists the maps
and instances one ResNet-18 trunk forward launches.
"""

from __future__ import annotations

from functools import lru_cache
from math import gcd
from typing import Optional, Tuple

import torch

from agplace_tpu_torch.ops import _build

# the kernel's name on the card (a function template of csrc/bn_act.cu)
KERNEL_NAME = "bn_act_kernel"
# threads per block (the kernel's compiled value), blocks per SM at most
BLOCK, BLOCKS_PER_SM = 256, 8
# 16-byte vectors in flight per thread and loop step
UNROLL = 4
DTYPES = (torch.bfloat16, torch.float32)


def bn_act_grid(n_vec: int, cv: int, sms: int) -> int:
    """The kernel's blocks over ``n_vec`` 16-byte vectors, ``cv`` to a
    pixel.  Thread t of grid x BLOCK takes vectors t, t + stride, ...
    (stride = grid x BLOCK), so all of them are channel group t % cv once
    the stride is a multiple of cv.  As many blocks as give each thread
    ``UNROLL`` vectors, at most ``BLOCKS_PER_SM`` per SM of ``sms`` (a
    persistent grid), rounded up to a multiple of cv / gcd(cv, BLOCK)."""
    step = cv // gcd(cv, BLOCK)
    grid = min(-(-n_vec // (BLOCK * UNROLL)), BLOCKS_PER_SM * sms)
    return -(-grid // step) * step


def resnet18_epilogues(h: int, w: int, stages: int = 3):
    """The epilogues one eval forward of a ResNet-18 trunk of ``stages``
    stages launches over [h, w] images (``models/resnet.py``), in order:
    ([H, W, C] of the map, instance), the instance 0 for relu(bn), 1 with
    the identity shortcut, 2 with the downsample's BN.  The stem conv, the
    max-pool and every stage after the first halve each side, rounded up;
    stage i has 64 * 2 ** i channels and two blocks, the first of a later
    stage with a downsample."""
    h, w = -(-h // 2), -(-w // 2)
    out = [((h, w, 64), 0)]
    for i in range(stages):
        h, w = -(-h // 2), -(-w // 2)
        m = (h, w, 64 << i)
        out += [(m, 0), (m, 2 if i else 1), (m, 0), (m, 1)]
    return out


@lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def fits(*maps: Optional[torch.Tensor]) -> bool:
    """Whether the kernel takes these maps (x's shape and dtype, as the
    wrapper checks first) as they are: bf16 or fp32, NHWC dense and 16-byte
    aligned, C a multiple of 8."""
    return all(t.dtype in DTYPES and t.shape[-1] % 8 == 0
               and t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in maps if t is not None)


def bn_act_plain(x, scale, bias, residual=None, residual_affine=None):
    """The eager chain: ``x * s + b`` in x's dtype (``BatchNorm2D``'s eval
    affine), plus the residual (through ``x * s_d + b_d`` first when
    ``residual_affine`` is given), then ReLU."""
    dt = x.dtype
    y = x * scale.to(dt) + bias.to(dt)
    if residual is not None:
        if residual_affine is not None:
            sd, bd = residual_affine
            residual = residual * sd.to(dt) + bd.to(dt)
        y = y + residual
    return torch.relu(y)


def fused_bn_act(x, scale, bias, residual=None,
                 residual_affine: Optional[Tuple[torch.Tensor,
                                                 torch.Tensor]] = None,
                 out: Optional[torch.Tensor] = None):
    """relu(x * s + b [+ r | + (r * s_d + b_d)]) of an NHWC map x, scale /
    bias (and ``residual_affine``'s) fp32 [C], in x's dtype, written into
    ``out`` (may be x itself) or a new tensor.  The residual and ``out``
    must be of x's shape and dtype; on the card the maps must ``fit``
    besides: anything else raises.  On the CPU the plain version runs."""
    c = x.shape[-1]
    affines = [scale, bias, *(residual_affine or ())]
    _build.check(all(tuple(a.shape) == (c,) for a in affines),
                 f"fused_bn_act: every scale and bias must be [{c}]")
    _build.check(residual_affine is None or residual is not None,
                 "fused_bn_act: residual_affine without a residual")
    _build.check(all(t.dtype == x.dtype and t.shape == x.shape
                     for t in (residual, out) if t is not None),
                 "fused_bn_act: the residual and out must be of x's shape "
                 "and dtype")
    ops = [t for t in (x, residual, out) if t is not None]
    if not _build.on_cuda(*ops, *affines):
        y = bn_act_plain(x, scale, bias, residual, residual_affine)
        return y if out is None else out.copy_(y)
    _build.check(fits(x, residual, out),
                 f"fused_bn_act: maps {tuple(x.shape)} {x.dtype} must be "
                 f"dense, 16-byte aligned, bf16 or fp32 and C % 8 == 0")
    if out is None:
        out = torch.empty_like(x)
    vw = 16 // x.element_size()
    n_vec, cv = x.numel() // vw, c // vw
    grid = bn_act_grid(n_vec, cv, _sms(x.device))
    sd, bd = (residual_affine if residual_affine is not None
              else (None, None))
    res = 0 if residual is None else (1 if residual_affine is None else 2)
    f32 = [None if a is None else a.float().contiguous()
           for a in (scale, bias, sd, bd)]
    if n_vec:  # an empty map is done
        _build.call("agp_bn_act", x, residual, out, *f32, n_vec, cv,
                    int(x.dtype == torch.float32), res, grid, BLOCK)
        fused_bn_act.launches += 1
    return out


fused_bn_act.launches = 0
