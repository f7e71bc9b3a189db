"""The attention core of CCT's bf16 encoder in one pass: y = softmax(q k^T
d^-1/2) v for every batch row and head, read straight from the qkv Dense's
output [B, N, 3, H, 64] and written as the [B, N, H, 64] that ``proj``
reads.

No TPU kernel stands behind it: the JAX package's attention
(``agplace_tpu/models/cct.py:102-106``) is plain einsum / softmax left to
XLA.  On the H100 that explicit chain (two einsums with their permute
copies, the scale pass and softmax, each over the [B, h, N, N] scores in
HBM) spends 25x the core's bound at CCT-14's 576 tokens.  The CUDA kernel
(``csrc/attention_sm90.cu``) keeps the scores on chip: TMA loads of q, k
and v, SS wgmma for the scores, the online softmax in registers and RS
wgmma for AV, with the eager chain's rounding points where it has them
(the scores rounded once to bf16 and scaled by an exact 1/8, the softmax
in fp32, the probabilities rounded to bf16 as AV's operand; but
unnormalised, AV scaled by the fp32 reciprocal of the row sum after it).
It is not bit-equal to the chain; ``attention_plain`` *is* the chain, what
the CPU runs.

``fused_attention.launches`` counts the kernel's launches.
``attention_tiling`` is the launch geometry, its one source.  The check
that holds the kernel to an fp32 attention (``CHECK_SHAPES``,
``ERR_MARGIN``, ``ERR_APART``, ``row_err``) is defined here once, for the
card's tests and ``chip_smoke.py`` [attention].
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch

from agplace_tpu_torch.ops import _build

# the kernel's name on the card (csrc/attention_sm90.cu)
KERNEL_NAME = "attention_kernel"
HEAD_DIM = 64  # the one head size it takes: a row is one 128-byte swizzle
# The kernel's compiled tiles: a work item is Q_ROWS query rows of one
# (batch row, head), 64 a consumer warpgroup; keys go in blocks of KV_ROWS
# through a ring of STAGES blocks; each warpgroup's Q tile double-buffered
Q_ROWS, KV_ROWS, STAGES = 192, 64, 6
WARPGROUPS = Q_ROWS // 64
THREADS = 128 * WARPGROUPS + 32  # and one producer warp
TILE_BYTES = 64 * HEAD_DIM * 2  # 64 rows of one head
SMEM_BYTES = (2 * WARPGROUPS + 2 * STAGES) * TILE_BYTES + 1024  # + alignment
SMEM_LIMIT = 232448  # a block's dynamic shared memory on Hopper (227 KB)


class AttentionTiling(NamedTuple):
    q_tiles: int  # work items of one (batch row, head): ceil(N / Q_ROWS)
    kv_steps: int  # KV blocks a work item walks: ceil(N / KV_ROWS)
    items: int  # B * H * q_tiles, a head's query tiles adjacent
    grid: int  # persistent blocks, each walking items blockIdx, + grid, ...


def attention_tiling(batch: int, heads: int, n: int,
                     sms: int) -> AttentionTiling:
    """The kernel's launch geometry for [batch, n, 3, heads, 64] on a card
    of ``sms`` SMs: one block per SM (its 416 threads take the registers of
    one), no more blocks than work items."""
    q_tiles = -(-n // Q_ROWS)
    items = batch * heads * q_tiles
    return AttentionTiling(q_tiles, -(-n // KV_ROWS), items,
                           min(items, sms))


def item_coords(t: AttentionTiling, heads: int, item: int):
    """Work item -> (batch row, head, query tile), as the kernel maps it."""
    qt, bh = item % t.q_tiles, item // t.q_tiles
    return bh // heads, bh % heads, qt


def live_keys(n: int, step: int) -> int:
    """Keys of KV block ``step`` below n; the kernel sets the others' scores
    to -inf before the max."""
    return min(KV_ROWS, n - step * KV_ROWS)


def stored_rows(n: int, q_tile: int) -> int:
    """Query rows of a work item below n; the kernel stores no other."""
    return min(Q_ROWS, n - q_tile * Q_ROWS)


# The shapes the kernel is checked at on the card, [B, N] of qkv [B, N, 3,
# 6, 64]: the GeoLoc cell's, one image, N = 196 (cct384 at --resize 224)
# and Ns off the 64-key and 192-row tiles
CHECK_SHAPES = ((128, 576), (1, 576), (128, 196), (5, 333), (3, 1))
# The kernel rounds at the eager bf16 chain's points but normalises after
# AV (the chain rounds the normalised probabilities), so neither is the
# other's bits and either may be the nearer one: each is held to an fp32
# attention of the same bf16 q, k, v by ``row_err``, and the kernel's may
# exceed the chain's by at most ERR_MARGIN of it, the two within ERR_APART
# of each other by the widest row.  Measured, the kernel's over the
# chain's: 0.90-1.05 widest and 0.988-0.992 mean on an H100 80GB HBM3 at
# CHECK_SHAPES, its CPU replay 0.83-0.97 and 0.85-0.99 at the tests'
# shapes; N = 1 exact in both; kernel to chain 0.0055-0.0063 widest on
# the H100
ERR_MARGIN, ERR_APART = 1.25, 0.02


def row_err(got: torch.Tensor, want: torch.Tensor):
    """(widest, mean) relative L2 error of the rows [..., d] of ``got``
    to ``want`` (fp32)."""
    e = ((got.float() - want).norm(dim=-1)
         / want.norm(dim=-1).clamp(min=1e-30))
    return float(e.max()), float(e.mean())


@lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def fits(qkv: torch.Tensor) -> bool:
    """Whether the kernel takes ``qkv`` [B, N, 3, H, d] as it is: bf16,
    d = 64, dense and 16-byte aligned."""
    return (qkv.dtype == torch.bfloat16 and qkv.shape[-1] == HEAD_DIM
            and qkv.is_contiguous() and qkv.data_ptr() % 16 == 0)


def attention_plain(qkv: torch.Tensor) -> torch.Tensor:
    """The eager chain of ``models/cct.py``: the scores by einsum in qkv's
    dtype, times d^-1/2, softmax, then AV by einsum; [B, N, H, d]."""
    q, k, v = qkv.unbind(dim=2)
    scale = qkv.shape[-1] ** -0.5
    attn = torch.softmax(torch.einsum("bnhd,bmhd->bhnm", q, k) * scale,
                         dim=-1)
    return torch.einsum("bhnm,bmhd->bnhd", attn, v)


def fused_attention(qkv: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T d^-1/2) v of ``qkv`` [B, N, 3, H, d] (q, k, v along
    dim 2), as [B, N, H, d].  On the card ``qkv`` must ``fit``: anything
    else raises.  On the CPU the plain version runs."""
    _build.check(qkv.dim() == 5 and qkv.shape[2] == 3,
                 f"fused_attention: qkv must be [B, N, 3, H, d], not "
                 f"{tuple(qkv.shape)}")
    if not _build.on_cuda(qkv):
        return attention_plain(qkv)
    _build.check(fits(qkv), f"fused_attention: qkv {tuple(qkv.shape)} "
                            f"{qkv.dtype} must be bf16, d = {HEAD_DIM}, "
                            f"dense and 16-byte aligned")
    b, n, _, h, d = qkv.shape
    out = torch.empty(b, n, h, d, dtype=qkv.dtype, device=qkv.device)
    if out.numel():  # no rows or heads: done
        t = attention_tiling(b, h, n, _sms(qkv.device))
        _build.call("agp_attention", qkv, out, b, n, h, *t)
        fused_attention.launches += 1
    return out


fused_attention.launches = 0
