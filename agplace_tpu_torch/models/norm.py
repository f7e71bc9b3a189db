"""BatchNorm with fp32 statistics and the affine in the activation dtype
(``agplace_tpu/models/norm.py``).

The effective affine is computed in fp32 and applied in the activation
dtype, one multiply and one add, exactly as the JAX ``BatchNorm2D`` does
(``norm.py:49-78``):

    y = x * scale' + bias',  scale' = rsqrt(var + eps) * scale,
                             bias'  = bias - mean * scale'

Eval mode reads the running statistics.  Training mode takes the batch's
mean and E[x^2] in fp32 over every axis but the last, the biased variance
``msq - mean^2`` (no clamp), and moves the running statistics to
``0.9 * old + 0.1 * batch``, the biased variance included (torch's
``nn.BatchNorm2d`` stores the unbiased one, so it is not a drop-in).

The BEV voxel branch uses the same module with masked statistics
(``sparse/bev_grid.bn_apply``); its callers tile the affine over the
folded z axis.

Under data parallelism (``train/step.py``) each rank holds a block of the
batch, and the moments are the global batch's, as JAX's under GSPMD: a
BN's ``group`` (a ``parallel.mesh.MeshAxis``, set by ``moments_over``)
has the count, the sums and the sums of squares all-reduced in fp32, one
differentiable all-reduce per layer, before the division.  The masked
BNs' counts differ by rank, which is why the count is reduced too.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from agplace_tpu_torch.parallel.mesh import MeshAxis, all_reduce_sum


def _global(cnt: torch.Tensor, s: torch.Tensor, sq: torch.Tensor,
            group: MeshAxis):
    """(count, sums, sums of squares) summed over the ranks of ``group``
    in one all-reduce."""
    c = s.shape[0]
    v = all_reduce_sum(torch.cat([cnt.reshape(1), s, sq]), group)
    return v[0], v[1:c + 1], v[c + 1:]


def masked_moments(x: torch.Tensor, m: torch.Tensor, dims: Sequence[int],
                   group: Optional[MeshAxis] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 (mean, biased variance) per channel of ``x`` over ``dims``,
    counting only where the broadcast mask ``m`` is set (ME's batch norm):
    the count clamped to at least 1, the variance to at least 0; over the
    ranks of ``group`` when given."""
    f, m = x.float(), m.float()
    dims = tuple(dims)
    cnt, s, sq = m.sum(), (f * m).sum(dim=dims), (f.square() * m).sum(dim=dims)
    if group is not None:
        cnt, s, sq = _global(cnt, s, sq, group)
    cnt = torch.clamp(cnt, min=1.0)
    mean = s / cnt
    return mean, torch.clamp(sq / cnt - mean.square(), min=0.0)


@contextlib.contextmanager
def moments_over(towers, group: Optional[MeshAxis]):
    """Every ``BatchNorm2D`` of ``towers`` (modules, None skipped) takes
    its training-mode moments over the ranks of ``group`` inside the
    block."""
    bns = [m for t in towers if t is not None for m in t.modules()
           if isinstance(m, BatchNorm2D)]
    for bn in bns:
        bn.group = group
    try:
        yield
    finally:
        for bn in bns:
            bn.group = None


class BatchNorm2D(nn.Module):
    def __init__(self, c: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.eps = eps
        self.momentum = momentum
        self.group: Optional[MeshAxis] = None  # see moments_over

    def affine(self, z: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
        """fp32 (scale', bias') of the running statistics, tiled ``z``
        times for the folded layout."""
        return self.batch_affine(self.running_mean.float(),
                                 self.running_var.float(), z)

    def batch_affine(self, mean: torch.Tensor, var: torch.Tensor,
                     z: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
        """fp32 (scale', bias') of the given statistics, tiled ``z``
        times; differentiable in the statistics and the affine."""
        inv = torch.rsqrt(var + self.eps)
        w = self.weight.float()
        s = inv * w
        b = self.bias.float() - mean * inv * w
        return s.repeat(z), b.repeat(z)

    def track(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """Move the running statistics towards a batch's (in place)."""
        with torch.no_grad():
            for run, new in ((self.running_mean, mean),
                             (self.running_var, var)):
                run.copy_(self.momentum * run
                          + (1 - self.momentum) * new.detach())

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # x [..., C]
        if self.training:
            axes = tuple(range(x.ndim - 1))
            x32 = x.float()
            cnt, s, sq = (x32.new_tensor(x32.numel() // x32.shape[-1]),
                          x32.sum(dim=axes), x32.square().sum(dim=axes))
            if self.group is not None:
                cnt, s, sq = _global(cnt, s, sq, self.group)
            mean = s / cnt
            var = sq / cnt - mean.square()
            self.track(mean, var)
            s, b = self.batch_affine(mean, var)
        else:
            s, b = self.affine()
        return x * s.to(x.dtype) + b.to(x.dtype)
