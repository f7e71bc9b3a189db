"""Neural-ODE fusion blocks (``agplace_tpu/models/fusion.py``).

* ``FCODE`` / ``DiffBlock`` / ``FuseBlockToShallow``: the stage-1 chain.
  FCODE integrates dx/dt = act(x @ kernel + bias) in fp32 whatever the
  activation dtype.  JAX's K1 gate decides the route: ``use_pallas`` with
  uniform Euler steps goes to K1 through its autograd Function
  (``ode_step.euler_ode``), in eval and in training; anything else (midpoint,
  rk4, dopri5, a step that does not divide [0, 1], ``use_pallas`` off) goes
  through ``ode.integrators.odeint``.
* ``BasicBlock2D``, ``Basic``, ``FFNFuse``, ``GeM2D`` and
  ``Stage2FuseBlockAdd`` with each voxel backend: the BEV refine is a K3
  call in eval mode, the dense and sparse ones their ECA blocks; with
  ``use_proj=False`` the fused vector adds into the maps as it is.
* ``QKVAttention`` and ``BeltramiODE``, the graph-ODE blocks of the
  ``stg2gnn`` variants; ``MM`` calls neither, as in JAX.

Dtype promotion follows jnp: e.g. a bf16 map plus an fp32 projection is
fp32, a bf16 conv of it rounds back to bf16 (``fusion.py:267-299``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from agplace_tpu_torch.config import ODEConfig
from agplace_tpu_torch.models.layers import Conv2d, Dense, LayerNorm
from agplace_tpu_torch.models.norm import BatchNorm2D
from agplace_tpu_torch.models.pooling import GeM
from agplace_tpu_torch.ode.integrators import (fixed_steps, odeint,
                                               odeint_dopri5)
from agplace_tpu_torch.ops import ode_step
from agplace_tpu_torch.retrieval.knn import _ascending_topk
from agplace_tpu_torch.sparse import dense_grid, modules, voxels
from agplace_tpu_torch.sparse.bev_grid import (
    BEVConv,
    BEVECABasicBlock,
    BEVMinkGeM,
    bev_global_avg,
    mask_bev,
)

_ACTS = {"id": lambda v: v, "relu": torch.relu, "tanh": torch.tanh,
         "sigmoid": torch.sigmoid}


class FCODE(nn.Module):
    """dx/dt = act(x @ kernel + bias) over t in [0, 1].  ``kernel`` keeps
    the flax [in, out] layout (it is not a Dense).  With ``dopri5`` the
    number of accepted steps of the last forward stays on the device in
    ``accepted_steps``."""

    def __init__(self, dim: int, act: Optional[str] = "relu",
                 ode: ODEConfig = ODEConfig()):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(dim, dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.act = act or "id"
        self.ode = ode
        self.n_steps = fixed_steps(ode.step_size)
        uniform = abs(self.n_steps * ode.step_size - 1.0) < 1e-9
        # JAX's K1 gate (fusion.py:58-69); x is always [B, dim] here
        self.use_k1 = ode.use_pallas and ode.method == "euler" and uniform
        self.accepted_steps = None

    def forward(self, x):
        x = x.float()
        if self.use_k1:
            return ode_step.euler_ode(x, self.kernel, self.bias,
                                      self.n_steps, self.ode.step_size,
                                      self.act)
        act, w, b = _ACTS[self.act], self.kernel, self.bias

        def func(t, y):
            return act(y @ w + b)

        o = self.ode
        if o.method == "dopri5":
            y, self.accepted_steps = odeint_dopri5(
                func, x, rtol=o.rtol, atol=o.atol,
                max_steps=o.dopri5_max_steps, return_steps=True)
            return y
        return odeint(func, x, method=o.method, step_size=o.step_size)


class DiffBlock(nn.Module):
    """Sum of ODE blocks parsed from ``diff_type`` (e.g. 'fcode@relu')."""

    def __init__(self, dim: int, ode: ODEConfig = ODEConfig()):
        super().__init__()
        self.parts = []
        for i, spec in enumerate(ode.diff_type.split("_")):
            kind, act = spec.split("@")
            if kind != "fcode":
                raise NotImplementedError(f"diff block kind {kind}")
            setattr(self, f"fcode_{i}", FCODE(dim, act, ode))
            self.parts.append(getattr(self, f"fcode_{i}"))

    def forward(self, x):
        return sum(p(x) for p in self.parts)


class FuseBlockToShallow(nn.Module):
    """Stage-1 deep-to-shallow ODE fusion over per-scale pooled vectors."""

    def __init__(self, dims: Tuple[int, ...], img_dims: Tuple[int, ...],
                 vox_dims: Optional[Tuple[int, ...]],
                 ode: ODEConfig = ODEConfig()):
        super().__init__()
        n = len(dims)
        fuse_dim = dims[-1]
        self.n = n
        self.backward_order = ode.diff_direction == "backward"
        for i in range(n):
            setattr(self, f"diff_{i}", DiffBlock(fuse_dim, ode))
            if i < n - 1:
                setattr(self, f"updim_img_{i}", Dense(img_dims[i], fuse_dim))
                if vox_dims is not None:
                    setattr(self, f"updim_vox_{i}",
                            Dense(vox_dims[i], fuse_dim))

    def forward(self, imageveclist: Sequence[torch.Tensor],
                voxveclist: Optional[Sequence[torch.Tensor]] = None):
        n = self.n
        order = range(n - 1, -1, -1) if self.backward_order else range(n)
        fusevec = 0.0
        for i in order:
            v = imageveclist[i]
            if i < n - 1:
                v = getattr(self, f"updim_img_{i}")(v)
            fusevec = fusevec + v
            if voxveclist is not None:
                v = voxveclist[i]
                if i < n - 1:
                    v = getattr(self, f"updim_vox_{i}")(v)
                fusevec = fusevec + v
            fusevec = getattr(self, f"diff_{i}")(fusevec)
        return fusevec


class BasicBlock2D(nn.Module):
    """Dense conv residual block (convs with bias, BN), NHWC."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(dim, dim, 3, 1, 1, True, dtype)
        self.bn1 = BatchNorm2D(dim)
        self.conv2 = Conv2d(dim, dim, 3, 1, 1, True, dtype)
        self.bn2 = BatchNorm2D(dim)

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return torch.relu(out + x)


class Basic(nn.Module):
    """Residual MLP block: fc -> LN -> relu -> fc -> LN, + identity, relu."""

    def __init__(self, dim: int):
        super().__init__()
        self.fc1, self.ln1 = Dense(dim, dim), LayerNorm(dim)
        self.fc2, self.ln2 = Dense(dim, dim), LayerNorm(dim)

    def forward(self, x):
        out = torch.relu(self.ln1(self.fc1(x)))
        out = self.ln2(self.fc2(out))
        return torch.relu(out + x)


class FFNFuse(nn.Module):
    def __init__(self, dim: int, stg2fuse_type: str = "basic"):
        super().__init__()
        self.parts = []
        for i, e in enumerate(stg2fuse_type.split("_")):
            if e != "basic":
                raise NotImplementedError(f"stg2fuse_type {e}")
            setattr(self, f"basic_{i}", Basic(dim))
            self.parts.append(getattr(self, f"basic_{i}"))

    def forward(self, x):
        return sum(p(x) for p in self.parts)


GeM2D = GeM  # same math (the reference duplicates the class)


class Stage2FuseBlockAdd(nn.Module):
    """Stage-2 fusion, ``stg2_type='full'``: project the fused vector into
    each modality (or add it as it is with ``use_proj=False``),
    broadcast-add it into the maps, refine (BasicBlock2D / the backend's
    ECA block), GeM-pool, and fold the pooled (1x1-projected) maps back
    into the fused vector through FFNFuse.  ``vox_backend``: "bev", "dense",
    "sparse", or None without a voxel map.  Returns (fusevec, imgoutvec,
    voxoutvec)."""

    def __init__(self, fusedim: int, imgdim: int, voxdim: int,
                 vox_backend: Optional[str], nlayers: int = 1,
                 stg2fuse_type: str = "basic", use_proj: bool = True,
                 dtype: torch.dtype = torch.float32,
                 bev_pallas: bool = False):
        super().__init__()
        self.nlayers = nlayers
        self.backend = vox_backend
        self.use_proj = use_proj
        for i in range(nlayers):
            if use_proj:
                setattr(self, f"proj_fuse_img_{i}", Dense(fusedim, imgdim))
                setattr(self, f"proj_img_fuse_{i}",
                        Conv2d(imgdim, fusedim, 1, 1, 0, True, dtype))
            setattr(self, f"ffn_img_{i}", BasicBlock2D(imgdim, dtype))
            setattr(self, f"pool_img_{i}", GeM2D())
            setattr(self, f"ffn_fuse_{i}", FFNFuse(fusedim, stg2fuse_type))
            if vox_backend is None:
                continue
            # the voxel map arrives with voxdim channels
            if use_proj:
                setattr(self, f"proj_fuse_vox_{i}", Dense(fusedim, voxdim))
            if vox_backend == "bev":
                ffn, pool = BEVECABasicBlock(voxdim, voxdim,
                                             bev_pallas), BEVMinkGeM()
                proj = BEVConv(voxdim, fusedim, 1)
            elif vox_backend == "dense":
                ffn = dense_grid.GridECABasicBlock(voxdim, voxdim)
                pool = dense_grid.GridMinkGeM()
                proj = dense_grid.GridConv(voxdim, fusedim, 1)
            elif vox_backend == "sparse":
                ffn, pool = modules.ECABasicBlock(voxdim, voxdim), \
                    modules.MinkGeM()
                proj = modules.SparseConv(voxdim, fusedim, 1)
            else:
                raise NotImplementedError(f"voxel backend {vox_backend!r}")
            setattr(self, f"ffn_vox_{i}", ffn)
            setattr(self, f"pool_vox_{i}", pool)
            if use_proj:
                setattr(self, f"proj_vox_fuse_{i}", proj)

    def _add(self, voxmap, v: torch.Tensor):
        """ME_broadcast_add: ``v`` [B, C] into every occupied voxel."""
        if self.backend == "bev":
            add = v.repeat(1, voxmap.z)[:, None, None].to(voxmap.feats.dtype)
            return mask_bev(voxmap.feats + add, voxmap.mask, voxmap.z)
        lead = (slice(None),) + (None,) * (voxmap.feats.ndim - 2)
        return torch.where(voxmap.mask[..., None], voxmap.feats + v[lead],
                           0.0)

    def _avg(self, voxmap) -> torch.Tensor:
        return {"bev": bev_global_avg, "dense": dense_grid.grid_global_avg,
                "sparse": voxels.masked_global_avg}[self.backend](voxmap)

    def forward(self, imgmap, voxmap, fusevec, vox_keys=None):
        imgoutvec = voxoutvec = None
        for i in range(self.nlayers):
            layer = lambda name: getattr(self, f"{name}_{i}")  # noqa: E731
            v = (layer("proj_fuse_img")(fusevec) if self.use_proj
                 else fusevec)
            imgmap = imgmap + v[:, None, None]
            if voxmap is not None:
                v = (layer("proj_fuse_vox")(fusevec) if self.use_proj
                     else fusevec)
                voxmap = voxmap.replace(feats=self._add(voxmap, v))
            imgmap = layer("ffn_img")(imgmap)
            if voxmap is not None:
                if self.backend == "sparse":
                    voxmap, _ = layer("ffn_vox")(voxmap, vox_keys)
                else:
                    voxmap = layer("ffn_vox")(voxmap)
            imgoutvec = layer("pool_img")(imgmap)
            if voxmap is not None:
                voxoutvec = layer("pool_vox")(voxmap)
            img_fuse = (layer("proj_img_fuse")(imgmap) if self.use_proj
                        else imgmap)
            fusevec = fusevec + img_fuse.mean(dim=(1, 2))
            if voxmap is not None:
                vox_fuse = voxmap
                if self.use_proj and self.backend == "sparse":
                    vox_fuse, _ = layer("proj_vox_fuse")(voxmap, vox_keys)
                elif self.use_proj:
                    vox_fuse = layer("proj_vox_fuse")(voxmap)
                fusevec = fusevec + self._avg(vox_fuse)
            fusevec = layer("ffn_fuse")(fusevec)
        return fusevec, imgoutvec, voxoutvec


# ---------------------------------------------------------------------------
# Graph-ODE blocks (reference network_mm/gnns.py, the --stg2gnn variants)
# ---------------------------------------------------------------------------


class QKVAttention(nn.Module):
    """Multi-head self-attention over tokens [B, N, C]: both products with
    fp32 accumulation and a plain softmax, as JAX computes them (no fused
    attention kernel, whose rounding differs)."""

    def __init__(self, dim: int, num_heads: int = 8):
        super().__init__()
        self.fc_q, self.fc_k, self.fc_v = (Dense(dim, dim) for _ in range(3))
        self.num_heads = num_heads

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        h = self.num_heads

        def heads(fc):
            return fc(x).reshape(b, n, h, c // h).transpose(1, 2).float()

        q, k, v = heads(self.fc_q), heads(self.fc_k), heads(self.fc_v)
        attn = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
        return (attn @ v).transpose(1, 2).reshape(b, n, c)


def topk_lowest_index(values: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: the k largest, descending, equal
    values lowest index first (``torch.topk`` promises no order among
    ties).  Returns (values gathered from ``values``, so differentiable,
    and int64 indices)."""
    lead, n = values.shape[:-1], values.shape[-1]
    neg = values.detach().reshape(-1, n).float().neg()
    _, idx = _ascending_topk(neg, k)
    idx = idx.reshape(*lead, k)
    return torch.gather(values, -1, idx), idx


class BeltramiODE(nn.Module):
    """Beltrami graph diffusion (``gnns.py:64-102``): learned positions ->
    cosine kNN graph (``topk_lowest_index``) -> softmax-weighted neighbour
    aggregation as dx/dt, integrated over [0, 1] with ``odeint``."""

    def __init__(self, dim: int, k: int = 16, ode: ODEConfig = ODEConfig()):
        super().__init__()
        self.fc_kernel = nn.Parameter(torch.empty(dim, 2 * dim))
        self.fc_bias = nn.Parameter(torch.zeros(2 * dim))
        self.k, self.ode = k, ode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        k = min(self.k, n)
        w, bias = self.fc_kernel, self.fc_bias

        def func(t, y):
            feat_pos = y @ w + bias
            feat, pos = feat_pos[..., :c], feat_pos[..., c:]
            pos = pos / torch.clamp(torch.linalg.vector_norm(
                pos, dim=-1, keepdim=True), min=1e-12)
            sim = pos @ pos.transpose(-1, -2)
            topksim, topkid = topk_lowest_index(sim, k)  # [B, N, k]
            rows = torch.arange(b, device=y.device)[:, None, None]
            tk = feat[rows, topkid]  # [B, N, k, C]
            attn = torch.softmax(topksim, dim=-1)
            return (attn[..., None] * tk).sum(dim=-2)

        o = self.ode
        return odeint(func, x, method=o.method, step_size=o.step_size,
                      rtol=o.rtol, atol=o.atol, max_steps=o.dopri5_max_steps)
