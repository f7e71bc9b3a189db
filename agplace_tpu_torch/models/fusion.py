"""Neural-ODE fusion blocks (``agplace_tpu/models/fusion.py``).

* ``FCODE`` / ``DiffBlock`` / ``FuseBlockToShallow``: the stage-1 chain.
  FCODE integrates dx/dt = act(xW + b) with Euler steps in fp32 whatever
  the activation dtype; ``use_pallas`` routes it to K1 through its
  autograd Function (``ode_step.euler_ode``), in eval and in training.
* ``BasicBlock2D``, ``Basic``, ``FFNFuse``, ``GeM2D`` and the BEV branch of
  ``Stage2FuseBlockAdd`` (the voxel refine is a K3 call).

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
from agplace_tpu_torch.ops import ode_step
from agplace_tpu_torch.sparse.bev_grid import (
    BEVConv,
    BEVECABasicBlock,
    BEVGrid,
    BEVMinkGeM,
    bev_global_avg,
    mask_bev,
)


class FCODE(nn.Module):
    """dx/dt = act(x @ kernel + bias) over t in [0, 1] (Euler only).
    ``kernel`` keeps the flax [in, out] layout (it is not a Dense)."""

    def __init__(self, dim: int, act: Optional[str] = "relu",
                 ode: ODEConfig = ODEConfig()):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(dim, dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.act = act or "id"
        self.n_steps = max(int(-(-1.0 // ode.step_size)), 1)
        if (ode.method != "euler"
                or abs(self.n_steps * ode.step_size - 1.0) >= 1e-9):
            raise NotImplementedError(
                f"FCODE: the port integrates uniform Euler steps only "
                f"(method={ode.method!r}, step={ode.step_size})")
        self.dt = ode.step_size
        self.use_pallas = ode.use_pallas

    def forward(self, x):
        x = x.float()
        run = (ode_step.euler_ode if self.use_pallas
               else ode_step.euler_ode_plain)
        return run(x, self.kernel, self.bias, self.n_steps, self.dt,
                   self.act)


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
    """Stage-2 fusion, ``stg2_type='full'`` with the BEV voxel branch:
    project the fused vector into each modality, broadcast-add into the
    maps, refine (BasicBlock2D / ECA block), GeM-pool, and fold pooled 1x1
    projections back into the fused vector through FFNFuse.
    Returns (fusevec, imgoutvec, voxoutvec)."""

    def __init__(self, fusedim: int, imgdim: int, voxdim: int,
                 with_vox: bool, nlayers: int = 1,
                 stg2fuse_type: str = "basic", use_proj: bool = True,
                 dtype: torch.dtype = torch.float32,
                 bev_pallas: bool = False):
        super().__init__()
        if not use_proj:
            raise NotImplementedError("stg2_useproj=False")
        self.nlayers = nlayers
        self.has_vox = with_vox
        for i in range(nlayers):
            setattr(self, f"proj_fuse_img_{i}", Dense(fusedim, imgdim))
            setattr(self, f"ffn_img_{i}", BasicBlock2D(imgdim, dtype))
            setattr(self, f"pool_img_{i}", GeM2D())
            setattr(self, f"proj_img_fuse_{i}",
                    Conv2d(imgdim, fusedim, 1, 1, 0, True, dtype))
            setattr(self, f"ffn_fuse_{i}", FFNFuse(fusedim, stg2fuse_type))
            if self.has_vox:  # the voxel map arrives with voxdim channels
                setattr(self, f"proj_fuse_vox_{i}", Dense(fusedim, voxdim))
                setattr(self, f"ffn_vox_{i}",
                        BEVECABasicBlock(voxdim, voxdim, bev_pallas))
                setattr(self, f"pool_vox_{i}", BEVMinkGeM())
                setattr(self, f"proj_vox_fuse_{i}",
                        BEVConv(voxdim, fusedim, 1))

    def forward(self, imgmap, voxmap: Optional[BEVGrid], fusevec):
        imgoutvec = voxoutvec = None
        for i in range(self.nlayers):
            layer = lambda name: getattr(self, f"{name}_{i}")  # noqa: E731
            imgmap = imgmap + layer("proj_fuse_img")(fusevec)[:, None, None]
            if voxmap is not None:
                add = layer("proj_fuse_vox")(fusevec).repeat(1, voxmap.z)
                vfeats = mask_bev(
                    voxmap.feats + add[:, None, None].to(voxmap.feats.dtype),
                    voxmap.mask, voxmap.z)
                voxmap = voxmap.replace(feats=vfeats)
            imgmap = layer("ffn_img")(imgmap)
            if voxmap is not None:
                voxmap = layer("ffn_vox")(voxmap)
            imgoutvec = layer("pool_img")(imgmap)
            if voxmap is not None:
                voxoutvec = layer("pool_vox")(voxmap)
            fusevec = fusevec + layer("proj_img_fuse")(imgmap).mean(
                dim=(1, 2))
            if voxmap is not None:
                fusevec = fusevec + bev_global_avg(
                    layer("proj_vox_fuse")(voxmap))
            fusevec = layer("ffn_fuse")(fusevec)
        return fusevec, imgoutvec, voxoutvec
