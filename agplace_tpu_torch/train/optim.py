"""Optimizers with per-group learning rates (``agplace_tpu/train/optim.py``).

Both towers train under one optimizer.  Each parameter gets a label from
its flax path (``label_params``): 'db' for the aerial tower, 'pc' for the
query tower's voxel branch, 'base' for the rest; 'crn_layer' for CRN
parameters with ``crn``; 'frozen' for backbone encoder layers up to
``freeze_te``.  Each label has its learning rate (``group_lrs``); 0.0
means no update.

``GroupAdam`` is JAX's fused group Adam: Adam (b1 0.9, b2 0.999, eps
1e-8) over one flat fp32 vector of every parameter, with one step count
shared by all groups, so groups at learning rate 0 still advance their
moments; each element's update is scaled by its group's rate.  Its state
is three flat tensors (mu, nu and the rates) and a host-side count: a step
is about ten elementwise passes over the vector and one foreach add into
the parameters, with no host sync.  ``GroupSGD`` is the SGD option (with
``crn``: weight decay 1e-3 and momentum 0.9).  A parameter that took no
gradient counts as a zero gradient, as in JAX.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from agplace_tpu_torch.config import TrainConfig
from agplace_tpu_torch.utils.convert import flax_path

# query-tower modules trained at the point-cloud rate
_PC_MODULES = ("vox_fe", "vox_pool")
_PC_WEIGHTS = ("vox_weight",)
_TE_LAYER = re.compile(r"_(\d+)$")

Named = Sequence[Tuple[str, torch.nn.Parameter]]


def label_of(keys: Sequence[str], crn: bool = False,
             freeze_te: Optional[int] = None) -> str:
    """The group of the parameter at flax path ``keys`` (tower first)."""
    if crn and any(k == "crn" for k in keys):
        return "crn_layer"
    if freeze_te is not None and "backbone" in keys:
        after = keys[keys.index("backbone") + 1:]
        if after:
            m = _TE_LAYER.search(after[0])
            # indexed encoder layers <= N frozen; the non-indexed stem and
            # embedding frozen whenever freeze_te >= 0
            if m is None or int(m.group(1)) <= freeze_te:
                return "frozen"
    if keys and keys[0] == "db":
        return "db"
    if len(keys) >= 2 and keys[0] == "mm":
        if keys[1] in _PC_MODULES or keys[1] in _PC_WEIGHTS:
            return "pc"
    return "base"


def label_params(named: Named, crn: bool = False,
                 freeze_te: Optional[int] = None) -> Dict[str, str]:
    """{port name: label} for parameters named ``<tower>.<module path>``
    ("mm." / "db."), labelled on their flax paths."""
    return {name: label_of(flax_path(name, p), crn, freeze_te)
            for name, p in named}


def group_lrs(cfg: TrainConfig, crn: bool) -> Dict[str, float]:
    """The learning rate of each label; 0.0 for a group that takes no
    update (an untrained tower, frozen layers)."""
    return {
        "base": cfg.lr if cfg.train_modelq else 0.0,
        "pc": cfg.lrpc if cfg.train_modelq else 0.0,
        "db": ((cfg.lr_crn_net if crn else cfg.lrdb)
               if cfg.train_modeldb else 0.0),
        "crn_layer": cfg.lr_crn_layer,
        "frozen": 0.0,
    }


class _FlatGroups:
    """Parameters seen as one flat fp32 vector, with a rate per element."""

    def __init__(self, named: Named, lrs: Sequence[float]):
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.sizes = [p.numel() for p in self.params]
        dev = self.params[0].device
        self.lr = torch.cat([torch.full((n,), float(lr), device=dev)
                             for n, lr in zip(self.sizes, lrs)])

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def flat_grads(self) -> torch.Tensor:
        return torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1).float()
                          for p in self.params])

    def apply(self, direction: torch.Tensor) -> None:
        """params += -lr * direction (elementwise rates)."""
        upd = direction * -self.lr
        with torch.no_grad():
            torch._foreach_add_(self.params, [
                u.view(p.shape) for u, p in zip(upd.split(self.sizes),
                                                self.params)])

    def per_param(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {n: v.view(p.shape) for n, v, p in
                zip(self.names, flat.split(self.sizes), self.params)}


class GroupAdam(_FlatGroups):
    def __init__(self, named: Named, lrs: Sequence[float], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        super().__init__(named, lrs)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = torch.zeros_like(self.lr)
        self.nu = torch.zeros_like(self.lr)
        self.count = 0

    def step(self) -> None:
        g = self.flat_grads()
        self.count += 1
        self.mu = (1 - self.b1) * g + self.b1 * self.mu
        self.nu = (1 - self.b2) * g.square() + self.b2 * self.nu
        # the bias corrections in fp32, as optax computes them (1 - b2^t
        # cancels: fp64 would differ from it by ~3e-5 at t = 2)
        t = np.float32(self.count)
        mu_hat = self.mu / float(1 - np.float32(self.b1) ** t)
        nu_hat = self.nu / float(1 - np.float32(self.b2) ** t)
        self.apply(mu_hat / (torch.sqrt(nu_hat) + self.eps))

    def moments(self) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        mu, nu = self.per_param(self.mu), self.per_param(self.nu)
        return {n: (mu[n], nu[n]) for n in self.names}

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, sd: dict) -> None:
        self.count = int(sd["count"])
        self.mu = sd["mu"].to(self.lr.device).clone()
        self.nu = sd["nu"].to(self.lr.device).clone()


class GroupSGD(_FlatGroups):
    """Plain SGD; with ``crn`` the reference's CRN-SGD: the gradient plus
    1e-3 x the parameter, through a momentum-0.9 trace."""

    def __init__(self, named: Named, lrs: Sequence[float],
                 crn: bool = False):
        super().__init__(named, lrs)
        self.crn = crn
        self.trace = torch.zeros_like(self.lr) if crn else None

    def step(self) -> None:
        g = self.flat_grads()
        if self.crn:
            flat_p = torch.cat([p.detach().reshape(-1) for p in self.params])
            self.trace = (g + 1e-3 * flat_p) + 0.9 * self.trace
            g = self.trace
        self.apply(g)

    def state_dict(self) -> dict:
        return {"trace": self.trace}

    def load_state_dict(self, sd: dict) -> None:
        if self.crn:
            self.trace = sd["trace"].to(self.lr.device).clone()


def make_optimizer(cfg: TrainConfig, named: Named, crn: bool = False,
                   freeze_te: Optional[int] = None):
    """The optimizer of ``cfg.optim`` over ``named`` parameters."""
    named = list(named)
    lrs = group_lrs(cfg, crn)
    labels = label_params(named, crn, freeze_te)
    rates: List[float] = [lrs[labels[n]] for n, _ in named]
    if cfg.optim == "adam":
        return GroupAdam(named, rates)
    if cfg.optim == "sgd":
        return GroupSGD(named, rates, crn)
    raise NotImplementedError(cfg.optim)
