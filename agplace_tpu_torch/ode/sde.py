"""SDE / CDE integrators (``agplace_tpu/ode/sde.py``).

* ``sdeint_euler``: Ito Euler-Maruyama with diagonal noise over fixed steps.
  JAX draws its Brownian increments from split ``jax.random`` keys, which
  torch cannot reproduce; here they come from an explicit
  ``torch.Generator`` (or are given as standard normals, ``normals``), and
  the step rule is JAX's: ``y + dt * mu(y) + sigma(y) * (z * sqrt(dt))``.
* ``cdeint``: a neural controlled differential equation dz = f(z) dX over a
  piecewise-linear control path, ``substeps`` Euler or rk4 steps per
  segment of the reparametrised ODE dz/ds = f(z) X'(s).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from agplace_tpu_torch.ode.integrators import fixed_steps


def sdeint_euler(mu_fn: Callable, sigma_fn: Callable, y0: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 t0: float = 0.0, t1: float = 1.0, step_size: float = 0.1,
                 normals: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Integrate dY = mu(Y) dt + sigma(Y) dW from t0 to t1; returns Y(t1).
    ``normals`` [n_steps, *y0.shape] are the standard normal draws of the
    increments; without them each step draws ``torch.randn`` from
    ``generator`` (on y0's device)."""
    n_steps = fixed_steps(step_size, t0, t1)
    dt = (t1 - t0) / n_steps
    sqrt_dt = torch.sqrt(torch.full((), dt, dtype=y0.dtype,
                                    device=y0.device))
    if normals is not None and normals.shape != (n_steps, *y0.shape):
        raise ValueError(f"normals {tuple(normals.shape)} != "
                         f"{(n_steps, *y0.shape)}")
    y = y0
    for n in range(n_steps):
        z = (normals[n] if normals is not None else
             torch.randn(y.shape, generator=generator, dtype=y.dtype,
                         device=y.device))
        y = y + dt * mu_fn(y) + sigma_fn(y) * (z * sqrt_dt)
    return y


def cdeint(func: Callable, z0: torch.Tensor, path: torch.Tensor,
           method: str = "euler", substeps: int = 2) -> torch.Tensor:
    """Neural CDE: ``func(z) -> [..., hidden, control]``, ``path`` [..., T,
    control] observations at uniform times; returns z at the last one.
    Any ``method`` but ``"rk4"`` takes Euler steps, as in JAX."""
    dx = path[..., 1:, :] - path[..., :-1, :]  # [..., T-1, control]
    h = 1.0 / substeps
    z = z0
    for seg in range(dx.shape[-2]):
        dxi = dx[..., seg, :]

        def fz(v):
            return torch.einsum("...hc,...c->...h", func(v), dxi)

        for _ in range(substeps):
            if method == "rk4":
                k1 = fz(z)
                k2 = fz(z + h / 2 * k1)
                k3 = fz(z + h / 2 * k2)
                k4 = fz(z + h * k3)
                z = z + h / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
            else:
                z = z + h * fz(z)
    return z

