"""Neural-ODE integrators (``agplace_tpu/ode/integrators.py``).

* Fixed-step methods (euler / midpoint / rk4): a Python loop over the
  static step count; autograd differentiates straight through it.  The
  step times are JAX's fp32 ones: ``min(t0 + i * h, t1)`` and the step
  ``min(t0 + (i + 1) * h, t1) - min(t0 + i * h, t1)``, so a step of 0.1 is
  not exactly 0.1 everywhere, as in JAX.
* ``dopri5``: exactly ``max_steps`` attempts with a PI step-size controller;
  rejected steps and finished trajectories idle under ``torch.where``.  The
  time, the step and the error are fp32 tensors on the state's device (no
  Python float, no host sync), and the controller's error is detached
  (JAX's ``stop_gradient``), so with the same arithmetic the same steps are
  accepted.
* ``odeint_adjoint``: an autograd Function whose backward integrates the
  augmented system ``(-f, a df/dy, a df/dp)`` forwards in the reparametrised
  time ``s = t1 + t0 - t`` with the same fixed stepper.

States are a tensor or a tuple / list of states (the adjoint integrates a
``(y, a, grad_p)`` tuple through the same steppers).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

Func = Callable[[torch.Tensor, object], object]  # f(t, y) -> dy/dt


def _tree_map(fn, *trees):
    if isinstance(trees[0], (tuple, list)):
        return type(trees[0])(_tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def _first_leaf(tree) -> torch.Tensor:
    while isinstance(tree, (tuple, list)):
        tree = tree[0]
    return tree


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d fp32 tensor on ``like``'s device, filled by a kernel (no
    host-to-device copy)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# fixed-step methods
# ---------------------------------------------------------------------------

def _axpy(a, x, y):
    """y + a * x over states."""
    return _tree_map(lambda yi, xi: yi + a * xi, y, x)


def _euler_step(func: Func, t, dt, y):
    return _axpy(dt, func(t, y), y)


def _midpoint_step(func: Func, t, dt, y):
    k1 = func(t, y)
    return _axpy(dt, func(t + dt / 2, _axpy(dt / 2, k1, y)), y)


def _rk4_step(func: Func, t, dt, y):
    k1 = func(t, y)
    k2 = func(t + dt / 2, _axpy(dt / 2, k1, y))
    k3 = func(t + dt / 2, _axpy(dt / 2, k2, y))
    k4 = func(t + dt, _axpy(dt, k3, y))
    ksum = _tree_map(lambda a, b, c, d: a + 2 * b + 2 * c + d, k1, k2, k3,
                     k4)
    return _axpy(dt / 6, ksum, y)


FIXED_STEPPERS = {
    "euler": _euler_step,
    "midpoint": _midpoint_step,
    "rk4": _rk4_step,
}
METHODS = (*FIXED_STEPPERS, "dopri5")


def fixed_steps(step_size: float, t0: float = 0.0, t1: float = 1.0) -> int:
    """ceil((t1 - t0) / step_size), at least 1 (torchdiffeq's count)."""
    return max(int(-(-(t1 - t0) // step_size)), 1)


def odeint_fixed(func: Func, y0, t0: float = 0.0, t1: float = 1.0,
                 step_size: float = 0.1, method: str = "euler"):
    """Fixed-step integration from t0 to t1; returns y(t1).  The last step
    is shortened to land on t1."""
    stepper = FIXED_STEPPERS[method]
    n_steps = fixed_steps(step_size, t0, t1)
    like = _first_leaf(y0)
    i = torch.arange(n_steps, dtype=torch.float32, device=like.device)
    h = _f32(step_size, like)
    ts = torch.clamp(t0 + i * h, max=t1)
    dts = torch.clamp(t0 + (i + 1.0) * h, max=t1) - ts
    y = y0
    for n in range(n_steps):
        y = stepper(func, ts[n], dts[n], y)
    return y


# ---------------------------------------------------------------------------
# dopri5 (adaptive Runge-Kutta 4(5), Dormand-Prince) with a PI controller
# ---------------------------------------------------------------------------

_DP_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_DP_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DP_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DP_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
          187 / 2100, 1 / 40)


def _dopri5_step(func: Func, t, dt, y):
    """(y5, y5 - y4).  Every coefficient meets the fp32 ``dt`` as a Python
    scalar, which the op rounds to fp32 as JAX rounds its weak constants."""
    ks = []
    for i in range(7):
        yi = y
        for j, a in enumerate(_DP_A[i]):
            yi = yi + dt * a * ks[j]
        ks.append(func(t + _DP_C[i] * dt, yi))
    y5 = y
    y4 = y
    for i in range(7):
        y5 = y5 + dt * _DP_B5[i] * ks[i]
        y4 = y4 + dt * _DP_B4[i] * ks[i]
    return y5, y5 - y4


def odeint_dopri5(func: Func, y0: torch.Tensor, t0: float = 0.0,
                  t1: float = 1.0, rtol: float = 1e-3, atol: float = 1e-3,
                  max_steps: int = 64, safety: float = 0.9,
                  return_steps: bool = False):
    """Adaptive dopri5 with a PI(0.7/0.4) step controller over exactly
    ``max_steps`` attempts; returns y(t1), and with ``return_steps`` also
    the number of accepted steps (an int64 0-d tensor on y's device)."""
    t = _f32(t0, y0)
    dt = _f32((t1 - t0) / 10.0, y0)
    prev_err = _f32(1.0, y0)
    t_end = _f32(t1, y0)
    accepted = torch.zeros((), dtype=torch.int64, device=y0.device)
    y = y0
    for _ in range(max_steps):
        done = t >= t_end
        dt_eff = torch.minimum(dt, t_end - t)
        y_new, err_vec = _dopri5_step(func, t, dt_eff, y)
        scale = atol + rtol * torch.maximum(y.abs(), y_new.abs())
        # the step-size control is a discrete decision: no gradient
        # through it (and none through sqrt at an exactly-zero error)
        err2 = ((err_vec / scale) ** 2).mean().detach()
        err = torch.sqrt(torch.clamp(err2, min=1e-20))
        err = torch.clamp(err, min=1e-10)
        accept = err <= 1.0
        factor = safety * err ** (-0.14) * prev_err ** 0.08
        factor = torch.clamp(factor, 0.2, 5.0)
        new_dt = dt_eff * factor
        take = accept & ~done
        t = torch.where(done, t, torch.where(accept, t + dt_eff, t))
        y = torch.where(take, y_new, y)
        prev_err = torch.where(accept, err, prev_err)
        dt = torch.where(done, dt, new_dt)
        accepted = accepted + take.to(torch.int64)
    return (y, accepted) if return_steps else y


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------

def odeint(func: Func, y0, t0: float = 0.0, t1: float = 1.0,
           method: str = "euler", step_size: float = 0.1,
           rtol: float = 1e-3, atol: float = 1e-3, max_steps: int = 64):
    """Integrate f from t0 to t1 and return y(t1) (torchdiffeq's
    ``odeint(...)[-1]``)."""
    if method in FIXED_STEPPERS:
        return odeint_fixed(func, y0, t0, t1, step_size, method)
    if method == "dopri5":
        return odeint_dopri5(func, y0, t0, t1, rtol, atol, max_steps)
    raise NotImplementedError(f"odeint method={method}")


# ---------------------------------------------------------------------------
# adjoint (optimise-then-discretise): memory O(1) in the step count
# ---------------------------------------------------------------------------

class _Adjoint(torch.autograd.Function):
    @staticmethod
    def forward(ctx, func, t0, t1, method, step_size, y0, *params):
        with torch.no_grad():
            y1 = odeint_fixed(lambda t, y: func(params, t, y), y0, t0, t1,
                              step_size, method)
        ctx.func, ctx.cfg = func, (t0, t1, method, step_size)
        ctx.save_for_backward(y1, *params)
        return y1

    @staticmethod
    def backward(ctx, g):
        y1, *params = ctx.saved_tensors
        func = ctx.func
        t0, t1, method, step_size = ctx.cfg

        def aug_dyn_s(s, state):
            # s = t1 + t0 - t runs forwards while t runs backwards:
            #   dy/ds = -f(t, y), da/ds = a df/dy, dgp/ds = a df/dp
            y, a, _ = state
            t = t1 + t0 - s
            with torch.enable_grad():
                yy = y.detach().requires_grad_(True)
                pp = tuple(p.detach().requires_grad_(True) for p in params)
                f_y = func(pp, t, yy)
                grads = torch.autograd.grad(f_y, (yy, *pp), a,
                                            allow_unused=True)
            grads = [torch.zeros_like(v) if gv is None else gv
                     for v, gv in zip((yy, *pp), grads)]
            return (-f_y.detach(), grads[0], tuple(grads[1:]))

        state0 = (y1, g, tuple(torch.zeros_like(p) for p in params))
        _, a_t, gp_t = odeint_fixed(aug_dyn_s, state0, t0, t1, step_size,
                                    method)
        return (None, None, None, None, None, a_t, *gp_t)


def odeint_adjoint(func_with_params: Callable, params: Sequence[torch.Tensor],
                   y0: torch.Tensor, t0: float = 0.0, t1: float = 1.0,
                   method: str = "euler", step_size: float = 0.1
                   ) -> torch.Tensor:
    """Adjoint-method odeint for the fixed-step solvers.
    ``func_with_params(params, t, y) -> dy/dt`` with ``params`` the tuple
    of tensors given here; gradients reach ``y0`` and every parameter
    through the backward integration, not through stored activations."""
    if method not in FIXED_STEPPERS:
        raise NotImplementedError(f"odeint_adjoint method={method}")
    return _Adjoint.apply(func_with_params, t0, t1, method, step_size, y0,
                          *tuple(params))

