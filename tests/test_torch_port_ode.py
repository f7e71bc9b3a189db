"""The port's ODE library held against the JAX package on the CPU: the
fixed-step integrators, dopri5 (y(1), the accepted steps and their times,
and gradients through its masked loop), the adjoint's gradients, the SDE
step with the same Brownian increments, the CDE, FCODE on every route of
JAX's K1 gate, ``QKVAttention`` and ``BeltramiODE`` (its top-k ties lowest
index first).  Inputs are made with numpy from a seed.

Tolerances, fractions of the output's largest magnitude: fp32 integrators
1e-6 (summation order of the products only); gradients 1e-5.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from agplace_tpu.config import ODEConfig as JaxODEConfig
from agplace_tpu.models import fusion as jax_fusion
from agplace_tpu.ode import integrators as jax_int
from agplace_tpu.ode import sde as jax_sde
from agplace_tpu_torch.config import ODEConfig
from agplace_tpu_torch.models import fusion
from agplace_tpu_torch.ode import integrators, sde
from agplace_tpu_torch.ops import ode_step
from agplace_tpu_torch.utils.convert import load_jax_variables

from test_torch_port_mm_options import close, random_variables

torch.set_num_threads(1)

TOL, GRAD_TOL = 1e-6, 1e-5
DT_TOL = 5e-2  # dopri5's step sizes (see below)


def _field(rng, d=8, scale=0.3):
    a = (rng.standard_normal((d, d)) * scale).astype(np.float32)
    b = (rng.standard_normal(d) * 0.1).astype(np.float32)
    return a, b


def _fields(kind, a, b):
    """(JAX f(t, y), port f(t, y)) of one vector field."""
    aj, at = jnp.asarray(a), torch.from_numpy(a)
    bj, bt = jnp.asarray(b), torch.from_numpy(b)
    if kind == "tanh":
        return (lambda t, y: jnp.tanh(y @ aj + bj),
                lambda t, y: torch.tanh(y @ at + bt))
    if kind == "linear":
        return lambda t, y: y @ aj, lambda t, y: y @ at
    if kind == "nonautonomous":  # dx/dt = t: x(1) = x0 + 0.5
        return (lambda t, y: jnp.full_like(y, 1.0) * t,
                lambda t, y: torch.ones_like(y) * t)
    if kind == "stiff":  # relaxation onto cos t at rate 50
        return (lambda t, y: -50.0 * (y - jnp.cos(t)) + y @ aj * 0.1,
                lambda t, y: -50.0 * (y - torch.cos(t)) + y @ at * 0.1)
    raise ValueError(kind)


@pytest.mark.parametrize("method", ["euler", "midpoint", "rk4"])
@pytest.mark.parametrize("step", [0.1, 0.3, 0.05])
def test_fixed_step_methods_match(method, step):
    rng = np.random.default_rng(0)
    a, b = _field(rng)
    y0 = rng.standard_normal((4, 8)).astype(np.float32)
    fj, ft = _fields("tanh", a, b)
    want = jax_int.odeint_fixed(fj, jnp.asarray(y0), 0.0, 1.0, step, method)
    got = integrators.odeint_fixed(ft, torch.from_numpy(y0), 0.0, 1.0, step,
                                   method)
    close(got.numpy(), want, TOL)


def _jax_dopri5_times(fj, y0, **kw):
    """y(1) of JAX's dopri5 and the start time of each of its attempts
    (the first of every 7 stage calls; ordered debug callbacks)."""
    calls = []

    def f(t, y):
        jax.debug.callback(lambda tt: calls.append(float(tt)), t,
                           ordered=True)
        return fj(t, y)

    y = jax.jit(lambda y: jax_int.odeint_dopri5(f, y, **kw))(y0)
    jax.effects_barrier()
    return y, calls[::7]


@pytest.mark.parametrize("kind,rtol", [("linear", 1e-5), ("tanh", 1e-3),
                                       ("nonautonomous", 1e-3),
                                       ("stiff", 1e-4)])
def test_dopri5_matches_steps_and_times(kind, rtol):
    """The same y(1), the same number of accepted steps, at the same times
    (the attempts' start times; a rejected step repeats its start)."""
    rng = np.random.default_rng(1)
    a, b = _field(rng, scale=0.6 if kind == "tanh" else 0.3)
    y0 = rng.standard_normal((3, 8)).astype(np.float32)
    fj, ft = _fields(kind, a, b)
    kw = dict(rtol=rtol, atol=rtol, max_steps=64)
    want, times_j = _jax_dopri5_times(fj, jnp.asarray(y0), **kw)
    times = []

    def f(t, y):
        times.append(float(t))
        return ft(t, y)

    got, steps = integrators.odeint_dopri5(f, torch.from_numpy(y0),
                                           return_steps=True, **kw)
    attempts = times[::7]

    def taken(ts):  # which attempts were accepted (their start advanced)
        return [t1 != t0 for t0, t1 in zip(ts, ts[1:])]

    assert times_j[-1] == 1.0  # finished within max_steps: the count is
    assert taken(attempts) == taken(times_j)  # every change of the start
    assert int(steps) == sum(taken(times_j)) >= 3
    # y5 - y4 cancels, so the error estimate carries the stage sums'
    # rounding (1e-7 of y against an estimate near rtol * y): the step
    # sizes agree to DT_TOL (measured 1.4e-2 at rtol 1e-5, 0 for dx/dt = t)
    # and y(1) to TOL * 10 (measured 3.2e-7)
    np.testing.assert_allclose(attempts, times_j, rtol=DT_TOL, atol=1e-7)
    close(got.numpy(), want, TOL * 10)
    if kind == "stiff":  # rejected attempts repeat their start time
        assert not all(taken(times_j)[:int(steps)])


def test_dopri5_gradients_match():
    """Backprop through the masked loop (the controller detached, as JAX's
    ``stop_gradient``)."""
    rng = np.random.default_rng(2)
    w0 = (rng.standard_normal((6, 6)) * 0.5).astype(np.float32)
    x0 = rng.standard_normal((2, 6)).astype(np.float32)

    def loss_j(w, x):
        out = jax_int.odeint(lambda t, y: jnp.tanh(y @ w), x,
                             method="dopri5", max_steps=32)
        return jnp.sum(out ** 2)

    gw_j, gx_j = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(w0),
                                                   jnp.asarray(x0))
    w = torch.from_numpy(w0).requires_grad_(True)
    x = torch.from_numpy(x0).requires_grad_(True)
    out = integrators.odeint(lambda t, y: torch.tanh(y @ w), x,
                             method="dopri5", max_steps=32)
    (out ** 2).sum().backward()
    close(w.grad.numpy(), gw_j, GRAD_TOL)
    close(x.grad.numpy(), gx_j, GRAD_TOL)


@pytest.mark.parametrize("method,step", [("rk4", 0.05), ("euler", 0.1),
                                         ("midpoint", 0.3)])
def test_adjoint_gradients_match(method, step):
    rng = np.random.default_rng(3)
    w0 = (rng.standard_normal((5, 5)) * 0.2).astype(np.float32)
    b0 = (rng.standard_normal(5) * 0.1).astype(np.float32)
    x0 = rng.standard_normal((3, 5)).astype(np.float32)

    def loss_j(p, x):
        out = jax_int.odeint_adjoint(
            lambda pp, t, y: jnp.tanh(y @ pp[0] + pp[1]), p, x,
            step_size=step, method=method)
        return jnp.sum(out ** 2)

    (gw_j, gb_j), gx_j = jax.grad(loss_j, argnums=(0, 1))(
        (jnp.asarray(w0), jnp.asarray(b0)), jnp.asarray(x0))
    w, bb, x = (torch.from_numpy(v).requires_grad_(True)
                for v in (w0, b0, x0))
    out = integrators.odeint_adjoint(
        lambda pp, t, y: torch.tanh(y @ pp[0] + pp[1]), (w, bb), x,
        step_size=step, method=method)
    (out ** 2).sum().backward()
    for g, want in ((w.grad, gw_j), (bb.grad, gb_j), (x.grad, gx_j)):
        close(g.numpy(), want, GRAD_TOL)
    if method == "rk4":  # and direct backprop, as JAX's own test holds it
        w2, x2 = (torch.from_numpy(v).requires_grad_(True) for v in (w0, x0))
        out = integrators.odeint_fixed(
            lambda t, y: torch.tanh(y @ w2 + torch.from_numpy(b0)), x2,
            step_size=step, method="rk4")
        (out ** 2).sum().backward()
        np.testing.assert_allclose(w.grad.numpy(), w2.grad.numpy(),
                                   rtol=0.01, atol=1e-4)
        np.testing.assert_allclose(x.grad.numpy(), x2.grad.numpy(),
                                   rtol=0.01, atol=1e-4)


def test_sdeint_step_matches_with_the_same_increments():
    rng = np.random.default_rng(4)
    a, b = _field(rng, d=6)
    y0 = rng.standard_normal((3, 6)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    mu_j = lambda y: jnp.tanh(y @ jnp.asarray(a))  # noqa: E731
    sig_j = lambda y: 0.3 * jax.nn.sigmoid(y)  # noqa: E731
    want = jax_sde.sdeint_euler(mu_j, sig_j, jnp.asarray(y0), key,
                                step_size=0.25)
    # JAX's increments: one normal draw per split key
    z = np.stack([np.asarray(jax.random.normal(k, y0.shape, jnp.float32))
                  for k in jax.random.split(key, 4)])
    mu = lambda y: torch.tanh(y @ torch.from_numpy(a))  # noqa: E731
    sig = lambda y: 0.3 * torch.sigmoid(y)  # noqa: E731
    got = sde.sdeint_euler(mu, sig, torch.from_numpy(y0), step_size=0.25,
                           normals=torch.from_numpy(z))
    close(got.numpy(), want, TOL)
    # from a generator: reproducible; sigma = 0 is Euler with dt = 1 / n
    g1, g2 = (torch.Generator().manual_seed(3) for _ in range(2))
    r1 = sde.sdeint_euler(mu, sig, torch.from_numpy(y0), g1)
    r2 = sde.sdeint_euler(mu, sig, torch.from_numpy(y0), g2)
    assert torch.equal(r1, r2)
    det = sde.sdeint_euler(mu, lambda y: 0 * y, torch.from_numpy(y0), g1)
    want = jax_sde.sdeint_euler(mu_j, lambda y: 0 * y, jnp.asarray(y0), key)
    close(det.numpy(), want, TOL)


@pytest.mark.parametrize("method", ["euler", "rk4"])
def test_cdeint_matches(method):
    rng = np.random.default_rng(5)
    h, c = 6, 3
    w = (rng.standard_normal((h, h * c)) * 0.3).astype(np.float32)
    z0 = rng.standard_normal((2, h)).astype(np.float32)
    path = np.cumsum(rng.standard_normal((2, 5, c)), axis=1).astype(
        np.float32)
    fj = lambda z: jnp.tanh(z @ jnp.asarray(w)).reshape(  # noqa: E731
        *z.shape[:-1], h, c)
    ft = lambda z: torch.tanh(z @ torch.from_numpy(w)).reshape(  # noqa
        *z.shape[:-1], h, c)
    want = jax_sde.cdeint(fj, jnp.asarray(z0), jnp.asarray(path), method)
    got = sde.cdeint(ft, torch.from_numpy(z0), torch.from_numpy(path),
                     method)
    close(got.numpy(), want, TOL)


# ------------------------------------------------------------ FCODE
FCODE_CASES = {
    "euler-k1": dict(),  # JAX's gate open: K1 (interpret mode in JAX)
    "euler-no-pallas": dict(use_pallas=False),
    "euler-step0.3": dict(step_size=0.3),  # non-uniform steps
    "midpoint": dict(method="midpoint"),
    "rk4": dict(method="rk4"),
    "dopri5": dict(method="dopri5"),
}


@pytest.mark.parametrize("case", list(FCODE_CASES))
def test_fcode_routes_and_matches(case, monkeypatch):
    """FCODE against JAX's on each side of its K1 gate: K1's Function only
    where JAX takes its kernel, ``odeint`` everywhere else."""
    rng = np.random.default_rng(6)
    over = FCODE_CASES[case]
    x = rng.standard_normal((4, 256)).astype(np.float32)
    mod_j = jax_fusion.FCODE(256, "tanh", JaxODEConfig(**over))
    v = random_variables(mod_j, rng, x)
    want = jax.jit(mod_j.apply)(v, x)
    mod = fusion.FCODE(256, "tanh", ODEConfig(**over))
    load_jax_variables(mod, v)
    calls = {"k1": 0, "odeint": 0}
    real_k1, real_int = ode_step.euler_ode, fusion.odeint

    def spy(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call

    monkeypatch.setattr(ode_step, "euler_ode", spy("k1", real_k1))
    monkeypatch.setattr(fusion, "odeint", spy("odeint", real_int))
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
    close(got.numpy(), want, TOL * 10)
    k1 = case == "euler-k1"
    assert calls == {"k1": int(k1),
                     "odeint": int(not k1 and case != "dopri5")}
    if case == "dopri5":
        assert int(mod.accepted_steps) >= 1


# ------------------------------------------------------ graph-ODE blocks
def test_qkv_attention_matches():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 12, 32)).astype(np.float32)
    mod_j = jax_fusion.QKVAttention(32, num_heads=4)
    v = random_variables(mod_j, rng, x)
    want = mod_j.apply(v, x)
    mod = fusion.QKVAttention(32, num_heads=4)
    load_jax_variables(mod, v)
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
    close(got.numpy(), want, TOL * 10)


def test_topk_ties_lowest_index_first():
    rng = np.random.default_rng(8)
    vals = rng.integers(0, 4, (6, 3, 40)).astype(np.float32)  # many ties
    for k in (1, 5, 16, 40):
        want_v, want_i = jax.lax.top_k(jnp.asarray(vals), k)
        got_v, got_i = fusion.topk_lowest_index(torch.from_numpy(vals), k)
        np.testing.assert_array_equal(got_i.numpy(), want_i)
        np.testing.assert_array_equal(got_v.numpy(), want_v)


@pytest.mark.parametrize("method", ["euler", "rk4"])
def test_beltrami_matches_with_ties(method):
    """Repeated tokens give equal similarities: the kNN graph breaks the
    ties lowest index first, as ``lax.top_k``."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 24, 16)).astype(np.float32)
    x[:, 12:] = x[:, :12]  # every token twice: ties in every row
    ode = dict(method=method, step_size=0.25)
    mod_j = jax_fusion.BeltramiODE(16, k=5, ode=JaxODEConfig(**ode))
    v = random_variables(mod_j, rng, x)
    want = mod_j.apply(v, x)
    mod = fusion.BeltramiODE(16, k=5, ode=ODEConfig(**ode))
    load_jax_variables(mod, v)
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
    close(got.numpy(), want, TOL * 10)
    g = torch.from_numpy(x).requires_grad_(True)
    mod(g).square().sum().backward()
    assert torch.isfinite(g.grad).all() and g.grad.abs().sum() > 0
