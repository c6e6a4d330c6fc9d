"""The port's root finding (cosmoprimo_tpu_torch/ops/roots.py::bracket) and
batched ``Cosmology.solve`` against the JAX package's, on the same
cosmologies made from a seed with numpy; the port solves every row in one
call, the JAX package one cosmology at a time (jitted and vmapped where its
solve traces).

Bars:
- bracket: the end points rtol 1e-15 (the same steps in float64);
- solve: the solved parameter per row rtol 1e-12 against the JAX solve
  (measured <= 4.3e-15: the same Ridders iterates on f values that agree
  to ~1e-16), and the solution's own f within the bar that ``xtol``
  implies, |df/dx| * xtol (measured 1.5e-9 of it for theta_MC_100);
- theta_MC_100 itself: rtol 1e-12 (measured 2.2e-16).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

import cosmoprimo_tpu as jcp  # noqa: E402
from cosmoprimo_tpu.ops import roots as jroots  # noqa: E402
from cosmoprimo_tpu_torch import Cosmology, CosmologyInputError  # noqa: E402
from cosmoprimo_tpu_torch.ops.roots import bracket  # noqa: E402

B = 2
RTOL = 1e-12


def params(seed=0):
    rng = np.random.default_rng(seed)
    return dict(omega_cdm=rng.uniform(0.11, 0.13, B), omega_b=rng.uniform(0.021, 0.023, B),
                n_s=rng.uniform(0.94, 0.98, B), logA=rng.uniform(2.9, 3.1, B))


def port_cosmology(p, **kwargs):
    return Cosmology(engine='eisenstein_hu', h=0.7, **{name: torch.from_numpy(v) for name, v in p.items()}, **kwargs)


def jax_cosmology(p, i, **kwargs):
    return jcp.Cosmology(engine='eisenstein_hu', h=0.7, **{name: float(v[i]) for name, v in p.items()}, **kwargs)


@pytest.mark.parametrize('init', ['pair', 'triple'])
def test_bracket_against_jax(init):
    """Per-row brackets of f(x) = x^3 - c from x1 = 0.5, given (x1, dx) or
    (x1, dx, f1): rows that step once, many times, never (f1 = 0), or run
    out of steps."""
    c = np.array([0.2, 8.0, 0.125, 1e6])
    dx = np.array([0.1, -0.05, 0.1, -0.01])

    def f(x):
        return x ** 3 - (torch.from_numpy(c) if isinstance(x, torch.Tensor) else c)

    x1 = np.full(c.size, 0.5)
    port_init = (torch.from_numpy(x1), torch.from_numpy(dx)) + ((f(torch.from_numpy(x1)),) if init != 'pair' else ())
    lo, hi = bracket(f, port_init, maxiter=15)
    for i in range(c.size):
        def jf(x, i=i):
            return x ** 3 - c[i]
        jinit = (x1[i], dx[i]) + ((jf(x1[i]),) if init != 'pair' else ())
        ref = np.asarray(jroots.bracket(jf, jinit, maxiter=15))
        np.testing.assert_allclose([lo[i].item(), hi[i].item()], ref, rtol=1e-15, atol=0)
    assert bool((lo <= hi).all())


def jax_rows(func, p, *extra):
    """``func(omega_cdm, omega_b, n_s, logA, *extra)`` of the JAX package,
    jitted and vmapped over the rows of ``p``."""
    names = ('omega_cdm', 'omega_b', 'n_s', 'logA')
    return np.asarray(jax.jit(jax.vmap(func))(*[jnp.asarray(p[n]) for n in names], *map(jnp.asarray, extra)))


def test_theta_MC_100_against_jax():
    p = params()
    port = port_cosmology(p)
    got = port['theta_MC_100'].numpy()
    assert got.shape == (B,) and port.engine['theta_MC_100'].shape == (B,)

    def theta(oc, ob, ns, logA):
        return jcp.Cosmology(engine='eisenstein_hu', h=0.7, omega_cdm=oc, omega_b=ob, n_s=ns, logA=logA)['theta_MC_100']

    np.testing.assert_allclose(got, jax_rows(theta, p), rtol=RTOL)


def test_solve_theta_MC_100_against_jax():
    """solve('h', 'theta_MC_100', target) with one target per row: the CLASS
    guess, the secant-scaled bracket, Ridders to xtol = 1e-6."""
    p = params()
    targets = np.random.default_rng(1).uniform(1.035, 1.045, B)
    sol = port_cosmology(p).solve('h', 'theta_MC_100', target=torch.from_numpy(targets))

    def jsolve(oc, ob, ns, logA, target):
        cosmo = jcp.Cosmology(engine='eisenstein_hu', h=0.7, omega_cdm=oc, omega_b=ob, n_s=ns, logA=logA)
        return cosmo.solve('h', 'theta_MC_100', target=target)['h']

    np.testing.assert_allclose(sol['h'].numpy(), jax_rows(jsolve, p, targets), rtol=RTOL)
    # d theta_MC_100 / dh from a central difference: |theta - target| <= slope * xtol
    slope = (sol.clone(h=sol['h'] + 1e-4)['theta_MC_100'] - sol.clone(h=sol['h'] - 1e-4)['theta_MC_100']) / 2e-4
    assert bool(((sol['theta_MC_100'] - torch.from_numpy(targets)).abs() <= slope.abs() * 1e-6).all())


def test_solve_callable_and_names_against_jax():
    """A callable (chi(z = 1), stepping h by its default step), a derived
    parameter's name for a parameter without a default step (Omega_m by
    omega_cdm: the relative secant step), explicit limits with the H0
    parameterisation, and an explicit init; each row against the eager JAX
    solve."""
    p = params(2)
    port = port_cosmology(p)
    chi_target = port.comoving_radial_distance(1.0) * 1.02
    cases = [('h', lambda c: c.comoving_radial_distance(1.0), chi_target.numpy(), {}),
             ('omega_cdm', 'Omega_m', np.array([0.30, 0.31]), {}),
             ('H0', 'Omega_m', np.array([0.27, 0.26]), dict(limits=(60.0, 80.0))),
             ('h', lambda c: c['Omega_m'], 0.28, dict(init=0.75))]
    for param, func, target, kwargs in cases:
        sol = port.solve(param, func, target=torch.as_tensor(target, dtype=torch.float64), **kwargs)
        got = sol[param].numpy()
        for i in range(B):
            ref = jax_cosmology(p, i).solve(param, func, target=float(np.broadcast_to(target, (B,))[i]), **kwargs)
            np.testing.assert_allclose(got[i], float(ref[param]), rtol=RTOL, err_msg=param)


def test_solve_errors():
    cosmo = port_cosmology(params())
    with pytest.raises(CosmologyInputError, match='callable'):
        cosmo.solve('h', 3.0)
    # no sign change inside explicit limits: that row is NaN, nothing raises
    sol = cosmo.solve('h', 'Omega_m', target=torch.tensor([0.3, 5.0], dtype=torch.float64), limits=(0.5, 0.9))
    assert np.isfinite(sol['h'][0].item()) and np.isnan(sol['h'][1].item())
