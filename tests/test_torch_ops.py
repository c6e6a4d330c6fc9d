"""The port's numerical substrate (cosmoprimo_tpu_torch/ops) against the JAX
package's on the same inputs, made from a seed with numpy.

Bar: rtol 1e-12. Both sides compute the same formulas in float64; the
spline solves differ in method (associative scans against one LU), which
moves results by a few ulp times the condition number of the diagonally
dominant spline matrix (< 3). The same bar holds the Magnus solver, whose
prefix products associate in another order (measured 2e-15), sici
(measured 1.4e-17 absolute, an atol of 1e-15 where Ci crosses zero),
interp and Interpolator2D.
"""

import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from cosmoprimo_tpu.ops.odeint import cumquad_rk4 as jcumquad_rk4  # noqa: E402
from cosmoprimo_tpu.ops.odeint import linear_ode2_magnus as jmagnus  # noqa: E402
from cosmoprimo_tpu.ops.special import sici as jsici  # noqa: E402
from cosmoprimo_tpu.ops import quadrature as jquad  # noqa: E402
from cosmoprimo_tpu.ops import spline as jspline  # noqa: E402
from cosmoprimo_tpu_torch.ops import misc, quadrature, special, spline  # noqa: E402
# the module: the package re-exports its odeint function under the same name
odeint = importlib.import_module('cosmoprimo_tpu_torch.ops.odeint')

RTOL = 1e-12


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize('n', [7, 8, 1024])
@pytest.mark.parametrize('even', ['avg', 'first', 'last'])
def test_simpson(n, even):
    rng = np.random.default_rng(n)
    x = np.sort(rng.uniform(0.0, 3.0, n))
    y = rng.normal(size=(3, n))
    ref = np.asarray(jquad.simpson(jnp.asarray(y), x=jnp.asarray(x), even=even))
    got = quadrature.simpson(t(y), x=t(x), even=even).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL)
    ref = np.asarray(jquad.simpson(jnp.asarray(y.T), dx=0.3, axis=0, even=even))
    got = quadrature.simpson(t(y.T), dx=0.3, axis=0, even=even).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL)


def test_cumquad_rk4_batched():
    rng = np.random.default_rng(1)
    a = rng.uniform(0.2, 0.4, 4)
    grid = np.concatenate([np.linspace(0.0, 0.3, 20)[:-1], np.geomspace(0.3, 1e4, 100)])

    def integrand(b, zz):
        return 1.0 / (b * (1 + zz) ** 3 + 1 - b) ** 0.5

    got = odeint.cumquad_rk4(lambda y, zz: integrand(t(a)[:, None], zz), 0.0, t(grid)).numpy()
    assert got.shape == (4, grid.size)
    for row, b in zip(got, a):
        ref = np.asarray(jcumquad_rk4(lambda y, zz: integrand(b, zz), 0.0, jnp.asarray(grid)))
        np.testing.assert_allclose(row, ref, rtol=RTOL)


@pytest.mark.parametrize('n', [3, 119])
def test_natural_cubic_coeffs(n):
    rng = np.random.default_rng(n)
    x = np.sort(rng.uniform(0.0, 10.0, n))
    f = rng.normal(size=(n, 3))
    ref = np.asarray(jspline.natural_cubic_coeffs(jnp.asarray(x), jnp.asarray(f)))
    got = spline.natural_cubic_coeffs(t(x), t(f)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * np.abs(ref).max())


@pytest.mark.parametrize('nu', [0, 1, 2])
def test_cubic_eval(nu):
    rng = np.random.default_rng(nu)
    x = np.sort(rng.uniform(0.0, 10.0, 30))
    f = rng.normal(size=(30, 2))
    M = np.asarray(jspline.natural_cubic_coeffs(jnp.asarray(x), jnp.asarray(f)))
    q = np.concatenate([rng.uniform(-1.0, 11.0, 50), x[:3], x[-2:]])
    ref = np.asarray(jspline.cubic_eval(jnp.asarray(x), jnp.asarray(f), jnp.asarray(M), jnp.asarray(q), nu=nu))
    got = spline.cubic_eval(t(x), t(f), t(M), t(q), nu=nu).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * np.abs(ref).max())


@pytest.mark.parametrize('interp', [('lin', 'lin', False), ('log', 'log', False), ('lin', 'lin', True)])
def test_interpolator1d(interp):
    interp_x, interp_fun, extrap = interp
    rng = np.random.default_rng(2)
    x = rng.permutation(np.geomspace(1e-3, 1e2, 60))
    fun = np.exp(-x[:, None] * np.array([0.1, 0.3])) + 0.5
    q = np.geomspace(1e-4, 1e3, 80).reshape(8, 10)
    ref = np.asarray(jspline.Interpolator1D(x, fun, interp_x=interp_x, interp_fun=interp_fun, extrap=extrap)(q))
    got = spline.Interpolator1D(t(x), t(fun), interp_x=interp_x, interp_fun=interp_fun, extrap=extrap)(t(q)).numpy()
    assert got.shape == ref.shape == (8, 10, 2)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got, ref, rtol=RTOL)
    assert extrap or np.isnan(got[0, 0]).all()


def test_interpolator1d_derivative_and_grad():
    x = np.linspace(0.0, 3.0, 25)
    fun = t(np.sin(x)).requires_grad_(True)
    interp = spline.Interpolator1D(t(x), fun)
    q = t(np.array([0.5, 1.7]))
    ref = np.asarray(jspline.Interpolator1D(x, np.sin(x))(np.array([0.5, 1.7]), dx=1))
    np.testing.assert_allclose(interp(q, dx=1).detach().numpy(), ref, rtol=RTOL)
    grad, = torch.autograd.grad(interp(q).sum(), fun)
    jgrad = np.asarray(jax.jit(jax.grad(lambda f: jspline.Interpolator1D(x, f)(jnp.array([0.5, 1.7])).sum()))(jnp.sin(x)))
    np.testing.assert_allclose(grad.numpy(), jgrad, rtol=RTOL, atol=1e-15)


def test_exception_or_nan():
    def error(value):
        raise ValueError(f'bad {value}')

    value = t(np.array([1.0, -2.0, 3.0]))
    out = misc.exception_or_nan(value, value < 0, error)
    np.testing.assert_array_equal(np.isnan(out.numpy()), [False, True, False])
    assert misc.exception_or_nan(1.0, False, error) == 1.0
    with pytest.raises(ValueError):
        misc.exception_or_nan(-1.0, True, error)


def test_flatarray_shapes():
    class Section(object):
        device = torch.device('cpu')

        @misc.flatarray()
        def f(self, z):
            return t(np.array([1.0, 2.0]))[:, None] * z

    assert Section().f(0.5).shape == (2,)
    assert Section().f(np.ones((3, 4))).shape == (2, 3, 4)


def test_trapezoid_weights():
    x = np.sort(np.random.default_rng(3).uniform(0.0, 5.0, 40))
    np.testing.assert_allclose(quadrature.trapezoid_weights(t(x)).numpy(),
                               np.asarray(jquad.trapezoid_weights(jnp.asarray(x))), rtol=RTOL)


def test_sici():
    x = np.concatenate([np.geomspace(1e-8, 1e4, 2000), [4.0, 4.0 + 1e-12, 100.0, 100.0 + 1e-10]])
    for got, ref in zip(special.sici(t(x)), jax.jit(jsici)(x)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=1e-15)


def test_linear_ode2_magnus():
    """The growth ODE of HMcode's Mead ratios, batched over three parameter
    sets, against the JAX solver run on each."""
    eta = np.linspace(np.log(1e-4), 0.0, 64)
    om = np.array([0.25, 0.3, 0.35])

    def coeffs(xp, e, o):
        a = xp.exp(e)
        Om = o * a ** -3 / (o * a ** -3 + 1 - o)
        return 1.5 * Om - 0.5 * (1 - 3 * (1 - Om)) - 2.0, -0.5 * (1 - 3 * (1 - Om)) - 3.0

    got = odeint.linear_ode2_magnus(lambda e: coeffs(torch, e, t(om)[:, None]), [1.0, 0.0], t(eta)).numpy()
    assert got.shape == (3, 64, 2)
    for row, o in zip(got, om):
        ref = np.asarray(jax.jit(lambda e: jmagnus(lambda ee: coeffs(jnp, ee, o), jnp.array([1.0, 0.0]), e))(eta))
        np.testing.assert_allclose(row, ref, rtol=RTOL)


def test_interp():
    """jnp.interp semantics, with xp shared and per row, queries outside."""
    rng = np.random.default_rng(4)
    xp = np.sort(rng.uniform(0.0, 1.0, (3, 20)), axis=-1)
    fp = rng.normal(size=(3, 20))
    x = rng.uniform(-0.2, 1.2, (3, 7))
    got = spline.interp(t(x), t(xp), t(fp)).numpy()
    for i in range(3):
        np.testing.assert_allclose(got[i], np.asarray(jnp.interp(x[i], xp[i], fp[i])), rtol=RTOL)
    got = spline.interp(t(x), t(xp[0]), t(fp)).numpy()
    for i in range(3):
        np.testing.assert_allclose(got[i], np.asarray(jnp.interp(x[i], xp[0], fp[i])), rtol=RTOL)


@pytest.mark.parametrize('grid', [True, False])
@pytest.mark.parametrize('log', [False, True])
def test_interpolator2d(grid, log):
    rng = np.random.default_rng(5)
    x = rng.permutation(np.geomspace(1e-3, 1e2, 40))
    y = rng.permutation(np.linspace(0.0, 3.0, 7))
    fun = np.exp(-np.outer(x, 1 + y)[..., None] * np.array([0.1, 0.2])) + 0.5   # (nx, ny, 2): a batch of 2
    qx = np.geomspace(5e-4, 2e2, 30)
    qy = np.linspace(-0.1, 3.2, 30) if not grid else np.linspace(-0.1, 3.2, 9)
    kwargs = dict(interp_x='log', interp_fun='log') if log else {}
    port = spline.Interpolator2D(t(x), t(y), t(fun), **kwargs)
    got = port(t(qx), t(qy), grid=grid).numpy()
    assert got.shape == ((30, 9, 2) if grid else (30, 2))
    ref = jax.jit(jax.vmap(lambda f: jspline.Interpolator2D(x, y, f, **kwargs)(qx, qy, grid=grid), in_axes=-1,
                           out_axes=-1))(fun)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL)


@pytest.mark.parametrize('n', [3, 4, 37])
def test_spline_rows(n):
    """Knots per row (the batched tridiagonal scans of
    natural_cubic_coeffs_rows) and evaluation per row against the JAX
    spline built on each row's knots, at rtol 1e-12 of each row's scale."""
    rng = np.random.default_rng(n)
    x = np.sort(rng.uniform(-2.0, 2.0, (5, n)), axis=-1)
    f = np.sin(3 * x) + rng.normal(size=(5, n)) * 0.1
    t = rng.uniform(-2.5, 2.5, (5, 50))
    M = spline.natural_cubic_coeffs_rows(torch.from_numpy(x), torch.from_numpy(f))
    got = spline.cubic_eval_rows(torch.from_numpy(x), torch.from_numpy(f), M, torch.from_numpy(t)).numpy()
    for i in range(5):
        jM = jspline.natural_cubic_coeffs(jnp.asarray(x[i]), jnp.asarray(f[i]))
        np.testing.assert_allclose(M[i].numpy(), np.asarray(jM), rtol=RTOL, atol=RTOL * np.abs(jM).max())
        ref = np.asarray(jspline.cubic_eval(jnp.asarray(x[i]), jnp.asarray(f[i]), jM, jnp.asarray(t[i])))
        np.testing.assert_allclose(got[i], ref, rtol=RTOL, atol=RTOL * np.abs(ref).max())


@pytest.mark.parametrize('nu', [0, 1, 2])
def test_linear_interpolator(nu):
    """The order-1 spline of Interpolator1D (k != 3) against the JAX one."""
    x = np.geomspace(1e-3, 10.0, 40)
    f = np.stack([np.log(x), x ** 2], axis=-1)
    q = np.geomspace(2e-3, 9.0, 25)
    got = spline.Interpolator1D(torch.from_numpy(x), torch.from_numpy(f), k=1, interp_x='log')(torch.from_numpy(q), dx=nu)
    ref = jspline.Interpolator1D(x, f, k=1, interp_x='log')(q, dx=nu)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=1e-15)


def test_romberg_and_gauss_laguerre():
    got = quadrature.romberg(lambda x: torch.stack([torch.exp(-x), x ** 3]), 0.0, 2.0, divmax=8)
    ref = [jquad.romberg(lambda x: jnp.exp(-x), 0.0, 2.0, divmax=8), jquad.romberg(lambda x: x ** 3, 0.0, 2.0, divmax=8)]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL)
    for a, b in zip(quadrature.gauss_laguerre_nodes(100), jquad.gauss_laguerre_nodes(100)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('n', [5, 16, 17, 300, 4097])
def test_cumsum_blocked(n):
    """The blocked cumulative sum lands on the bits of jnp.cumsum on the CPU
    (XLA's order: blocks of 16, then the blocks' totals the same way)."""
    x = np.random.default_rng(n).uniform(0.0, 1.0, (3, n))
    ref = np.asarray(jax.jit(lambda v: jnp.cumsum(v, axis=-1))(x))
    np.testing.assert_array_equal(quadrature.cumsum_blocked(t(x)).numpy(), ref)


def test_per_row_evaluation():
    """Interpolator1D.columns (each column at its own points), romberg with
    a per-row upper limit and linspace_rows against their row-by-row JAX
    counterparts."""
    rng = np.random.default_rng(11)
    x = np.linspace(0.0, 2.0, 30)
    f = np.stack([np.sin(x * a) for a in (1.0, 1.5, 2.0)], axis=-1)           # (30, 3)
    q = rng.uniform(0.0, 2.0, (3, 7))
    ref = np.stack([np.asarray(jspline.Interpolator1D(x, f[:, i])(q[i])) for i in range(3)])
    np.testing.assert_allclose(spline.Interpolator1D(t(x), t(f)).columns(t(q)).numpy(), ref, rtol=RTOL)

    b = np.array([0.5, 1.0, 2.5])
    scale = np.array([1.0, 2.0, 3.0])
    ref = [float(jquad.romberg(lambda v: jnp.exp(-v * s), 0.0, bb, divmax=10)) for bb, s in zip(b, scale)]
    got = quadrature.romberg(lambda v: torch.exp(-v * t(scale)[:, None]), 0.0, t(b), divmax=10)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL)

    start, stop = np.array([-3.0, 0.5]), np.array([1.0, 7.0])
    ref = np.asarray(jax.jit(lambda a, c: jnp.linspace(a, c, 9, axis=-1))(start, stop))
    np.testing.assert_array_equal(misc.linspace_rows(t(start), t(stop), 9).numpy(), ref)
