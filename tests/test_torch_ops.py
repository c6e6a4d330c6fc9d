"""The port's numerical substrate (cosmoprimo_tpu_torch/ops) against the JAX
package's on the same inputs, made from a seed with numpy.

Bar: rtol 1e-12. Both sides compute the same formulas in float64; the
spline solves differ in method (associative scans against one LU), which
moves results by a few ulp times the condition number of the diagonally
dominant spline matrix (< 3).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from cosmoprimo_tpu.ops.odeint import cumquad_rk4 as jcumquad_rk4  # noqa: E402
from cosmoprimo_tpu.ops import quadrature as jquad  # noqa: E402
from cosmoprimo_tpu.ops import spline as jspline  # noqa: E402
from cosmoprimo_tpu_torch.ops import misc, odeint, quadrature, spline  # noqa: E402

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
