"""The port's FFTLog (cosmoprimo_tpu_torch/fftlog.py, ops/fftlog_kernel.py)
against the JAX package's on the same inputs, made from a seed with numpy.

Bars, as max|port - jax| / max|jax|:
- setup arrays (padded_u, pre/postfactors, y): 1e-12; both are numpy
  complex128, with loggamma from scipy in the port and the JAX package's
  Lanczos loggamma;
- transforms against the JAX ``jnp.fft`` path: 1e-12;
- fftlog_core_torch against fftlog_pair_reference: rtol 1e-10, atol 1e-12,
  the bar of tests/test_fftlog.py::test_pallas_reference_function.

The CUDA kernel itself is tested on the card by tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from cosmoprimo_tpu import fftlog as jfftlog  # noqa: E402
from cosmoprimo_tpu.ops.pallas_fft import fftlog_pair_reference  # noqa: E402
from cosmoprimo_tpu_torch import fftlog  # noqa: E402
from cosmoprimo_tpu_torch.ops import fftlog_kernel  # noqa: E402

BAR = 1e-12


def norm_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / np.abs(ref).max()


def pk_like(k):
    return 1e4 * (k / 0.1) ** 0.96 / (1 + ((k / 0.1) ** 1.5) ** 2)


TRANSFORMS = {
    'p2c': (lambda k, **kw: fftlog.PowerToCorrelation(k, **kw), lambda k, **kw: jfftlog.PowerToCorrelation(k, **kw)),
    'tophat': (lambda k, **kw: fftlog.TophatVariance(k, **kw), lambda k, **kw: jfftlog.TophatVariance(k, **kw)),
    'multipoles': (lambda k, **kw: fftlog.PowerToCorrelation(k, ell=[0, 2, 4], **kw),
                   lambda k, **kw: jfftlog.PowerToCorrelation(k, ell=[0, 2, 4], **kw)),
    'complex': (lambda k, **kw: fftlog.PowerToCorrelation(k, ell=[0, 1, 2], complex=True, **kw),
                lambda k, **kw: jfftlog.PowerToCorrelation(k, ell=[0, 1, 2], complex=True, **kw)),
    'lowring_off': (lambda k, **kw: fftlog.FFTlog(k, fftlog.BesselJKernel(0), q=1, lowring=False, xy=2.0, **kw),
                    lambda k, **kw: jfftlog.FFTlog(k, jfftlog.BesselJKernel(0), q=1, lowring=False, xy=2.0, **kw)),
}


@pytest.mark.parametrize('name', list(TRANSFORMS))
def test_setup_arrays(name):
    k = np.geomspace(1e-5, 1e2, 1000)
    port, ref = TRANSFORMS[name][0](k), TRANSFORMS[name][1](k)
    assert port.padded_size == ref.padded_size == 2048
    for attr in ('padded_u', 'padded_prefactor', 'padded_postfactor', 'y', 'padded_y', 'lnxy'):
        assert norm_err(getattr(port, attr), getattr(ref, attr)) <= BAR, attr


@pytest.mark.parametrize('name', ['p2c', 'tophat', 'multipoles'])
@pytest.mark.parametrize('engine', ['torch', 'kernel'])
@pytest.mark.parametrize('extrap,keep_padding', [(0, False), ('log', False), ('edge', True)])
def test_transform(name, engine, extrap, keep_padding):
    # Left out, as round-off amplified past the bar in both packages: the kept
    # padding of a zero- or log-padded input (FFT round-off times postfactors
    # up to ~1e8: numpy, jnp.fft and torch.fft differ by ~1e-9 of the
    # maximum), and the crop of an edge-padded one (jnp.fft is 2e-10 from
    # numpy there, torch.fft 1e-11).
    k = np.geomspace(1e-5, 1e2, 512)
    rng = np.random.default_rng(0)
    fun = pk_like(k) * rng.uniform(0.5, 2.0, (2, 3, 1))
    port = TRANSFORMS[name][0](k, engine=engine)
    y, got = port(torch.from_numpy(fun), extrap=extrap, keep_padding=keep_padding)
    y_ref, ref = TRANSFORMS[name][1](k)(jnp.asarray(fun), extrap=extrap, keep_padding=keep_padding)
    assert norm_err(y.numpy(), y_ref) <= BAR
    assert norm_err(got.numpy(), ref) <= BAR


def test_multipole_broadcast_and_complex():
    k = np.geomspace(1e-4, 1e1, 512)
    pk = pk_like(k)
    y, got = fftlog.PowerToCorrelation(k, ell=[0, 2, 4])(torch.from_numpy(pk))
    _, ref = jfftlog.PowerToCorrelation(k, ell=[0, 2, 4])(jnp.asarray(np.tile(pk, (3, 1))))
    assert y.shape == got.shape == (3, 512)
    assert norm_err(got.numpy(), ref) <= BAR
    port, jref = TRANSFORMS['complex'][0](k), TRANSFORMS['complex'][1](k)
    _, got = port(torch.from_numpy(np.tile(pk, (3, 1))))
    _, ref = jref(jnp.asarray(np.tile(pk, (3, 1))))
    assert got.is_complex() and norm_err(got.numpy(), ref) <= BAR
    with pytest.raises(NotImplementedError):
        TRANSFORMS['complex'][0](k, engine='kernel')(torch.from_numpy(np.tile(pk, (3, 1))))


def test_pad():
    rng = np.random.default_rng(3)
    x = rng.uniform(1.0, 2.0, (2, 6))
    for width, extrap in [((2, 3), 'log'), (2, 'edge'), ((1, 2), 0), ((2, 1), ('log', 'edge')), (1, 1.5)]:
        got = fftlog.pad(torch.from_numpy(x), width, extrap=extrap).numpy()
        ref = np.asarray(jfftlog.pad(jnp.asarray(x), width, extrap=extrap))
        np.testing.assert_allclose(got, ref, rtol=BAR)
    got = fftlog.pad(torch.from_numpy(x.T), (2, 3), axis=0, extrap='log').numpy()
    np.testing.assert_allclose(got, np.asarray(jfftlog.pad(jnp.asarray(x.T), (2, 3), axis=0, extrap='log')), rtol=BAR)


def test_core_plain_against_pair_reference():
    rng = np.random.default_rng(0)
    B, n = 8, 512
    f = rng.normal(size=(B, n))
    uh = rng.normal(size=n // 2 + 1) + 1j * rng.normal(size=n // 2 + 1)
    post = rng.normal(size=n)
    ref = np.asarray(fftlog_pair_reference(jnp.asarray(f), jnp.asarray(uh.real), jnp.asarray(uh.imag), jnp.asarray(post)))
    got = fftlog_kernel.fftlog_core_torch(torch.from_numpy(f), torch.from_numpy(uh[None]), torch.ones(1, n, dtype=torch.float64),
                                          torch.from_numpy(post[None]), 0, 0)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10, atol=1e-12)


def random_core_args(rng, rows, size, n, nparallel):
    u = rng.normal(size=(nparallel, n // 2 + 1)) + 1j * rng.normal(size=(nparallel, n // 2 + 1))
    return (torch.from_numpy(rng.normal(size=(rows, size))), torch.from_numpy(u),
            torch.from_numpy(rng.normal(size=(nparallel, n))), torch.from_numpy(rng.normal(size=(nparallel, n))))


@pytest.mark.parametrize('nparallel,in_left,out_left', [(1, 200, 312), (3, 0, 0), (2, 500, 12)])
def test_core_adjoint(nparallel, in_left, out_left):
    """<T x, y> == <x, T^T y>, where T^T swaps the pre/postfactors and the
    windows: the formula the backward pass relies on."""
    rng = np.random.default_rng(nparallel)
    x, u, pre, post = random_core_args(rng, 6, 500, 1024, nparallel)
    y = torch.from_numpy(rng.normal(size=(6, 500)))
    lhs = torch.sum(fftlog_kernel.fftlog_core_torch(x, u, pre, post, in_left, out_left) * y)
    rhs = torch.sum(x * fftlog_kernel.fftlog_core_torch(y, u, post, pre, out_left, in_left))
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


def test_core_backward_matches_torch_autograd():
    rng = np.random.default_rng(4)
    x, u, pre, post = random_core_args(rng, 6, 300, 512, 3)
    grad_out = torch.from_numpy(rng.normal(size=(6, 300)))
    xk, xp = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    gk, = torch.autograd.grad(fftlog_kernel.fftlog_core(xk, u, pre, post, 100, 112), xk, grad_out)
    gp, = torch.autograd.grad(fftlog_kernel.fftlog_core_torch(xp, u, pre, post, 100, 112), xp, grad_out)
    assert norm_err(gk.numpy(), gp.numpy()) <= BAR


@pytest.mark.parametrize('engine', ['torch', 'kernel'])
def test_grad_against_jax(engine):
    """The contract of tests/test_fftlog.py::test_jax_contracts: xi is
    linear in the amplitude, and the vector-Jacobian product matches
    jax.vjp for a full cotangent."""
    k = np.geomspace(1e-4, 1e2, 256)
    pk = np.exp(-k ** 2 / 2)

    def jxi(fun):
        return jfftlog.PowerToCorrelation(k)(fun)[1]

    amplitude = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    xi = fftlog.PowerToCorrelation(k, engine=engine)(amplitude * torch.from_numpy(pk))[1]
    grad, = torch.autograd.grad(xi[100], amplitude)
    jgrad = float(jax.grad(lambda a: jxi(a * jnp.asarray(pk))[100])(1.0))
    assert abs(grad.item() - jgrad) <= BAR * abs(jgrad)
    assert abs(grad.item() - xi[100].item()) <= BAR * abs(jgrad)

    cot = np.random.default_rng(5).normal(size=k.size)
    fun = torch.from_numpy(pk).requires_grad_(True)
    vjp, = torch.autograd.grad(fftlog.PowerToCorrelation(k, engine=engine)(fun)[1], fun, torch.from_numpy(cot))
    _, jvjp = jax.vjp(jxi, jnp.asarray(pk))
    assert norm_err(vjp.numpy(), jvjp(jnp.asarray(cot))[0]) <= BAR


def test_core_checks():
    rng = np.random.default_rng(6)
    x, u, pre, post = random_core_args(rng, 4, 100, 256, 1)
    with pytest.raises(ValueError):
        fftlog_kernel.fftlog_core(x, u, pre[:, :200], post[:, :200], 0, 0)   # not a power of two
    with pytest.raises(ValueError):
        fftlog_kernel.fftlog_core(x, u, pre, post, 200, 0)                   # window past n
    with pytest.raises(ValueError):
        fftlog_kernel.fftlog_core(x[:3], *random_core_args(rng, 3, 100, 256, 2)[1:], 0, 0)  # rows % nparallel
    with pytest.raises(TypeError):
        fftlog_kernel.fftlog_core(x.float(), u, pre, post, 0, 0)
    with pytest.raises(ValueError):
        fftlog.FFTlog(np.geomspace(1e-3, 1e2, 64), fftlog.BesselJKernel(0), engine='pallas')
