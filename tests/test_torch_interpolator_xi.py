"""The port's interpolators in full (cosmoprimo_tpu_torch/interpolator.py):
to_xi and to_pk through the FFTLog kernel's plain version (engine='kernel'
on CPU tensors), the xi interpolators and their sigma methods, the
integrate_sigma_* methods other than 'fftlog', growth_rate_rz, sigma_dz,
to_1d, clone and the table options other than log-log cubic, against the
JAX package's on cosmologies made from a seed with numpy.

Bars: xi(s) and the P(k) back from xi: 1e-10 of each row's max (the same
FFTLog setup and splines in float64; FFTs in another order of
operations); the sigma integrals, growth rates and tables: rtol 1e-10.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')

import cosmoprimo_tpu as jcp  # noqa: E402
from cosmoprimo_tpu import interpolator as jinterpolator  # noqa: E402
from cosmoprimo_tpu_torch import Cosmology, interpolator  # noqa: E402

B = 3
BAR = 1e-10
Z = np.array([0.5, 1.0, 2.0])
SQ = np.geomspace(1.0, 200.0, 40)
KQ = np.geomspace(1e-3, 1.0, 40)
RQ = np.array([4.0, 8.0, 16.0])
KERNEL = {'engine': 'kernel'}


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def make_params(seed=0):
    rng = np.random.default_rng(seed)
    return dict(omega_cdm=rng.uniform(0.11, 0.13, B), h=rng.uniform(0.65, 0.70, B), logA=rng.uniform(2.9, 3.1, B))


def quantities(pk, xi_kwargs):
    """The same calls on either package's 2D P(k) interpolator."""
    xi = pk.to_xi(**xi_kwargs)
    back = xi.to_pk(**xi_kwargs)
    pk1 = pk.to_1d(z=1.0)
    xi1 = pk1.to_xi(**xi_kwargs)
    out = dict(xi=xi.xi, xi_q=xi(SQ, Z), xi_pairs=xi(SQ[:3], Z, grid=False), pk_back=back(KQ, Z, ignore_growth=True),
               xi1=xi1(SQ), pk1_back=xi1.to_pk(**xi_kwargs)(KQ), xi_1d=xi.to_1d(z=1.0)(SQ),
               sigma_dz=pk.sigma_dz(Z), growth_rate_rz=pk.growth_rate_rz(RQ, Z),
               xi_sigma8=xi1.sigma8())
    for method in ('simpson', 'leggauss'):
        out[f'sigma_d_{method}'] = pk1.sigma_d(method=method)
        out[f'sigma_r_{method}'] = pk1.sigma_r(RQ, method=method)
    return out


@pytest.fixture(scope='module')
def references():
    params = make_params()

    def run(*values):
        pk = jcp.Cosmology(engine='eisenstein_hu', **dict(zip(params, values))).get_fourier().pk_interpolator(z=Z)
        return quantities(pk, {})

    return {name: np.asarray(v) for name, v in jax.jit(jax.vmap(run))(*params.values()).items()}


@pytest.fixture(scope='module')
def port():
    cosmo = Cosmology(engine='eisenstein_hu', **{name: t(v) for name, v in make_params().items()})
    pk = cosmo.get_fourier().pk_interpolator(z=Z)
    return {name: v.numpy() for name, v in quantities(pk, {'fftlog_kwargs': KERNEL}).items()}


def row_err(got, ref):
    """max|got - ref| / max|ref| along the first axis after the batch, the
    worst row."""
    got, ref = got.reshape(B, got.shape[1], -1), ref.reshape(B, ref.shape[1], -1)
    return (np.abs(got - ref).max(axis=1) / np.abs(ref).max(axis=1)).max()


def test_to_xi_to_pk_against_jax(port, references):
    got = port
    assert got['xi'].shape == (B, 1024, Z.size)
    for name in ('xi', 'xi_q', 'pk_back', 'xi1', 'pk1_back', 'xi_1d'):
        assert got[name].shape == references[name].shape, name
        assert row_err(got[name], references[name]) <= BAR, name
    np.testing.assert_allclose(got['xi_pairs'], references['xi_pairs'], rtol=BAR, atol=BAR * np.abs(got['xi_q']).max())


def test_sigma_methods_against_jax(port, references):
    got = port
    for name in ('sigma_dz', 'growth_rate_rz', 'xi_sigma8') + tuple(f'sigma_{q}_{m}' for q in ('d', 'r')
                                                                    for m in ('simpson', 'leggauss')):
        np.testing.assert_allclose(got[name], references[name], rtol=BAR, err_msg=name)


def test_sigma_romberg():
    """method='romberg' of the sigma integrals, which the JAX package
    cannot run (its integrands index the scalar end points that its Romberg
    evaluates first), against 'leggauss' at 1e-5."""
    cosmo = Cosmology(engine='eisenstein_hu', **{name: t(v) for name, v in make_params().items()})
    pk = cosmo.get_fourier().pk_interpolator().to_1d(z=0.5)
    romberg = dict(method='romberg', epsabs=1e-2, epsrel=1e-4)
    np.testing.assert_allclose(pk.sigma_d(**romberg).numpy(), pk.sigma_d(method='leggauss', nk=400).numpy(), rtol=1e-5)
    np.testing.assert_allclose(pk.sigma_r(RQ, **romberg).numpy(), pk.sigma_r(RQ, method='leggauss', nk=400).numpy(),
                               rtol=1e-5)


@pytest.mark.parametrize('options', [dict(), dict(interp_order_k=1), dict(extrap_pk='lin'),
                                     dict(interp_k='lin', extrap_pk='lin', interp_order_z=1)])
def test_table_options_against_jax(options):
    rng = np.random.default_rng(4)
    k = np.geomspace(1e-4, 10.0, 200)
    z = np.array([0.0, 0.5, 1.0, 2.0])
    pk = 1e4 * (k[:, None] / 0.1) ** 0.96 / (1 + (k[:, None] / 0.1) ** 3) * rng.uniform(0.5, 2.0, (B, 1, z.size))
    kq, zq = np.geomspace(2e-4, 5.0, 30), np.array([0.1, 0.7, 1.5])
    got = interpolator.PowerSpectrumInterpolator2D(k, z, t(pk), **options)
    got_1d = interpolator.PowerSpectrumInterpolator1D(k, t(pk[..., 0]), **options_1d(options))
    clone = got.clone(pk=t(2 * pk))
    for i in range(B):
        ref = jax.jit(lambda p: jinterpolator.PowerSpectrumInterpolator2D(k, z, p, **options)(kq, zq))(pk[i])
        np.testing.assert_allclose(got(t(kq), t(zq))[i].numpy(), np.asarray(ref), rtol=BAR)
        np.testing.assert_allclose(clone(t(kq), t(zq))[i].numpy(), 2 * np.asarray(ref), rtol=BAR)
        ref = jax.jit(lambda p: jinterpolator.PowerSpectrumInterpolator1D(k, p, **options_1d(options))(kq))(pk[i, :, 0])
        np.testing.assert_allclose(got_1d(t(kq))[i].numpy(), np.asarray(ref), rtol=BAR)
    assert set(got.as_dict()) == set(jinterpolator.PowerSpectrumInterpolator2D(k, z, pk[0]).as_dict())


def options_1d(options):
    return {name: value for name, value in options.items() if name != 'interp_order_z'}
