"""The sigma8 input path and the interpolator tables of the port
(cosmoprimo_tpu_torch/interpolator.py, cosmology.py::_rescale_sigma8,
models/eisenstein_hu.py::Fourier.sigma8_m) against the JAX package's, on the
same parameters made from a seed with numpy (bench.py's ranges), B <= 4.

Bars, as measured on the CPU:
- sigma_r(z), sigma8_m, integrate_sigma_r2 and the rescaling: rtol 1e-12
  (measured <= 2.2e-16 on sigma8_m; both run the TophatVariance FFTLog on
  the same 1024-point grid and a cubic spline in s);
- P(k, z) of Cosmology(sigma8=...) and of the default Cosmology(): rtol
  1e-12 (measured <= 2.9e-15);
- the table form of PowerSpectrumInterpolator2D (log-log padding, 1D and
  2D splines, paired and grid calls): rtol 1e-12 (measured <= 1e-14).
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')

import cosmoprimo_tpu as jcp  # noqa: E402
from cosmoprimo_tpu import interpolator as jinterpolator  # noqa: E402
from cosmoprimo_tpu_torch import Cosmology, interpolator  # noqa: E402

B = 3
RTOL = 1e-12
K = np.geomspace(1e-4, 10.0, 50)
Z = np.array([0.0, 1.0, 2.5])


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def make_params(seed=0):
    rng = np.random.default_rng(seed)
    return dict(omega_cdm=rng.uniform(0.11, 0.13, B), omega_b=rng.uniform(0.021, 0.023, B),
                h=rng.uniform(0.65, 0.70, B), n_s=rng.uniform(0.94, 0.98, B), sigma8=rng.uniform(0.75, 0.85, B))


@functools.lru_cache(maxsize=None)
def jax_sigma8_outputs():
    """P(k, z) on (K, Z), sigma8_m and sigma_r(r, z) of the JAX package for
    the sigma8-input batch."""
    params = make_params()

    def single(*values):
        fo = jcp.Cosmology(engine='eisenstein_hu', **dict(zip(params, values))).get_fourier()
        return (fo.pk_interpolator()(K, Z), fo.sigma8_m, fo.sigma_rz(np.array([4.0, 8.0, 16.0]), Z))

    return [np.asarray(o) for o in jax.jit(jax.vmap(single))(*params.values())]


@pytest.fixture(scope='module')
def fourier():
    return Cosmology(engine='eisenstein_hu', **{name: t(v) for name, v in make_params().items()}).get_fourier()


def test_sigma8_input(fourier):
    pk_ref, sigma8_ref, sigma_rz_ref = jax_sigma8_outputs()
    np.testing.assert_allclose(fourier.sigma8_m.numpy(), sigma8_ref, rtol=RTOL)
    np.testing.assert_allclose(fourier.sigma8_m.numpy(), make_params()['sigma8'], rtol=1e-10)
    np.testing.assert_array_equal(fourier.engine._get_sigma8_fid().numpy(), make_params()['sigma8'])
    np.testing.assert_allclose(fourier.pk_interpolator()(t(K), t(Z)).numpy(), pk_ref, rtol=RTOL)
    got = fourier.sigma_rz(t([4.0, 8.0, 16.0]), t(Z)).numpy()
    assert got.shape == (B, 3, Z.size)
    np.testing.assert_allclose(got, sigma_rz_ref, rtol=RTOL)
    np.testing.assert_allclose(fourier.sigma8_z(t(Z)).numpy(), sigma_rz_ref[:, 1], rtol=RTOL)


def test_sigma8_rescaling_is_reentrant(fourier):
    """The Primordial amplitude carries the ratio, computed once: the first
    pass ran on the first-guess A_s, and the engine keeps the ratio."""
    engine = fourier.engine
    ratio = engine._rescale_sigma8()
    assert ratio is engine._rsigma8 and ratio.shape == (B,)
    np.testing.assert_allclose(engine.get_primordial().A_s.numpy(), (engine._A_s * ratio ** 2).numpy(), rtol=0)
    assert engine.get_section('fourier') is fourier


def test_default_cosmology_pk():
    """A default Cosmology carries sigma8 = 0.8, so its P(k) runs the
    sigma8 input path."""
    got = Cosmology(engine='eisenstein_hu', device='cpu').get_fourier().pk_interpolator()(t(K), t(Z)).numpy()
    ref = np.asarray(jax.jit(lambda: jcp.Cosmology(engine='eisenstein_hu').get_fourier().pk_interpolator()(K, Z))())
    np.testing.assert_allclose(got, ref, rtol=RTOL)


def test_integrate_sigma_r2_and_rescale():
    """sigma_r of a callable 2D and 1D interpolator, and rescale_sigma8 on
    both, against the JAX package's."""
    params = {name: v[0] for name, v in make_params().items() if name != 'sigma8'}
    r = np.array([[2.0, 8.0], [20.0, 50.0]])

    def run(cosmo, PowerSpectrumInterpolator1D, k, rr):
        pk2d = cosmo.get_fourier().pk_interpolator()
        pk1d = PowerSpectrumInterpolator1D.from_callable(pk_callable=lambda kk: pk2d(kk, 0.5))
        out = [pk2d.sigma_rz(rr, 0.5), pk1d.sigma_r(rr)]
        pk2d.rescale_sigma8(0.7)
        pk1d.rescale_sigma8(0.7)
        return out + [pk2d(k, 0.0), pk1d(k), pk2d.sigma8_z(0.0), pk1d.sigma8()]

    ref = jax.jit(lambda: run(jcp.Cosmology(engine='eisenstein_hu', logA=3.0, **params),
                              jinterpolator.PowerSpectrumInterpolator1D, K, r))()
    got = run(Cosmology(engine='eisenstein_hu', logA=3.0, device='cpu', **params), interpolator.PowerSpectrumInterpolator1D, t(K), t(r))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL)
    np.testing.assert_allclose([got[-2].item(), got[-1].item()], 0.7, rtol=RTOL)
    # the first-guess sigma8 of an A_s / logA cosmology
    fid = Cosmology(engine='eisenstein_hu', logA=3.0, device='cpu', **params).engine._get_sigma8_fid()
    np.testing.assert_allclose(fid.item(), float(jcp.Cosmology(engine='eisenstein_hu', logA=3.0, **params).engine
                                                 ._get_sigma8_fid()), rtol=RTOL)
    with pytest.raises(ValueError, match='unknown integration method'):
        interpolator.integrate_sigma_r2(8.0, lambda k: k, method='trapezoid')


@pytest.mark.parametrize('nz', [1, 4])
def test_table_interpolator(nz):
    """Unsorted grids; one z (a 1D spline times growth_factor_sq) or four
    (a 2D spline); queries outside both ranges; grid and paired calls,
    sigma8_z and rescale_sigma8 on a batch of two tables."""
    rng = np.random.default_rng(nz)
    k = rng.permutation(np.geomspace(1e-4, 20.0, 80))
    z = rng.permutation(np.linspace(0.0, 3.0, nz))
    pk = 1e4 * (k[:, None] / 0.1) ** 0.96 / (1 + (k[:, None] / 0.1) ** 3) / (1 + z) ** 2   # (nk, nz)
    scales = np.array([1.0, 1.5])
    qk = np.geomspace(1e-8, 1e3, 40)
    qz = np.array([0.0, 0.4, 2.9, 3.5])

    def growth_factor_sq(zz):
        return (1 + zz) ** -2.0

    kwargs = dict(growth_factor_sq=growth_factor_sq) if nz == 1 else {}

    def run(table, qk, qz):
        return table(qk, qz), table(qk[:4], qz, grid=False), table.sigma8_z(qz[:3])

    ref = jax.jit(jax.vmap(lambda a: run(jinterpolator.PowerSpectrumInterpolator2D(k, z, pk * a, **kwargs), qk, qz)))(
        scales)
    port = interpolator.PowerSpectrumInterpolator2D(k, z, t(pk[None] * scales[:, None, None]), **kwargs)
    got = run(port, t(qk), t(qz))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.isnan(a.numpy()), np.isnan(np.asarray(b)))
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL)
    port.rescale_sigma8(t([0.8, 0.9]))
    np.testing.assert_allclose(port.sigma8_z(0.0).numpy(), [0.8, 0.9], rtol=RTOL)
