"""The port's HMcode-2020 (cosmoprimo_tpu_torch/models/hmcode.py) and its
non-linear pipelines and interpolators against the JAX package's, on the
same cosmologies made from a seed with numpy (bench.py's parameter ranges),
B <= 4, nk = 384 for the modules and 256 for the pipelines.

Bars, as measured on the CPU:
- sigma_tophat2, sigma_v2, dewiggle, nfw_window, mead_growth_ratios:
  rtol 1e-13 (measured <= 4.0e-15: the same formulas; the growth ODE's
  prefix products in another association order);
- hmcode2020 for both collapse options, with feedback and with a Dolag
  ratio: rtol 1e-12 (measured <= 5.0e-15);
- the mead and mead2020_feedback pipelines' xi (max|d| / max|xi| per row):
  1e-12 (measured <= 4.9e-15); chi and sigma8 rtol 1e-13 (measured
  4.4e-16);
- pk_interpolator(non_linear='mead' / 'mead2020_feedback' / True), the
  Dolag case (w0 = -0.8) included: rtol 1e-12 (measured <= 6.2e-15).
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

import cosmoprimo_tpu as jcp  # noqa: E402
from cosmoprimo_tpu import constants  # noqa: E402
from cosmoprimo_tpu.models import hmcode as jhmcode  # noqa: E402
from cosmoprimo_tpu.pipelines import make_pk_to_xi_pipeline_batched as jmake  # noqa: E402
from cosmoprimo_tpu_torch import Cosmology, make_pk_to_xi_pipeline_batched  # noqa: E402
from cosmoprimo_tpu_torch.models import hmcode  # noqa: E402

B = 2
NK = 384
EXACT = 1e-13
BAR = 1e-12
A_GRID = np.geomspace(1e-3, 1.0, 128)
THETA_CMB = constants.TCMB / 2.7


def make_args(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.11, 0.13, n), rng.uniform(0.021, 0.023, n), rng.uniform(0.65, 0.70, n),
            rng.uniform(0.94, 0.98, n), rng.uniform(2.9, 3.1, n))


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def row_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref).reshape(np.shape(got))
    return (np.abs(got - ref).max(axis=-1) / np.abs(ref).max(axis=-1)).max()


@functools.lru_cache(maxsize=None)
def inputs():
    """The module tests' inputs, as numpy: the port's linear P(k, z)
    (B, nk, nz) at z = (0, 0.5, 1), its background tables and parameters,
    for B cosmologies with w0 = -1 and -0.8 (the port's linear P(k) is held
    to the JAX package's by tests/test_torch_cosmology.py)."""
    omega_cdm, omega_b, h, n_s, logA = make_args(B)
    w0 = np.array([-1.0, -0.8])
    cosmo = Cosmology(engine='eisenstein_hu', omega_cdm=t(omega_cdm), omega_b=t(omega_b), h=t(h), n_s=t(n_s),
                      logA=t(logA), w0_fld=t(w0))
    k, z = np.geomspace(1e-4, 1e2, NK), np.array([0.0, 0.5, 1.0])
    ba = cosmo.get_background()
    return dict(k=k, z=z, pk=cosmo.get_fourier().pk_interpolator()(t(k), t(z)).numpy(),
                Om=ba.Omega_m(t(z)).numpy(), omega_m=cosmo['Omega_m'].numpy() * h ** 2, omega_b=omega_b, h=h,
                ns=n_s, w0=w0, growth_g=ba.growth_factor(t(1.0 / A_GRID - 1.0)).numpy(),
                growth_z=ba.growth_factor(t(z)).numpy())


def test_variances_and_dewiggle():
    d = inputs()
    k, pk = d['k'], d['pk']
    R = np.geomspace(5e-4, 5e1, 64)
    pk_t = t(pk.transpose(0, 2, 1))
    got = hmcode.sigma_tophat2(t(k), pk_t, t(R)).numpy()
    ref = jax.jit(jax.vmap(jhmcode.sigma_tophat2, in_axes=(None, 0, None)))(k, pk, R)
    np.testing.assert_allclose(got, np.asarray(ref).transpose(0, 2, 1), rtol=EXACT)
    got = hmcode.sigma_v2(t(k), pk_t).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.jit(jax.vmap(jhmcode.sigma_v2, in_axes=(None, 0)))(k, pk)), rtol=EXACT)
    args = (d['h'], d['omega_m'], d['omega_b'], THETA_CMB, d['ns'])
    got = hmcode.dewiggle(t(k), pk_t, *[t(a) for a in args]).numpy()
    ref = jax.jit(jax.vmap(jhmcode.dewiggle, in_axes=(None, 0, 0, 0, 0, None, 0)))(k, pk, *args)
    np.testing.assert_allclose(got, np.asarray(ref).transpose(0, 2, 1), rtol=EXACT)


def test_nfw_window():
    rng = np.random.default_rng(1)
    krs = np.geomspace(1e-6, 1e3, 400).reshape(4, 100)
    c = rng.uniform(2.0, 20.0, (4, 1))
    got = hmcode.nfw_window(t(krs), t(c)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.jit(jhmcode.nfw_window)(krs, c)), rtol=EXACT)


def test_mead_growth_ratios():
    z = np.array([0.0, 0.5, 1.0, 3.0])
    Om0, Ok0, w0, wa = np.array([0.3, 0.28, 0.32]), np.array([0.0, 0.01, -0.02]), np.array([-1.0, -0.8, -1.1]), \
        np.array([0.0, 0.2, -0.1])
    got = hmcode.mead_growth_ratios(t(z), t(Om0), Omega_k0=t(Ok0), w0=t(w0), wa=t(wa))
    ref = jax.jit(jax.vmap(lambda *p: jhmcode.mead_growth_ratios(jnp.asarray(z), p[0], Omega_k0=p[1], w0=p[2],
                                                                 wa=p[3])))(Om0, Ok0, w0, wa)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=EXACT)


@pytest.mark.parametrize('variant', [dict(), dict(collapse='ns97'), dict(logT_AGN=7.6), dict(dolag_ratio=1.01)])
def test_hmcode2020(variant):
    d = inputs()
    k, z = d['k'], d['z']
    per_cosmo = ('pk', 'Om', 'omega_m', 'omega_b', 'h', 'ns', 'growth_g', 'growth_z', 'w0')

    def jfun(pk, Om, omega_m, omega_b, h, ns, growth_g, growth_z, w0):
        return jhmcode.hmcode2020(k, pk, pk, Om, 0.0, omega_m, omega_b, h, THETA_CMB, ns, A_GRID, growth_g,
                                  growth_z, z=z, w0=w0, **variant)

    ref = np.asarray(jax.jit(jax.vmap(jfun))(*[d[name] for name in per_cosmo]))
    pk_t = t(d['pk'].transpose(0, 2, 1))
    got = hmcode.hmcode2020(t(k), pk_t, pk_t, t(d['Om']), 0.0, t(d['omega_m']), t(d['omega_b']), t(d['h']),
                            THETA_CMB, t(d['ns']), t(A_GRID), t(d['growth_g']), t(d['growth_z']), z=t(z),
                            w0=t(d['w0']), **variant).numpy()
    assert got.shape == (B, z.size, k.size) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref.transpose(0, 2, 1), rtol=BAR)


@functools.lru_cache(maxsize=None)
def jax_pipeline(non_linear, z, nk=256):
    fn, k, s = jmake(nk=nk, z=jnp.asarray(z), non_linear=non_linear)
    return [np.asarray(o) for o in jax.jit(fn)(*[jnp.asarray(a) for a in make_args(B)])]


@pytest.mark.parametrize('non_linear', ['mead', 'mead2020_feedback'])
@pytest.mark.parametrize('z', [(0.0,), (0.0, 0.5, 1.0)])
def test_pipeline_against_jax(non_linear, z):
    # z is computed column by column: one JAX reference at (0, 0.5, 1)
    xi_ref, chi_ref, sigma8_ref = jax_pipeline(non_linear, (0.0, 0.5, 1.0))
    xi_ref = xi_ref[:, :len(z)]
    fn, k, s = make_pk_to_xi_pipeline_batched(nk=256, z=z, non_linear=non_linear)
    xi, chi, sigma8 = fn(*[t(a) for a in make_args(B)])
    assert xi.shape == (B, len(z), 256)
    assert row_err(xi.numpy(), xi_ref) <= BAR
    np.testing.assert_allclose(chi.numpy(), chi_ref, rtol=EXACT)
    np.testing.assert_allclose(sigma8.numpy(), sigma8_ref, rtol=EXACT)


PK_K = np.geomspace(1e-4, 10.0, 60)
PK_Z = np.array([0.0, 0.7, 2.0])


@functools.lru_cache(maxsize=None)
def jax_pk_nl(non_linear, logT_AGN):
    """The JAX package's non-linear P(k, z) on (PK_K, PK_Z) for two
    cosmologies, one with w0 = -0.8 (a Dolag ratio != 1)."""
    def single(logA, w0):
        cosmo = jcp.Cosmology(engine='eisenstein_hu', logA=logA, w0_fld=w0,
                              extra_params={'HMCode_logT_AGN': logT_AGN})
        return cosmo.get_fourier().pk_interpolator(non_linear=non_linear)(PK_K, PK_Z)

    return np.asarray(jax.jit(jax.vmap(single))(jnp.array([3.0, 3.1]), jnp.array([-1.0, -0.8])))


@pytest.mark.parametrize('non_linear,calc_non_linear,logT_AGN', [('mead', '', 7.8), (True, 'mead', 7.8),
                                                                 ('mead2020_feedback', '', 8.0)])
def test_pk_interpolator_non_linear(non_linear, calc_non_linear, logT_AGN):
    cosmo = Cosmology(engine='eisenstein_hu', logA=t([3.0, 3.1]), w0_fld=t([-1.0, -0.8]), non_linear=calc_non_linear,
                      extra_params={'HMCode_logT_AGN': logT_AGN})
    got = cosmo.get_fourier().pk_interpolator(non_linear=non_linear)(t(PK_K), t(PK_Z)).numpy()
    ref = jax_pk_nl(calc_non_linear or non_linear, logT_AGN)
    np.testing.assert_allclose(got, ref, rtol=BAR)
    # the Dolag ratio of the w0 = -0.8 row moves its one-halo term
    lcdm = Cosmology(engine='eisenstein_hu', logA=t([3.1]), non_linear=calc_non_linear,
                     extra_params={'HMCode_logT_AGN': logT_AGN})
    p_lcdm = lcdm.get_fourier().pk_interpolator(non_linear=non_linear)(t(PK_K), t(PK_Z)).numpy()
    assert np.abs(got[1] / p_lcdm[0] - 1).max() > 1e-3
