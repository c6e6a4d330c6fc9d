"""The port's halofit (cosmoprimo_tpu_torch/models/halofit.py) and its
non-linear pipeline and interpolator against the JAX package's, on the same
cosmologies made from a seed with numpy (bench.py's parameter ranges), B <= 4.

Bars, as measured on the CPU:
- sigma_gauss2: rtol 1e-13 (measured 7.8e-16; a matmul in both);
- _nonlinear_scale on the same ln sigma^2 table: rtol 1e-13 (measured
  4.4e-16; one LU against associative scans for the spline);
- halofit, the pipeline's xi (max|d| / max|xi| per row) and
  pk_interpolator(non_linear='halofit'): 1e-11 (measured 2.0e-13, 1.7e-13
  and 6.2e-13). The 1e-16 rounding of the two sigma^2 matmuls reaches C =
  -y''(ln R_sigma) divided by the squared ln R spacing (0.109), ~1e-13
  absolute, and 10^(-0.6038 C + ...) carries it into P;
- chi and sigma8 of the pipeline: rtol 1e-13 (measured 4.4e-16; linear);
- halofit with one massive neutrino species (fnu > 0): 1e-11, as halofit.
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

import cosmoprimo_tpu as jcp  # noqa: E402
from cosmoprimo_tpu.models import halofit as jhalofit  # noqa: E402
from cosmoprimo_tpu.pipelines import make_pk_to_xi_pipeline_batched as jmake  # noqa: E402
from cosmoprimo_tpu_torch import Cosmology, make_pk_to_xi_pipeline_batched  # noqa: E402
from cosmoprimo_tpu_torch.models import halofit  # noqa: E402

B = 3
NK = 256
EXACT = 1e-13
BAR = 1e-11


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
def linear_tables(w0=-1.0):
    """Inputs of the module tests: the port's linear P(k, z) (B, nk, nz)
    and background at z = (0, 0.5, 1), as numpy (the port's linear P(k) is
    held to the JAX package's by tests/test_torch_cosmology.py)."""
    k, z = np.geomspace(1e-4, 1e2, NK), np.array([0.0, 0.5, 1.0])
    params = dict(zip(('omega_cdm', 'omega_b', 'h', 'n_s', 'logA'), (t(a) for a in make_args(B))))
    cosmo = Cosmology(engine='eisenstein_hu', w0_fld=w0, **params)
    ba = cosmo.get_background()
    return (k, z, cosmo.get_fourier().pk_interpolator()(t(k), t(z)).numpy(), ba.Omega_m(t(z)).numpy(),
            ba.Omega_de(t(z)).numpy())


def test_sigma_gauss2_and_nonlinear_scale():
    k, z, pk, _, _ = linear_tables()
    R = np.geomspace(1e-3, 1e3, 128)
    got = halofit.sigma_gauss2(t(k), t(pk.transpose(0, 2, 1)), t(R)).numpy()
    ref = np.asarray(jax.jit(jax.vmap(jhalofit.sigma_gauss2, in_axes=(None, 0, None)))(k, pk, R))  # (B, nR, nz)
    np.testing.assert_allclose(got, ref.transpose(0, 2, 1), rtol=EXACT)
    lnsig2 = np.log(ref).transpose(1, 0, 2).reshape(R.size, -1)                                # (nR, B nz)
    jout = jax.jit(jhalofit._nonlinear_scale)(jnp.log(jnp.asarray(R)), jnp.asarray(lnsig2))
    out = halofit._nonlinear_scale(torch.log(t(R)), t(lnsig2))
    for name, a, b in zip(('lnR_sigma', 'neff', 'C'), out, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=EXACT, err_msg=name)


@pytest.mark.parametrize('w0', [-1.0, -0.8])
def test_halofit(w0):
    k, z, pk, Om, Ode = linear_tables(w0)
    wz = np.full_like(Om, w0)
    got = halofit.halofit(t(k), t(pk.transpose(0, 2, 1)), t(Om), t(Ode), t(wz), Omega_m0=t(Om[:, 0])).numpy()
    assert got.shape == (B, z.size, k.size)
    ref = jax.jit(jax.vmap(jhalofit.halofit, in_axes=(None, 0, 0, 0, 0)))(k, pk, Om, Ode, wz)
    np.testing.assert_allclose(got, np.asarray(ref).transpose(0, 2, 1), rtol=BAR)


@functools.lru_cache(maxsize=None)
def jax_pipeline(non_linear, z, nk=NK):
    fn, k, s = jmake(nk=nk, z=jnp.asarray(z), non_linear=non_linear)
    return [np.asarray(o) for o in jax.jit(fn)(*[jnp.asarray(a) for a in make_args(B)])]


@pytest.mark.parametrize('z', [(0.0,), (0.0, 0.5, 1.0)])
def test_pipeline_against_jax(z):
    # z is computed column by column: one JAX reference at (0, 0.5, 1)
    xi_ref, chi_ref, sigma8_ref = jax_pipeline('halofit', (0.0, 0.5, 1.0))
    xi_ref = xi_ref[:, :len(z)]
    fn, k, s = make_pk_to_xi_pipeline_batched(nk=NK, z=z, non_linear='halofit')
    xi, chi, sigma8 = fn(*[t(a) for a in make_args(B)])
    assert xi.shape == (B, len(z), NK)
    assert row_err(xi.numpy(), xi_ref) <= BAR
    np.testing.assert_allclose(chi.numpy(), chi_ref, rtol=EXACT)
    np.testing.assert_allclose(sigma8.numpy(), sigma8_ref, rtol=EXACT)


PK_K = np.geomspace(1e-4, 10.0, 60)
PK_Z = np.array([0.0, 0.7, 2.0])


@functools.lru_cache(maxsize=None)
def jax_pk_nl(non_linear, calc_non_linear='', z=None):
    """The JAX package's non-linear P(k, z) on (PK_K, PK_Z) for two
    cosmologies, one with w0 = -0.8."""
    kwargs = {} if z is None else {'z': np.asarray(z)}

    def single(logA, w0):
        cosmo = jcp.Cosmology(engine='eisenstein_hu', logA=logA, w0_fld=w0, non_linear=calc_non_linear)
        return cosmo.get_fourier().pk_interpolator(non_linear=non_linear, **kwargs)(PK_K, PK_Z)

    return np.asarray(jax.jit(jax.vmap(single))(jnp.array([3.0, 3.1]), jnp.array([-1.0, -0.8])))


@pytest.mark.parametrize('non_linear,calc_non_linear,z', [('halofit', '', None), (True, '', None),
                                                          (True, 'halofit', None), ('halofit', '', (0.5,))])
def test_pk_interpolator_non_linear(non_linear, calc_non_linear, z):
    """Default grids (540 k, 30 z: a 2D table), non_linear=True with and
    without the calculation parameter, and a one-z table (flat in z)."""
    cosmo = Cosmology(engine='eisenstein_hu', logA=t([3.0, 3.1]), w0_fld=t([-1.0, -0.8]), non_linear=calc_non_linear)
    kwargs = {} if z is None else {'z': np.asarray(z)}
    pk = cosmo.get_fourier().pk_interpolator(non_linear=non_linear, **kwargs)
    got = pk(t(PK_K), t(PK_Z)).numpy()
    np.testing.assert_allclose(got, jax_pk_nl(non_linear, calc_non_linear, z), rtol=BAR)
    paired = pk(t(PK_K[:3]), t(PK_Z), grid=False).numpy()
    np.testing.assert_allclose(paired, np.stack([np.diagonal(g[:3]) for g in got]), rtol=BAR)


def test_halofit_massive_neutrinos():
    """halofit with fnu > 0 (one massive species of 0.06 eV: the Bird et al.
    correction and the ncdm background), through the Fourier section."""
    def single(logA, w0):
        cosmo = jcp.Cosmology(engine='eisenstein_hu', logA=logA, w0_fld=w0, m_ncdm=[0.06])
        return cosmo.get_fourier().pk_interpolator(non_linear='halofit', z=PK_Z)(PK_K, PK_Z)

    ref = np.asarray(jax.jit(jax.vmap(single))(jnp.array([3.0, 3.1]), jnp.array([-1.0, -0.8])))
    cosmo = Cosmology(engine='eisenstein_hu', logA=t([3.0, 3.1]), w0_fld=t([-1.0, -0.8]), m_ncdm=[0.06])
    fo = cosmo.get_fourier()
    assert bool((fo._fnu > 0.004).all())
    np.testing.assert_allclose(fo.pk_interpolator(non_linear='halofit', z=PK_Z)(t(PK_K), t(PK_Z)).numpy(), ref, rtol=BAR)
