"""The port's BBKS and EH99 no-wiggle-variants engines
(cosmoprimo_tpu_torch/models/bbks.py, eisenstein_hu_nowiggle_variants.py)
against the JAX package's, on the same cosmologies made from a seed with
numpy (bench.py's parameter ranges; m_ncdm ~ U(0.06, 0.12) eV with N_eff =
3.044 for the massive case). The port runs the batch in one call; the JAX
package one cosmology at a time (vmapped and jitted).

Bars:
- coefficients, transfer functions (delta_m, delta_cb, on the (k, z) grid
  and at paired points), the growth normalised per row to z_eq, and the
  linear P(k, z) for delta_m, delta_cb, theta_cb and a delta_m x theta_m
  cross spectrum: rtol 1e-12, closed form on both sides (measured
  <= 3.1e-15);
- halofit (with the neutrino fraction) and HMcode-2020 with the cold
  field's P(k) for sigma(R) (``pk2d_cb``): rtol 1e-11 (measured 5.8e-13
  for halofit, its Newton block's known 1e-13 rounding; 7.2e-15 for
  HMcode).

Also: the astropy engine's guard (astropy is not installed here, so only
the guard runs), and the sigma8 input through the variants engine.
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

import cosmoprimo_tpu as jcp  # noqa: E402
from cosmoprimo_tpu_torch import Cosmology, CosmologyInputError  # noqa: E402

B = 2
CLOSED = 1e-12
NON_LINEAR = 1e-11
K = np.geomspace(1e-4, 10.0, 96)
Z = np.array([0.0, 0.5, 1.0, 3.0])
OFS = ['delta_m', 'delta_cb', 'theta_cb', ('delta_m', 'theta_m')]
CONFIGS = {'bbks': ('bbks', False), 'variants': ('eisenstein_hu_nowiggle_variants', False),
           'variants_ncdm': ('eisenstein_hu_nowiggle_variants', True)}


def params(massive, seed=0):
    rng = np.random.default_rng(seed)
    p = dict(omega_cdm=rng.uniform(0.11, 0.13, B), omega_b=rng.uniform(0.021, 0.023, B),
             h=rng.uniform(0.65, 0.70, B), n_s=rng.uniform(0.94, 0.98, B), logA=rng.uniform(2.9, 3.1, B))
    if massive:
        p['m_ncdm'] = rng.uniform(0.06, 0.12, B)
    return p


def port_cosmology(config):
    engine, massive = CONFIGS[config]
    p = {name: torch.from_numpy(v) for name, v in params(massive).items()}
    if massive:
        p.update(m_ncdm=[p['m_ncdm']], N_eff=3.044)
    return Cosmology(engine=engine, **p)


def outputs(cosmo, xp, non_linear):
    """Everything the tests compare, from a cosmology of either package."""
    engine = cosmo.engine
    fo = cosmo.get_fourier()
    k, z = xp.asarray(K), xp.asarray(Z)
    out = {}
    if engine.name == 'bbks':
        out['gamma'] = engine.gamma
        out['transfer'] = cosmo.get_transfer().transfer_k(k)
    else:
        out.update({name: value for name, value in engine._coefficients.items() if name != 'N_ncdm'})
        tr = cosmo.get_transfer()
        for of in ('delta_m', 'delta_cb'):
            out[f'transfer_{of}'] = tr.transfer_kz(k, z, of=of)
            out[f'transfer_{of}_paired'] = tr.transfer_kz(k[:4], z, of=of, grid=False)
        out['growth_znorm'] = cosmo.get_background().growth_factor(z, znorm=engine.z_eq)
    for of in OFS:
        out[f'pk_{of}'] = fo.pk_interpolator(of=of)(k, z)
    if non_linear:
        for name in ('halofit', 'mead'):
            out[name] = fo.pk_interpolator(non_linear=name)(k, z)
    return out


@functools.lru_cache(maxsize=None)
def jax_outputs(config):
    engine, massive = CONFIGS[config]
    p = params(massive)
    names = list(p)

    def one(*values):
        kwargs = dict(zip(names, values))
        if massive:   # a 0-d m_ncdm is one species
            kwargs.update(N_eff=3.044)
        return outputs(jcp.Cosmology(engine=engine, **kwargs), jnp, config == 'variants_ncdm')

    ref = jax.jit(jax.vmap(one))(*[jnp.asarray(p[name]) for name in names])
    return {name: np.asarray(value) for name, value in ref.items()}


@pytest.mark.parametrize('config', list(CONFIGS))
def test_closed_form_against_jax(config):
    ref = jax_outputs(config)
    got = outputs(port_cosmology(config), torch, False)
    for name, value in got.items():
        assert value.shape == ref[name].shape, name
        np.testing.assert_allclose(value.numpy(), ref[name], rtol=CLOSED, atol=0, err_msg=name)


@pytest.mark.parametrize('name', ['halofit', 'mead'])
def test_non_linear_against_jax(name):
    """halofit with the neutrino fraction, and HMcode-2020 with the cold
    field's P(k) for sigma(R), with massive neutrinos."""
    ref = jax_outputs('variants_ncdm')[name]
    cosmo = port_cosmology('variants_ncdm')
    got = cosmo.get_fourier().pk_interpolator(non_linear=name)(K, Z).numpy()
    np.testing.assert_allclose(got, ref, rtol=NON_LINEAR, atol=0)
    # the cold field moves HMcode: not the same as sigma(R) from the total matter
    if name == 'mead':
        from cosmoprimo_tpu_torch.models.hmcode import hmcode_pk_interpolator
        fo = cosmo.get_fourier()
        total = hmcode_pk_interpolator(fo.pk_interpolator(), fo.ba, fo._hm_params)(K, Z).numpy()
        assert np.abs(total / got - 1).max() > 1e-4


def test_massless_variants_and_growth():
    """Without massive neutrinos delta_cb is delta_m; the growth normalised
    to z_eq of a batch is per row."""
    cosmo = port_cosmology('variants')
    tr = cosmo.get_transfer()
    np.testing.assert_array_equal(tr.transfer_kz(K, Z, of='delta_cb').numpy(), tr.transfer_kz(K, Z, of='delta_m').numpy())
    ba = cosmo.get_background()
    z_eq = cosmo.engine.z_eq
    per_row = ba.growth_factor(Z, znorm=z_eq)
    for i in range(B):
        np.testing.assert_allclose(per_row[i].numpy(), ((1 + z_eq[i]) * ba.growth_factor(Z, znorm=0.0)[i]).numpy(),
                                   rtol=1e-15)
    with pytest.raises(Exception, match='No delta_x transfer'):
        port_cosmology('variants_ncdm').get_transfer().transfer_kz(K, Z, of='delta_x')


def test_sigma8_input():
    """The sigma8 input rescales the variants' P(k) to its value (two passes)."""
    cosmo = Cosmology(engine='eisenstein_hu_nowiggle_variants', sigma8=torch.tensor([0.75, 0.85], dtype=torch.float64),
                      m_ncdm=0.1, N_eff=3.044)
    np.testing.assert_allclose(cosmo.get_fourier().sigma8_m.numpy(), [0.75, 0.85], rtol=1e-10)
    assert cosmo.get_fourier().pk_interpolator()(K, Z).shape == (2, K.size, Z.size)


def test_astropy_guard():
    """astropy is not installed here: the engine raises the input error (its
    body, which needs astropy, is not tested: ROADMAP)."""
    try:
        import astropy  # noqa: F401
    except ImportError:
        with pytest.raises(CosmologyInputError, match='astropy is required'):
            Cosmology(engine='astropy', device='cpu')
    else:
        assert float(Cosmology(engine='astropy', device='cpu').efunc(0.0)) == pytest.approx(1.0)
