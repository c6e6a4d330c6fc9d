"""The shape and dtype contracts of tests/test_contracts.py over every
ported analytic engine of the port: scalar in gives the batch shape out,
empty in gives a trailing axis of size 0, shapes pass through, float32 in
gives float32 out (float64 stays float64), the ncdm species axes, the
Fourier grid shapes, and the thermodynamics and primordial scalars. The
values are held to the JAX package's (float64, rtol 1e-12; float32 to its
own rounding, rtol 1e-6; measured 0.0 for both: the same float64 values,
cast).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')

import cosmoprimo_tpu as jcp  # noqa: E402
from cosmoprimo_tpu_torch import Cosmology  # noqa: E402
from cosmoprimo_tpu_torch.ops import bcast_dtype  # noqa: E402

ENGINES = ['eisenstein_hu', 'eisenstein_hu_nowiggle', 'eisenstein_hu_nowiggle_variants', 'bbks']

BACKGROUND_METHODS = ['efunc', 'hubble_function', 'comoving_radial_distance', 'angular_diameter_distance',
                      'luminosity_distance', 'growth_factor', 'growth_rate', 'time', 'Omega_m', 'Omega_de']


@pytest.fixture(scope='module', params=ENGINES)
def cosmo(request):
    return Cosmology(engine=request.param, m_ncdm=[0.02, 0.05], device='cpu')


def test_background_scalar_contract(cosmo):
    ba = cosmo.get_background()
    for name in BACKGROUND_METHODS:
        value = getattr(ba, name)(1.0)
        assert value.dim() == 0, f'{name}(scalar) must be scalar, got shape {tuple(value.shape)}'
        assert np.isfinite(float(value))


def test_background_empty_contract(cosmo):
    ba = cosmo.get_background()
    for name in BACKGROUND_METHODS:
        value = getattr(ba, name)(np.array([], dtype=np.float64))
        assert value.shape[-1] == 0, f'{name}([]) must have trailing size 0'


def test_background_shape_passthrough(cosmo):
    ba = cosmo.get_background()
    z = np.linspace(0.0, 3.0, 12).reshape(3, 4)
    for name in BACKGROUND_METHODS:
        assert tuple(getattr(ba, name)(z).shape)[-2:] == (3, 4), f'{name} must preserve input shape'


def test_background_float32_contract(cosmo):
    """float32 in gives float32 out, computed in float64 and cast; float64,
    a Python float and a float64 tensor give float64; the values against the
    JAX package's."""
    ba = cosmo.get_background()
    z32 = np.linspace(0.0, 3.0, 5, dtype=np.float32)
    names = ['efunc', 'comoving_radial_distance', 'growth_factor']

    def jax_values(z):
        ref = jcp.Cosmology(engine=cosmo.engine.name, m_ncdm=[0.02, 0.05]).get_background()
        return [getattr(ref, name)(z) for name in names]

    refs32, refs64 = jax.jit(jax_values)(z32), jax.jit(jax_values)(z32.astype(np.float64))
    for name, ref32, ref64 in zip(names, refs32, refs64):
        value = getattr(ba, name)(z32)
        assert value.dtype == torch.float32 and ref32.dtype == np.float32, f'{name}(float32) must return float32'
        assert getattr(ba, name)(torch.from_numpy(z32)).dtype == torch.float32
        np.testing.assert_allclose(value.numpy(), np.asarray(ref32), rtol=1e-6)
        value64 = getattr(ba, name)(z32.astype(np.float64))
        np.testing.assert_array_equal(value.numpy(), value64.numpy().astype(np.float32))
        for z in (np.float64(1.0), 1.0, torch.tensor([1.0], dtype=torch.float64)):
            assert getattr(ba, name)(z).dtype == torch.float64
        np.testing.assert_allclose(value64.numpy(), np.asarray(ref64), rtol=1e-12)


def test_bcast_dtype_rule():
    """float32 only when every floating argument is float32 (the JAX
    package's rule); integers and None do not count."""
    f32, f64 = np.zeros(2, dtype=np.float32), torch.zeros(2, dtype=torch.float64)
    assert bcast_dtype(f32) == bcast_dtype(torch.from_numpy(f32)) == bcast_dtype(f32, None, np.arange(3)) == torch.float32
    assert bcast_dtype(f32, f64) == bcast_dtype(f32, 1.0) == bcast_dtype(np.arange(3)) == bcast_dtype() == torch.float64


def test_background_species_axes(cosmo):
    ba = cosmo.get_background()
    z = np.linspace(0.0, 3.0, 7)
    for name in ['rho_ncdm', 'Omega_ncdm']:
        assert tuple(getattr(ba, name)(z).shape) == (2, 7), f'{name} must carry the (N_ncdm, nz) axes'
    assert tuple(ba.rho_ncdm(z, species=0).shape) == (7,)
    # scalar z keeps the species axis
    assert tuple(ba.rho_ncdm(1.0).shape) == (2,)


@pytest.mark.parametrize('engine', ENGINES)
def test_fourier_contracts(engine):
    cosmo = Cosmology(engine=engine, device='cpu')
    pki = cosmo.get_fourier().pk_interpolator()
    pk = pki(np.array([0.1]), z=0.0)
    assert bool(torch.isfinite(pk).all()) and bool((pk > 0).all())
    # grid evaluation: (nk, nz)
    k = np.geomspace(1e-3, 1.0, 11)
    z = np.array([0.0, 0.5, 1.0])
    pkz = pki(k, z=z)
    assert tuple(pkz.shape) == (11, 3)
    ref = jax.jit(lambda k, z: jcp.Cosmology(engine=engine).get_fourier().pk_interpolator()(k, z))(k, z)
    np.testing.assert_allclose(pkz.numpy(), np.asarray(ref), rtol=1e-12)
    # scalar k, scalar z -> scalar
    assert pki(0.1, z=0.5).dim() == 0


@pytest.mark.parametrize('engine', ['eisenstein_hu', 'eisenstein_hu_nowiggle', 'eisenstein_hu_nowiggle_variants'])
def test_thermodynamics_scalars(engine):
    th = Cosmology(engine=engine, m_ncdm=[0.02, 0.05], device='cpu').get_thermodynamics()
    for name in ['rs_drag', 'z_drag']:
        value = getattr(th, name)
        assert value.dim() == 0 and np.isfinite(float(value))


def test_primordial_contract(cosmo):
    pm = cosmo.get_primordial()
    k = np.geomspace(1e-4, 1.0, 9)
    assert tuple(pm.pk_k(k).shape) == (9,)
    assert pm.pk_k(0.05).dim() == 0
