"""The port's parameter system, background and EH98 engine
(cosmoprimo_tpu_torch/cosmology.py, models/eisenstein_hu.py, interpolator.py)
against the JAX package's, on the same parameters made from a seed with
numpy. The port runs the whole batch in one call; the JAX package runs one
cosmology at a time.

Bar: rtol 1e-12, the same closed-form formulas in float64 on both sides.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

import cosmoprimo_tpu as jcp  # noqa: E402
from cosmoprimo_tpu.interpolator import kernel_tophat2 as jkernel_tophat2  # noqa: E402
from cosmoprimo_tpu.models.eisenstein_hu import compute_eh98_coefficients as jeh98  # noqa: E402
from cosmoprimo_tpu_torch import Cosmology, CosmologyInputError  # noqa: E402
from cosmoprimo_tpu_torch.cosmology import CosmologyError, _infer_device  # noqa: E402
from cosmoprimo_tpu_torch.fiducial import DESI  # noqa: E402
from cosmoprimo_tpu_torch.interpolator import kernel_tophat2  # noqa: E402
from cosmoprimo_tpu_torch.models.eisenstein_hu import compute_eh98_coefficients  # noqa: E402

RTOL = 1e-12
B = 4


def batch_params(seed=0):
    rng = np.random.default_rng(seed)
    return dict(omega_cdm=rng.uniform(0.11, 0.13, B), omega_b=rng.uniform(0.021, 0.023, B),
                h=rng.uniform(0.65, 0.70, B), n_s=rng.uniform(0.94, 0.98, B), logA=rng.uniform(2.9, 3.1, B))


def row(params, i):
    return {name: float(value[i]) for name, value in params.items()}


@pytest.fixture(scope='module')
def cosmos():
    params = batch_params()
    port = Cosmology(engine='eisenstein_hu', **{name: torch.from_numpy(v) for name, v in params.items()})
    refs = [jcp.Cosmology(engine='eisenstein_hu', **row(params, i)) for i in range(B)]
    return port, refs


INPUTS = [
    dict(omega_cdm=0.12, omega_b=0.022, h=0.68, n_s=0.96, logA=3.0),
    dict(Omega_m=0.31, Omega_b=0.049, H0=67.0, A_s=2.1e-9, w0_fld=-0.9, wa_fld=0.1, Omega_k=0.01),
    dict(omch2=0.12, ombh2=0.022, h=0.7, ns=0.97, sigma8=0.8, N_eff=3.2, T_cmb=2.7),
    dict(omega_cdm=0.12, omega_b=0.022, h=0.68, Omega_g=5e-5, Omega_ur=3e-5, r=0.1, alpha_s=0.01),
]


@pytest.mark.parametrize('inputs', INPUTS)
def test_compile_params(inputs):
    port = Cosmology(device='cpu', **inputs)._params
    ref = jcp.Cosmology(**inputs)._params
    assert set(port) == set(ref)
    for name, value in ref.items():
        if isinstance(value, (str, bool, list)) or name in ('z_pk', 'kmax_pk', 'ellmax_cl'):
            assert np.all(port[name] == value), name
        else:
            np.testing.assert_allclose(port[name].numpy(), np.asarray(value), rtol=RTOL, err_msg=name)


@pytest.mark.parametrize('inputs', INPUTS[:2])
def test_from_state(inputs):
    ref = jcp.Cosmology(engine='eisenstein_hu', **inputs)
    port = Cosmology.from_state(ref.__getstate__(), device='cpu')
    assert port.engine.name == 'eisenstein_hu' and port.batch_shape == ()
    for name in ('Omega_m', 'Omega_de', 'Omega_r', 'N_eff', 'omega_b', 'logA', 'Omega_Lambda', 'Omega_fld', 'K'):
        np.testing.assert_allclose(port[name].numpy(), np.asarray(ref[name]), rtol=RTOL, err_msg=name)
    z = np.array([0.0, 0.5, 1.0, 3.0])
    np.testing.assert_allclose(port.get_background().efunc(z).numpy(),
                               np.asarray(ref.get_background().efunc(z)), rtol=RTOL)


def test_background(cosmos):
    port, refs = cosmos
    ba = port.get_background()
    z = np.array([[0.0, 0.3, 0.5], [1.0, 2.0, 10.0]])
    for name in ('efunc', 'hubble_function', 'Omega_m', 'Omega_de', 'Omega_r', 'Omega_b', 'Omega_k',
                 'comoving_radial_distance', 'growth_factor', 'growth_rate'):
        got = getattr(ba, name)(torch.from_numpy(z)).numpy()
        assert got.shape == (B,) + z.shape, name
        for i, ref in enumerate(refs):
            np.testing.assert_allclose(got[i], np.asarray(getattr(ref.get_background(), name)(z)), rtol=RTOL,
                                       err_msg=name)
    assert ba.comoving_radial_distance(1.0).shape == (B,)
    np.testing.assert_array_equal(port.comoving_radial_distance(z).numpy(), ba.comoving_radial_distance(z).numpy())
    assert np.isnan(ba.comoving_radial_distance(np.array([-1.0, 1e5])).numpy()).all()


def test_eh98(cosmos):
    port, refs = cosmos
    coeffs = compute_eh98_coefficients(port.engine)
    k = np.geomspace(1e-5, 1e2, 300)
    tr = port.get_transfer().transfer_k(torch.from_numpy(k)).numpy()
    pk_k = port.get_primordial().pk_k(torch.from_numpy(k)).numpy()
    for i, ref in enumerate(refs):
        for name, value in jeh98(ref.engine).items():
            np.testing.assert_allclose(coeffs[name][i].item(), float(value), rtol=RTOL, err_msg=name)
        np.testing.assert_allclose(tr[i], np.asarray(ref.get_transfer().transfer_k(k)), rtol=RTOL)
        np.testing.assert_allclose(pk_k[i], np.asarray(ref.get_primordial().pk_k(k)), rtol=RTOL)


@pytest.mark.parametrize('of', ['delta_m', 'theta_m'])
def test_pk_interpolator(cosmos, of):
    port, refs = cosmos
    k = np.concatenate([np.geomspace(1e-5, 1e2, 200), [1e-8, 1e3]])
    z = np.array([0.0, 0.5, 2.0, 11.0])
    pk = port.get_fourier().pk_interpolator(of=of)
    grid = pk(torch.from_numpy(k), torch.from_numpy(z)).numpy()
    paired = pk(torch.from_numpy(k[:4]), torch.from_numpy(z), grid=False).numpy()
    flat = pk(torch.from_numpy(k), torch.from_numpy(z), ignore_growth=True).numpy()
    assert grid.shape == (B, k.size, z.size) and paired.shape == (B, 4)
    for i, ref in enumerate(refs):
        jpk = ref.get_fourier().pk_interpolator(of=of)
        np.testing.assert_allclose(grid[i], np.asarray(jpk(k, z)), rtol=RTOL)
        np.testing.assert_allclose(paired[i], np.asarray(jpk(k[:4], z, grid=False)), rtol=RTOL)
        np.testing.assert_allclose(flat[i], np.asarray(jpk(k, z, ignore_growth=True)), rtol=RTOL)
    assert np.isnan(grid[:, -2:]).all() and np.isnan(grid[:, :, -1]).all()
    pk1d = port.get_primordial().pk_interpolator()(torch.from_numpy(k)).numpy()
    np.testing.assert_allclose(pk1d[0], np.asarray(refs[0].get_primordial().pk_interpolator()(k)), rtol=RTOL)


def test_kernel_tophat2():
    x = np.concatenate([np.geomspace(1e-4, 1e3, 500), [0.0, 0.0999999, 0.1]])
    np.testing.assert_allclose(kernel_tophat2(torch.from_numpy(x)).numpy(), np.asarray(jkernel_tophat2(jnp.asarray(x))),
                               rtol=RTOL)


def test_invalid_rows_are_nan():
    params = {name: torch.from_numpy(v) for name, v in batch_params(1).items()}
    params['h'] = params['h'].clone()
    params['h'][1] = -0.7
    w0 = torch.tensor([-1.0, -1.0, 0.5, -1.0], dtype=torch.float64)
    cosmo = Cosmology(engine='eisenstein_hu', w0_fld=w0, **params)
    chi = cosmo.get_background().comoving_radial_distance(torch.tensor([0.5, 1.0], dtype=torch.float64))
    np.testing.assert_array_equal(np.isnan(chi.numpy()).any(axis=-1), [False, True, True, False])


def test_not_ported_yet():
    """Massive neutrinos, the hierarchies and a JAX state with them are
    ported, and so are the analytic engines (slice 4b), the emulated engine
    (slice 6a) and the Boltzmann-code wrappers (slice 6d), which raise
    CosmologyInputError naming their host package where it is absent.
    'emulated' with no emulator file raises the JAX package's not-found
    CosmologyError."""
    assert Cosmology(engine='eisenstein_hu', m_ncdm=0.06, device='cpu')['N_ncdm'] == 1
    assert Cosmology(engine='eisenstein_hu', neutrino_hierarchy='normal', m_ncdm=0.1, device='cpu')['N_ncdm'] == 3
    state = jcp.Cosmology(engine='eisenstein_hu', m_ncdm=0.06).__getstate__()
    assert Cosmology.from_state(state, device='cpu')['N_ncdm'] == 1
    for engine in ('bbks', 'eisenstein_hu_nowiggle_variants'):
        assert Cosmology(engine=engine, device='cpu').engine.name == engine
    for engine, module in (('class', 'pyclass'), ('camb', 'camb')):
        with pytest.raises(CosmologyInputError, match=f'{module} is required for engine'):
            Cosmology(engine=engine, device='cpu')
    with pytest.raises(jcp.CosmologyError, match='Emulator file None not found'):
        jcp.Cosmology(engine='emulated')
    with pytest.raises(CosmologyError, match='Emulator file None not found'):
        Cosmology(engine='emulated', device='cpu')


def test_default_device(monkeypatch):
    """Float inputs pick the CUDA card; tensors keep their device; device='cpu'
    runs on the CPU; without a card, a build that names no device raises."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    assert _infer_device({'h': 0.7, 'omega_cdm': np.float64(0.12)}) == torch.device('cuda')
    assert _infer_device({'h': 0.7, 'm_ncdm': [torch.zeros(2, dtype=torch.float64)]}) == torch.device('cpu')
    assert _infer_device({'h': 0.7}, device='cpu') == torch.device('cpu')
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for build in (lambda: Cosmology(h=0.7), lambda: Cosmology.from_state(jcp.Cosmology().__getstate__()),
                  lambda: DESI(engine='eisenstein_hu')):
        with pytest.raises(CosmologyError, match="device='cpu'"):
            build()
    assert Cosmology(h=0.7, device='cpu').device == torch.device('cpu')
    assert DESI(engine='eisenstein_hu', device='cpu').device == torch.device('cpu')
