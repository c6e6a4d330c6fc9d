"""The port's massive-neutrino sector (cosmoprimo_tpu_torch/cosmology.py:
compute_ncdm_momenta, the Omega_ncdm -> mass Newton inversion, the
neutrino hierarchies, the ncdm densities of the background and
Cosmology.from_state with massive neutrinos) against the JAX package's, on
parameters made from a seed with numpy. The port runs the batch in one
call; the JAX package one cosmology at a time.

Bars: rtol 1e-12 on the momenta integrals, the densities, the inverted
masses and the hierarchy splits (the same 100-point Gauss-Laguerre sums in
float64; the Newton loops stop at the same 1e-15 rule, row by row).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

import cosmoprimo_tpu as jcp  # noqa: E402
from cosmoprimo_tpu.cosmology import BaseBackground as JBase  # noqa: E402
from cosmoprimo_tpu.cosmology import compute_ncdm_momenta as jmomenta  # noqa: E402
from cosmoprimo_tpu_torch import Cosmology  # noqa: E402
from cosmoprimo_tpu_torch.cosmology import BaseBackground, compute_ncdm_momenta  # noqa: E402

RTOL = 1e-12
B = 3
Z = np.array([0.0, 0.3, 1.0, 5.0, 1e3])


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def draws(seed=0):
    rng = np.random.default_rng(seed)
    return dict(omega_cdm=rng.uniform(0.11, 0.13, B), omega_b=rng.uniform(0.021, 0.023, B),
                h=rng.uniform(0.65, 0.70, B), logA=rng.uniform(2.9, 3.1, B)), rng


@pytest.mark.parametrize('out', ['rho', 'p', 'drhodm'])
def test_compute_ncdm_momenta(out):
    rng = np.random.default_rng(1)
    T_eff, m = rng.uniform(1.9, 2.0, B), rng.uniform(0.0, 0.3, B)
    got = compute_ncdm_momenta(t(T_eff), t(m), t(Z), out=out).numpy()
    assert got.shape == (B, Z.size)
    for i in range(B):
        np.testing.assert_allclose(got[i], np.asarray(jmomenta(T_eff[i], m[i], jnp.asarray(Z), out=out)), rtol=RTOL)


CASES = {
    'one species': lambda s: dict(m_ncdm=[0.06 * s]),
    'three species': lambda s: dict(m_ncdm=[0.02 * s, 0.05 * s, 0.1 * s], T_ncdm_over_cmb=[0.71, 0.72, 0.716]),
    'Omega_ncdm': lambda s: dict(Omega_ncdm=[0.0015 * s]),
    'omega_ncdm with a massless species': lambda s: dict(omega_ncdm=[0.0006442 * s, 0.0 * s]),
    'normal': lambda s: dict(m_ncdm=0.11 * s, neutrino_hierarchy='normal'),
    'inverted': lambda s: dict(m_ncdm=0.13 * s, neutrino_hierarchy='inverted'),
    'degenerate': lambda s: dict(m_ncdm=0.09 * s, neutrino_hierarchy='degenerate'),
    'Omega_m': lambda s: dict(m_ncdm=[0.06 * s], Omega_m=0.31),
}


@pytest.mark.parametrize('case', list(CASES))
def test_neutrino_sector_against_jax(case):
    """Compiled parameters, the ncdm Omegas and N_eff of a batch of 3 whose
    masses (or mass sums, or densities) differ by row, per cosmology."""
    params, rng = draws()
    scale = rng.uniform(0.9, 1.1, B)
    inputs = CASES[case]
    if case == 'Omega_m':
        params.pop('omega_cdm')
    port = Cosmology(engine='eisenstein_hu', **{name: t(v) for name, v in params.items()}, **inputs(t(scale)))
    for i in range(B):
        ref = jcp.Cosmology(engine='eisenstein_hu', **{name: float(v[i]) for name, v in params.items()},
                            **inputs(float(scale[i])))
        for name in ('m_ncdm', 'T_ncdm_over_cmb', 'Omega_ncdm', 'Omega_pncdm'):
            np.testing.assert_allclose(port[name][:, i].numpy(), np.asarray(ref[name]), rtol=RTOL, err_msg=name)
        for name in ('N_ur', 'N_eff', 'm_ncdm_tot', 'Omega_ncdm_tot', 'Omega_m', 'Omega_cdm', 'Omega_de', 'Omega_r'):
            np.testing.assert_allclose(port[name][i].item(), float(ref[name]), rtol=RTOL, err_msg=name)
        assert port['N_ncdm'] == ref['N_ncdm']


def test_background_densities_against_jax():
    """rho/p_ncdm (species and totals), Omega_ncdm(z), T_ncdm(z) and E(z)
    of the table-backed background and of the direct integrals."""
    params, rng = draws(2)
    m = rng.uniform(0.05, 0.15, B)
    port = Cosmology(engine='eisenstein_hu', m_ncdm=[t(m), t(2 * m)], **{name: t(v) for name, v in params.items()})
    ba = port.get_background()
    for i in range(B):
        ref = jcp.Cosmology(engine='eisenstein_hu', m_ncdm=[m[i], 2 * m[i]],
                            **{name: float(v[i]) for name, v in params.items()}).get_background()
        for name in ('rho_ncdm', 'p_ncdm', 'Omega_ncdm', 'Omega_pncdm', 'T_ncdm'):
            np.testing.assert_allclose(getattr(ba, name)(t(Z))[:, i].numpy(), np.asarray(getattr(ref, name)(Z)),
                                       rtol=RTOL, err_msg=name)
            np.testing.assert_allclose(getattr(ba, name)(t(Z), species=1)[i].numpy(),
                                       np.asarray(getattr(ref, name)(Z, species=1)), rtol=RTOL, err_msg=name)
        for name in ('rho_ncdm_tot', 'p_ncdm_tot', 'efunc', 'Omega_m', 'Omega_r', 'T_cmb'):
            np.testing.assert_allclose(getattr(ba, name)(t(Z))[i].numpy(), np.asarray(getattr(ref, name)(Z)),
                                       rtol=RTOL, err_msg=name)
        for name in ('rho_ncdm', 'p_ncdm'):
            np.testing.assert_allclose(getattr(BaseBackground, name)(ba, t(Z))[:, i].numpy(),
                                       np.asarray(getattr(JBase, name)(ref, Z)), rtol=RTOL, err_msg=name)


def test_from_state_with_massive_neutrinos():
    ref = jcp.Cosmology(engine='eisenstein_hu', m_ncdm=[0.06, 0.1], omega_cdm=0.12, logA=3.0)
    port = Cosmology.from_state(ref.__getstate__(), device='cpu')
    assert port.batch_shape == () and port['m_ncdm'].shape == (2,)
    for name in ('Omega_m', 'Omega_ncdm_tot', 'N_eff', 'm_ncdm_tot'):
        np.testing.assert_allclose(port[name].numpy(), np.asarray(ref[name]), rtol=RTOL, err_msg=name)
    np.testing.assert_allclose(port.get_background().comoving_radial_distance(t(Z)).numpy(),
                               np.asarray(ref.get_background().comoving_radial_distance(Z)), rtol=RTOL)
