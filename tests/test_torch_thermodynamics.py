"""The port's recombination history, its root finding and the native
Thermodynamics section (cosmoprimo_tpu_torch/boltzmann/thermodynamics.py,
ops/roots.py::bisect, models/native.py) against the JAX package's, on the
same inputs made from a seed with numpy, on the CPU.

Bars, and the deviations measured on the CPU:
- compute_thermodynamics for a batch of 3 cosmologies (one with a 0.06 eV
  neutrino): scalars rtol 1e-10 (measured <= 2.2e-16), the tables x_e,
  T_m, kappa_prime, tau and tau_drag 1e-10 of each table's max (measured
  <= 1.3e-15). The port's Newton steps take d/dx in closed form where the
  JAX package takes jax.grad;
- every property of DESI(engine='native').get_thermodynamics(): rtol 1e-10
  (measured <= 6.7e-16);
- torch.func.jacfwd of z_drag in omega_b against jax.jacfwd: rtol 1e-8
  (measured 8.9e-16), on a 385-point grid (see the test);
- the atomic rates and Saha fractions on a temperature grid: rtol 1e-12;
- bisect, both methods, per row, an end-point root and a bracket with no
  sign change (NaN, as the JAX function gives under jit): rtol 1e-14.
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')

import jax.numpy as jnp  # noqa: E402

import cosmoprimo_tpu as jcp  # noqa: E402
from cosmoprimo_tpu.boltzmann import compute_thermodynamics as jax_thermo  # noqa: E402
from cosmoprimo_tpu.fiducial import DESI as JaxDESI  # noqa: E402
from cosmoprimo_tpu.ops.roots import bisect as jax_bisect  # noqa: E402
from cosmoprimo_tpu_torch import Cosmology  # noqa: E402
from cosmoprimo_tpu_torch.boltzmann import compute_thermodynamics  # noqa: E402
from cosmoprimo_tpu_torch.fiducial import DESI  # noqa: E402
from cosmoprimo_tpu_torch.ops.roots import bisect  # noqa: E402

RTOL = 1e-10
SCALARS = ('z_star', 'z_drag', 'z_star_noreion', 'tau_reio', 'z_reio', 'YHe', 'f_He', 'n_H0')
TABLES = ('x_e', 'T_m', 'kappa_prime', 'tau', 'tau_drag')
PROPERTIES = ('rs_drag', 'z_drag', 'rs_star', 'z_star', 'z_star_noreion', 'rs_star_noreion', 'tau_reio', 'z_reio',
              'YHe', 'theta_star', 'theta_cosmomc')


def batch_params():
    """Three cosmologies; the second has a 0.06 eV neutrino, the others a
    massless species."""
    rng = np.random.default_rng(5)
    return dict(omega_cdm=rng.uniform(0.11, 0.13, 3), omega_b=rng.uniform(0.021, 0.023, 3),
                h=rng.uniform(0.65, 0.70, 3), tau_reio=rng.uniform(0.05, 0.07, 3), m_ncdm=np.array([0.0, 0.06, 0.0]))


def test_compute_thermodynamics_batch():
    params = batch_params()

    @functools.lru_cache(maxsize=None)
    def single(m):
        """One cosmology, jitted; the species mass is static, the rest traced."""
        def run(omega_cdm, omega_b, h, tau_reio):
            cosmo = jcp.Cosmology(omega_cdm=omega_cdm, omega_b=omega_b, h=h, m_ncdm=[m], engine='eisenstein_hu')
            th = jax_thermo(cosmo['omega_b'], cosmo['h'], cosmo['T_cmb'], cosmo.get_background().efunc,
                            tau_reio=tau_reio, N_eff=cosmo['N_eff'])
            return {name: getattr(th, name) for name in SCALARS + TABLES}

        return jax.jit(run)

    rows = [single(float(params['m_ncdm'][i]))(*(params[n][i] for n in ('omega_cdm', 'omega_b', 'h', 'tau_reio')))
            for i in range(3)]
    ref = {name: np.stack([np.asarray(row[name]) for row in rows]) for name in SCALARS + TABLES}
    t = {name: torch.from_numpy(v) for name, v in params.items()}
    cosmo = Cosmology(omega_cdm=t['omega_cdm'], omega_b=t['omega_b'], h=t['h'], m_ncdm=[t['m_ncdm']],
                      engine='eisenstein_hu')
    th = compute_thermodynamics(cosmo['omega_b'], cosmo['h'], cosmo['T_cmb'], cosmo.get_background().efunc,
                                tau_reio=t['tau_reio'], N_eff=cosmo['N_eff'])
    for name in SCALARS:
        np.testing.assert_allclose(getattr(th, name).numpy(), np.asarray(ref[name]), rtol=RTOL, err_msg=name)
    for name in TABLES:
        got, want = getattr(th, name).numpy(), np.asarray(ref[name])
        assert got.shape == want.shape == (3, 6145)
        err = np.max(np.abs(got - want), axis=-1) / np.max(np.abs(want), axis=-1)
        assert np.all(err <= RTOL), (name, err)


@functools.lru_cache(maxsize=None)
def jax_desi_properties():
    def run():
        th = JaxDESI(engine='native').get_thermodynamics()
        return ({name: getattr(th, name) for name in PROPERTIES},
                th.x_e(jnp.array([0.0, 800.0, 1100.0])), th.T_b(jnp.array([0.0, 800.0, 1100.0])))

    return jax.jit(run)()


def test_desi_thermodynamics_section():
    props, x_e, T_b = jax_desi_properties()
    th = DESI(engine='native', device='cpu').get_thermodynamics()
    for name in PROPERTIES:
        np.testing.assert_allclose(getattr(th, name).item(), float(props[name]), rtol=RTOL, err_msg=name)
    z = torch.tensor([0.0, 800.0, 1100.0], dtype=torch.float64)
    np.testing.assert_allclose(th.x_e(z).numpy(), np.asarray(x_e), rtol=RTOL)
    np.testing.assert_allclose(th.T_b(z).numpy(), np.asarray(T_b), rtol=RTOL)
    assert th.table.x_e.shape == (6145,)


def coarse_grid(monkeypatch, module, n):
    """The static ln a grid of ``module`` cut to ``n`` points."""
    lna = np.linspace(np.log(1e-8), 0.0, n)
    monkeypatch.setattr(module, 'N_GRID', n)
    monkeypatch.setattr(module, 'LNA_GRID', lna)
    monkeypatch.setattr(module, 'DLNA', float(lna[1] - lna[0]))
    monkeypatch.setattr(module, '_HIZ_SLICE', slice(0, int(np.sum(lna <= np.log(1.0 / 51.0)))))


def test_jacfwd_z_drag(monkeypatch):
    """Forward mode through the recombination scan (the JAX contract,
    tests/test_thermodynamics.py: jax.jacfwd of z_drag in omega_b), on a
    385-point grid on both sides: forward mode costs ~0.1 ms an operation
    on the CPU, and the full 6145-point scan would take minutes."""
    from cosmoprimo_tpu.boltzmann import thermodynamics as jax_module
    from cosmoprimo_tpu_torch.boltzmann import thermodynamics as module
    coarse_grid(monkeypatch, jax_module, 385)
    coarse_grid(monkeypatch, module, 385)
    monkeypatch.setattr(module, '_grid_cache', {})
    jba = JaxDESI(engine='native').get_background()
    ref = jax.jit(jax.jacfwd(lambda ob: jax_thermo(ob, 0.6736, 2.7255, jba.efunc, tau_reio=0.0544).z_drag))(0.02237)
    ba = DESI(engine='native', device='cpu').get_background()

    def z_drag(omega_b):
        return compute_thermodynamics(omega_b, 0.6736, 2.7255, ba.efunc, tau_reio=0.0544).z_drag

    got = torch.func.jacfwd(z_drag)(torch.tensor(0.02237, dtype=torch.float64))
    assert float(ref) > 0.0
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-8)


@pytest.mark.parametrize('method', ['ridders', 'bisection'])
def test_bisect(method):
    """Per-row roots of x^2 - c on (0, 2): interior roots, an end-point root
    (c = 4) and a bracket with no sign change (c = 9, NaN)."""
    c = np.array([0.3, 1.0, 2.5, 4.0, 9.0])

    def jax_root(cc):
        return jax_bisect(lambda x: x * x - cc, limits=(0.0, 2.0), xtol=1e-12, method=method)

    ref = np.asarray(jax.jit(jax.vmap(jax_root))(c))
    tc = torch.from_numpy(c)
    got = bisect(lambda x: x * x - tc, limits=(torch.zeros_like(tc), torch.full_like(tc, 2.0)), xtol=1e-12,
                 method=method).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert np.isnan(got[-1]) and got[3] == 2.0
    np.testing.assert_allclose(got[:-1], ref[:-1], rtol=1e-14)
    np.testing.assert_allclose(got[:3], np.sqrt(c[:3]), rtol=1e-10)


def test_atomic_rates():
    """The Saha fractions, the case-B and HeI recombination coefficients and
    their photoionization rates on a temperature grid, rtol 1e-12."""
    from cosmoprimo_tpu.boltzmann import thermodynamics as jt
    from cosmoprimo_tpu_torch.boltzmann import thermodynamics as tt
    T = np.geomspace(10.0, 1e6, 60)
    n_H = 0.2 * (T / 2.7255) ** 3
    for name, args in (('saha_helium_III', (T, n_H, 0.08)), ('saha_helium_II', (T, n_H, 0.08)),
                       ('saha_hydrogen', (T, n_H, 0.05)), ('alpha_B', (T,)), ('_beta2', (T,)),
                       ('alpha_HeI', (T,)), ('_beta_HeI', (T,)), ('YHe_bbn', (np.array([0.021, 0.0225]), 3.0))):
        ref = np.asarray(getattr(jt, name)(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]))
        got = getattr(tt, name)(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args]).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-12, err_msg=name)
