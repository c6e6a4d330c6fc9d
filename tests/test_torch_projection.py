"""The port's line-of-sight projection (cosmoprimo_tpu_torch/boltzmann/
harmonic.py and bessel.py) against the JAX package's, on the CPU.

Bars, and the deviations measured on the CPU:
- default_ells, the Bessel tables (scipy's jv on the host), coarse_k_grid,
  fine_k_grid, cl_kmin and tensor_cl_kmin: exact; fine_k_grid raises for
  kmax <= K_LOG_SWITCH, where the JAX package's grid runs backwards;
- sin_K for flat, open and closed curvatures: 1e-15 (measured 0);
- project_sources and limber_pp on the JAX package's own source dict (the
  DESI fiducial at n_steps = (2048, 768, 2048) on the coarse grid to
  kmax = 0.05 /Mpc, lmax = 150, 61 multipoles): each spectrum 1e-12 of its
  max (measured <= 3.6e-15 on the projection, 8.0e-17 on Limber); the
  projection in float32 against float64, 1e-4 of the max (a check of the
  ``dtype`` path);
- the same two functions on a batch of two flat cosmologies (the DESI
  fiducial, and h = 0.70, omega_cdm = 0.125, n_s = 0.95, logA = 3.1), each
  row in its own chunk (PROJECTION_BYTES patched down), every row against
  the JAX package's result for its cosmology alone: 1e-12 of the max
  (measured <= 3.6e-15 on the projection, 8.0e-17 on Limber);
- _hermite_gather (outside the table too) and _spline_to_integers on
  seeded data: 1e-12 of the max.
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')

import jax.numpy as jnp  # noqa: E402

from cosmoprimo_tpu.boltzmann import bessel as JB, harmonic as JH, perturbations as JP, tensor as JT  # noqa: E402
from cosmoprimo_tpu.boltzmann.thermodynamics import ThermodynamicsResult as JaxResult  # noqa: E402
from cosmoprimo_tpu.fiducial import DESI as JaxDESI  # noqa: E402
from cosmoprimo_tpu_torch.boltzmann import bessel as B, harmonic as H, tensor as T  # noqa: E402
from test_torch_perturbations import jax_cosmology  # noqa: E402

BAR = 1e-12
LMAX, KMAX = 150, 0.05
N_STEPS = (2048, 768, 2048)


@pytest.fixture(autouse=True)
def bessel_caches(tmp_path, monkeypatch):
    """Both packages' disk caches of the Bessel tables in tmp_path."""
    monkeypatch.setattr(JB, '_CACHE_DIR', str(tmp_path / 'jax'))
    monkeypatch.setattr(B, '_CACHE_DIR', str(tmp_path / 'torch'))


def test_ells_tables_and_grids():
    for lmax in (20, 48, 150, 2500, 2900):
        np.testing.assert_array_equal(B.default_ells(lmax), JB.default_ells(lmax))
    ells = JB.default_ells(100)
    for got, want in zip(B.bessel_tables(ells, 300.0), JB.bessel_tables(ells, 300.0)):
        np.testing.assert_array_equal(got, want)
    for kmax in (0.005, 0.012, 0.05, 0.12, 0.5354):
        np.testing.assert_array_equal(H.coarse_k_grid(kmax), JH.coarse_k_grid(kmax))
        np.testing.assert_array_equal(H.fine_k_grid(kmax), JH.fine_k_grid(kmax))
    with pytest.raises(ValueError, match='kmax'):
        H.fine_k_grid(0.003)
    for K in (0.0, -2e-8, 3e-9):
        assert H.cl_kmin(K) == JH.cl_kmin(K)
        assert T.tensor_cl_kmin(K) == JT.tensor_cl_kmin(K)
        chi = np.linspace(0.0, 14000.0, 50)
        np.testing.assert_allclose(H.sin_K(torch.from_numpy(chi), K).numpy(), np.asarray(JH.sin_K(jnp.asarray(chi), K)),
                                   rtol=1e-15, atol=0)


def other_cosmology():
    """A second flat cosmology for the batch test, its primordial spectrum
    and expansion unlike the DESI fiducial's, as jax_cosmology gives it."""
    cosmo = JaxDESI(engine='native').clone(h=0.70, omega_cdm=0.125, n_s=0.95, logA=3.1)
    params, table = jax.jit(lambda: (cosmo.engine._perturbation_params(),
                                     cosmo.get_thermodynamics().table.__dict__))()
    return ({n: np.asarray(v) for n, v in params.items()}, {n: np.asarray(v) for n, v in table.items()})


@functools.lru_cache(maxsize=None)
def jax_sources(name='desi'):
    """The JAX package's source dict of the cosmology ``name`` ('desi' or
    'other'), the port's copy, the coarse k grid, and the JAX package's
    project_sources and limber_pp of it at LMAX."""
    params, table = jax_cosmology('desi') if name == 'desi' else other_cosmology()
    k = JH.coarse_k_grid(KMAX)
    src = jax.jit(lambda p, t: JP.compute_los_sources(p, JaxResult(**t), jnp.asarray(k), n_steps=N_STEPS))(params,
                                                                                                           table)
    src = {name: np.asarray(value) for name, value in src.items()}
    P_R = tuple(float(params[name]) for name in ('n_s', 'A_s', 'k_pivot', 'alpha_s', 'beta_s'))

    def t(value):
        return torch.from_numpy(np.array(value, dtype=np.float64))

    port = {'tau': t(src['tau'])[None], 'src': t(src['src'])[None], 'g': t(src['g'])[None], 'emk': t(src['emk'])[None],
            'eta0': t(src['eta0']).reshape(1, 1), 'tau_star': t(src['tau_star']).reshape(1, 1), 'k': t(k)[None],
            'P_R_params': tuple(t([v]) for v in P_R), 'K': torch.zeros((1, 1), dtype=torch.float64)}
    ells = JB.default_ells(LMAX)
    jsrc = dict({name: value for name, value in src.items() if name != 'k'}, P_R_params=P_R, k=jnp.asarray(k), K=0.0)
    ref = JH.project_sources(jsrc, ells, JB.bessel_tables(ells, KMAX * 1.05 * 16000.0))
    ref = {name: np.asarray(value) for name, value in ref.items()}
    return port, ref, np.asarray(JH.limber_pp(jsrc, ells))


def test_projection_and_limber():
    port, ref, ref_pp = jax_sources()
    ells = JB.default_ells(LMAX)
    got = H.project_sources(port, ells, B.bessel_tables(ells, KMAX * 1.05 * 16000.0))
    for name, want in ref.items():
        assert np.max(np.abs(got[name][0].numpy() - want)) <= BAR * np.max(np.abs(want)), name
    assert np.max(np.abs(H.limber_pp(port, ells)[0].numpy() - ref_pp)) <= BAR * np.max(np.abs(ref_pp))
    single = H.project_sources(port, ells, B.bessel_tables(ells, KMAX * 1.05 * 16000.0), dtype=torch.float32)
    for name in ('tt', 'ee', 'te'):
        assert single[name].dtype == torch.float64
        assert torch.max(torch.abs(single[name] - got[name])) <= 1e-4 * torch.max(torch.abs(got[name]))


def test_projection_batch_rows(monkeypatch):
    """Two flat cosmologies in one batch, each projected in its own row
    chunk, against the JAX package's projection of each alone."""
    rows = [jax_sources(name) for name in ('desi', 'other')]
    port = {name: (tuple(torch.cat(parts) for parts in zip(*(r[0][name] for r in rows))) if name == 'P_R_params'
                   else torch.cat([r[0][name] for r in rows])) for name in rows[0][0]}
    port['k'] = rows[0][0]['k'].expand(2, -1)
    assert not torch.equal(port['tau'][0], port['tau'][1])
    monkeypatch.setattr(H, 'PROJECTION_BYTES', 1.0)
    assert len(H._row_chunks(2, 100, 100)) == 2
    ells = JB.default_ells(LMAX)
    got = H.project_sources(port, ells, B.bessel_tables(ells, KMAX * 1.05 * 16000.0))
    got_pp = H.limber_pp(port, ells)
    for b, (_, ref, ref_pp) in enumerate(rows):
        for name, want in ref.items():
            assert np.max(np.abs(got[name][b].numpy() - want)) <= BAR * np.max(np.abs(want)), (b, name)
        assert np.max(np.abs(got_pp[b].numpy() - ref_pp)) <= BAR * np.max(np.abs(ref_pp)), b
    assert np.max(np.abs(rows[0][1]['tt'] / rows[1][1]['tt'] - 1.0)) > 1e-2


def test_hermite_gather():
    rng = np.random.default_rng(6)
    tab, dtab = rng.normal(size=(2, 200))
    u = rng.uniform(-2.0, 205.0, size=(3, 50))
    got = H._hermite_gather(torch.from_numpy(tab), torch.from_numpy(dtab), torch.from_numpy(u)).numpy()
    want = np.asarray(JH._hermite_gather(jnp.asarray(tab), jnp.asarray(dtab), jnp.asarray(u)))
    assert np.max(np.abs(got - want)) <= BAR * np.max(np.abs(want))


def test_spline_to_integers():
    ells = JB.default_ells(300)
    rng = np.random.default_rng(4)
    cl = 1e-10 / (ells * (ells + 1.0)) * (1.0 + 0.2 * np.sin(ells / 40.0)) * rng.uniform(0.9, 1.1, size=(2, 1))
    got = H._spline_to_integers(ells, torch.from_numpy(cl), 300).numpy()
    for b in range(2):
        want = np.asarray(JH._spline_to_integers(ells, jnp.asarray(cl[b]), 300))
        assert np.max(np.abs(got[b] - want)) <= BAR * np.max(np.abs(want))
