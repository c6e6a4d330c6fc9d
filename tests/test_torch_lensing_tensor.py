"""The port's lensing and tensor modes (cosmoprimo_tpu_torch/boltzmann/
lensing.py and tensor.py) against the JAX package's, on the CPU.

Bars, and the deviations measured on the CPU:
- lensed_cls on seeded spectra (two rows, lmax = 300, n_r = 1024): each
  lensed spectrum 1e-12 of its max (measured <= 1.5e-15);
- compute_tensor_sources at N_STEPS_T = 2048 and M_TAB = 2048 (both
  packages patched) on 17 k <= 0.05 /Mpc, two cosmologies in one batch
  (the DESI one; w0 = -0.9, wa = 0.1, Omega_k = 0.02): the two source rows
  1e-9 of their max (measured <= 1.7e-14), the tau grid, g and e^-kappa
  1e-12 (measured <= 3.9e-14);
- project_tensor_sources on the JAX package's own source dict (lmax = 100,
  r = 0.1): 1e-12 of each spectrum's max (measured <= 4e-16);
- compute_tensor_cls on three copies of one cosmology with r = 0, 0.05 and
  0.1 (n_t = alpha_t = 0): the r = 0 row exactly 0, the r = 0.1 row twice
  the r = 0.05 row to 1e-14 (P_T is proportional to r).
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')

import jax.numpy as jnp  # noqa: E402

from cosmoprimo_tpu.boltzmann import bessel as JB, lensing as JL, perturbations as JP, tensor as JT  # noqa: E402
from cosmoprimo_tpu.boltzmann.thermodynamics import ThermodynamicsResult as JaxResult  # noqa: E402
from cosmoprimo_tpu_torch.boltzmann import bessel as B, lensing as L, perturbations as P, tensor as T  # noqa: E402
from test_torch_perturbations import jax_cosmology, row_err, torch_inputs  # noqa: E402

BAR = 1e-12
SRC_BAR = 1e-9
NAMES = ('desi', 'w0wa_curved')


@pytest.fixture(autouse=True)
def budget(tmp_path, monkeypatch):
    """The reduced tensor budget in both packages, their Bessel caches in tmp_path."""
    for mod in (JT, T):
        monkeypatch.setattr(mod, 'N_STEPS_T', 2048)
    for mod in (JP, P):
        monkeypatch.setattr(mod, 'M_TAB', 2048)
    monkeypatch.setattr(JB, '_CACHE_DIR', str(tmp_path / 'jax'))
    monkeypatch.setattr(B, '_CACHE_DIR', str(tmp_path / 'torch'))


def test_lensed_cls():
    rng = np.random.default_rng(3)
    lmax = 300
    ell = np.arange(lmax + 1.0)
    base = 1e-10 / (ell * (ell + 1.0) + 10.0) * (1.0 + 0.3 * np.sin(ell / 30.0))
    scale = rng.uniform(0.8, 1.2, size=(5, 2, 1))
    cls = [base * scale[0], 0.05 * base * scale[1], 1e-3 * base * scale[2], 0.2 * base * np.cos(ell / 20.0) * scale[3],
           2e-9 / (ell + 1.0) ** 4 * (ell * (ell + 1.0)) * scale[4]]
    got = L.lensed_cls(*[torch.from_numpy(c) for c in cls], n_r=1024)
    for b in range(2):
        ref = jax.jit(lambda *c: JL.lensed_cls(*c, n_r=1024))(*[jnp.asarray(c[b]) for c in cls])
        for name, want in ref.items():
            want = np.asarray(want)
            assert np.max(np.abs(got[name][b].numpy() - want)) <= BAR * np.max(np.abs(want)), name


@functools.lru_cache(maxsize=None)
def jax_tensor_sources(name, k):
    params, table = jax_cosmology(name)
    out = jax.jit(lambda p, t: JT.compute_tensor_sources(p, JaxResult(**t), jnp.asarray(np.array(k))))(params, table)
    return {key: np.asarray(value) for key, value in out.items()}


def test_tensor_sources():
    k = JT.coarse_k_grid(0.05)[::4]
    params, thermo = torch_inputs(list(NAMES))
    got = T.compute_tensor_sources(params, thermo, torch.from_numpy(k).expand(len(NAMES), -1).contiguous())
    for i, name in enumerate(NAMES):
        ref = jax_tensor_sources(name, tuple(k))
        for key in ('tau', 'g', 'emk'):
            assert row_err(got[key][i].numpy(), ref[key]) <= BAR, (name, key)
        for row in range(2):
            assert row_err(got['src'][i, :, row].numpy(), ref['src'][:, row]) <= SRC_BAR, (name, row)


def test_tensor_projection():
    kk = JT.coarse_k_grid(0.05)
    src = jax_tensor_sources('desi', tuple(kk))
    params, _ = jax_cosmology('desi')
    ells = JB.default_ells(100)
    x_max = 0.05 * 1.05 * 16000.0
    r, As, kp = 0.1, float(params['A_s']), float(params['k_pivot'])

    def P_T(k):
        return r * As * (k / kp) ** (-r / 8.0)

    ref = JT.project_tensor_sources(dict(src, k=jnp.asarray(kk), K=0.0), ells, JB.bessel_tables(ells, x_max), P_T)

    def t(value):
        return torch.from_numpy(np.array(value, dtype=np.float64))

    port = {'tau': t(src['tau'])[None], 'src': t(src['src'])[None], 'g': t(src['g'])[None], 'emk': t(src['emk'])[None],
            'eta0': t(src['eta0']).reshape(1, 1), 'k': t(kk)[None], 'K': torch.zeros((1, 1), dtype=torch.float64)}
    got = T.project_tensor_sources(port, ells, B.bessel_tables(ells, x_max), lambda k: P_T(k)[None])
    for name, want in ref.items():
        want = np.asarray(want)
        assert np.max(np.abs(got[name][0].numpy() - want)) <= BAR * np.max(np.abs(want)), name


def test_bb_proportional_to_r():
    params, thermo = torch_inputs(['desi'] * 3)
    r = torch.tensor([0.0, 0.05, 0.1], dtype=torch.float64)
    params.update(r=r, n_t=torch.zeros_like(r), alpha_t=torch.zeros_like(r))
    out = T.compute_tensor_cls(params, thermo, lmax=60)
    for name in ('tt', 'ee', 'bb', 'te'):
        assert torch.all(out[name][0] == 0.0), name
        assert torch.all(torch.isfinite(out[name]))
        np.testing.assert_allclose(out[name][2].numpy(), 2.0 * out[name][1].numpy(), rtol=1e-14, atol=0, err_msg=name)
    assert torch.all(out['bb'][1:, 2:] > 0.0)
