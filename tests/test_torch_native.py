"""The port's native engine and pipeline (cosmoprimo_tpu_torch/models/
native.py, pipelines.make_native_pk_pipeline_batched) against the JAX
package's, on the CPU, at a reduced step budget (n_steps = (2048, 768,
2048), the smallest stable one to k = 0.5 /Mpc).

Bars, and the deviations measured on the CPU:
- Cosmology(engine='native', kmax_pk=0.3, nk_pk=16) with the default
  sigma8 = 0.8 input (the two-pass rescaling): the P(k) tables (delta_m,
  delta_cb) and Transfer.table per k rtol 1e-9 (measured <= 2.4e-10),
  1e-7 below k = 1e-3 h/Mpc (measured 3.6e-8 at k = 1e-4: there the JAX
  package itself moves by 3.2e-9 between two jit traces of the same
  inputs, its superhorizon rounding amplified ~1e7); pk_interpolator on a
  (k, z) grid, sigma8_m, sigma8_cb and sigma_rz rtol 1e-9;
- make_native_pk_pipeline_batched at B = 2, nk = 8, kmax = 0.5 with
  steps_for_kmax patched to the same budget on both sides: pk_m per (z, k)
  and sigma8 rtol 1e-9, 1e-7 below k = 1e-3 h/Mpc (measured <= 2.2e-10);
- the solver's parameters of a batch mixing a massless and a massive row,
  per row against the JAX engine's: exact;
- the closed-model k grid: kmin against the JAX engine's rule, exact; rows
  that would need different k grids raise NotImplementedError;
- the native Harmonic section refuses |Omega_k| > 0.12 on any row and a
  batch whose rows would need different k grids (NotImplementedError, before
  any work); Harmonic and Perturbations build for Omega_k = -0.05.

The reference is run with its phase-A end point moved onto the streaming
switch where its rounding lands past it (tests/native_reference.py; the
JAX package decides that switch by the last bit of its grid, the port as
exact arithmetic does; ROADMAP.md, queue 3). One test holds the engine's
P(k) tables to the reference as it is: rtol 1e-4 on the lanes whose phase A
ends on the switch, 1e-5 on the others, which the switch lanes move
through the sigma8 rescaling (measured 3.6e-5 on one switch lane, 3.64e-6
on every other lane).
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')

import cosmoprimo_tpu as jcp  # noqa: E402
from cosmoprimo_tpu import pipelines as jpipelines  # noqa: E402
from cosmoprimo_tpu.boltzmann import perturbations as JP  # noqa: E402
from cosmoprimo_tpu_torch import Cosmology, CosmologyInputError, make_native_pk_pipeline_batched  # noqa: E402
from cosmoprimo_tpu_torch.boltzmann import perturbations as P  # noqa: E402
from native_reference import exact_switch, switch_lanes  # noqa: E402

N_STEPS = (2048, 768, 2048)
EXTRA = {'nk_pk': 16, 'n_steps_pk': N_STEPS}
RTOL = 1e-9
SWITCH_RTOL = 1e-4      # the unpatched reference, on the lanes whose phase A ends on the streaming switch
RESCALED_RTOL = 1e-5    # the unpatched reference, elsewhere: its switch lanes move sigma8, hence every lane
LOW_K = 1e-3        # h/Mpc: below it the reference itself moves by up to 3.2e-9 between two jit traces
LOW_K_RTOL = 1e-7


def lane_rtol(k):
    return np.where(np.asarray(k) < LOW_K, LOW_K_RTOL, RTOL)


KQ = np.geomspace(2e-4, 0.25, 20)
ZQ = np.array([0.0, 0.7, 2.0])


@functools.lru_cache(maxsize=None)
def port_engine():
    return Cosmology(engine='native', device='cpu', kmax_pk=0.3, extra_params=EXTRA)


def test_engine_fourier_and_transfer(monkeypatch):
    exact_switch(monkeypatch)

    def run():
        cosmo = jcp.Cosmology(engine='native', kmax_pk=0.3, extra_params=EXTRA)
        fo = cosmo.get_fourier()
        # Transfer.table picks its z on the host: take the JAX engine's transfers
        k, z, _, _, tr = cosmo.engine.pk_tables()
        return (fo.table()[2], fo.table(of='delta_cb')[2], fo.pk_interpolator()(KQ, ZQ), fo.sigma8_m, fo.sigma8_cb,
                fo.sigma_rz(np.array([4.0, 12.0]), ZQ), {n: v for n, v in tr.items() if n not in ('k', 'z')},
                cosmo['h'])

    ref = jax.jit(run)()
    cosmo = port_engine()
    fo = cosmo.get_fourier()
    k, z, pk_m = fo.table()
    for got, want in ((pk_m, ref[0]), (fo.table(of='delta_cb')[2], ref[1])):
        err = np.abs(got.numpy() / np.asarray(want) - 1).max(axis=-1)
        assert np.all(err <= lane_rtol(k)), err
    tr = cosmo.get_transfer().table(z=1.0)
    iz = int(np.argmin(np.abs(z - 1.0)))
    assert tr['z'] == z[iz] and abs(z[iz] - 1.0) < 0.05
    for name, value in ref[6].items():
        want = -np.asarray(value)[iz] / (k * float(ref[7])) ** 2
        key = 'd_' + name[6:] if name.startswith('delta_') else name
        if key in tr:
            err = np.abs(tr[key].numpy() - want) / np.abs(want).max()
            assert np.all(err <= lane_rtol(k)), name
    np.testing.assert_allclose(fo.pk_interpolator()(torch.from_numpy(KQ), torch.from_numpy(ZQ)).numpy(),
                               np.asarray(ref[2]), rtol=RTOL)
    np.testing.assert_allclose(fo.sigma8_m.item(), float(ref[3]), rtol=RTOL)
    np.testing.assert_allclose(fo.sigma8_cb.item(), float(ref[4]), rtol=RTOL)
    np.testing.assert_allclose(fo.sigma_rz(torch.tensor([4.0, 12.0], dtype=torch.float64),
                                           torch.from_numpy(ZQ)).numpy(), np.asarray(ref[5]), rtol=RTOL)
    # the sigma8 input: the rescaled spectrum returns the input amplitude
    np.testing.assert_allclose(fo.sigma8_m.item(), 0.8, rtol=1e-10)


def test_engine_against_the_unpatched_reference():
    """The JAX package as it is: the engine's P(k) tables within
    SWITCH_RTOL on the lanes whose phase A ends on the streaming switch, and
    within RESCALED_RTOL elsewhere."""
    def run():
        cosmo = jcp.Cosmology(engine='native', kmax_pk=0.3, extra_params=EXTRA)
        fo = cosmo.get_fourier()
        return (fo.table()[2], fo.table(of='delta_cb')[2], cosmo.engine._perturbation_params(),
                cosmo.get_thermodynamics().table.__dict__)

    pk_m, pk_cb, params, table = jax.jit(run)()
    fo = port_engine().get_fourier()
    k = fo.table()[0]
    on = switch_lanes(params, table, k, N_STEPS)
    assert on.any() and not on.all()
    for got, want in ((fo.table()[2], pk_m), (fo.table(of='delta_cb')[2], pk_cb)):
        err = np.abs(got.numpy() / np.asarray(want) - 1).max(axis=-1)
        assert np.all(err <= np.where(on, SWITCH_RTOL, RESCALED_RTOL)), err


def test_native_pipeline(monkeypatch):
    exact_switch(monkeypatch)
    monkeypatch.setattr(JP, 'steps_for_kmax', lambda kmax: N_STEPS)
    monkeypatch.setattr(P, 'steps_for_kmax', lambda kmax: N_STEPS)
    rng = np.random.default_rng(3)
    params = [rng.uniform(0.11, 0.13, 2), rng.uniform(0.021, 0.023, 2), rng.uniform(0.65, 0.70, 2),
              rng.uniform(0.94, 0.98, 2), rng.uniform(2.9, 3.1, 2)]
    jfn, k = jpipelines.make_native_pk_pipeline_batched(nk=8, kmax=0.5)
    pk_ref, s8_ref = (np.asarray(v) for v in jax.jit(jfn)(*params))
    fn, k_port = make_native_pk_pipeline_batched(nk=8, kmax=0.5)
    pk, s8 = fn(*[torch.from_numpy(p) for p in params])
    np.testing.assert_array_equal(k_port, k)
    assert pk.shape == (2, 2, 8) and s8.shape == (2,)
    err = np.abs(pk.numpy() / pk_ref - 1).max(axis=(0, 1))
    assert np.all(err <= lane_rtol(k)), err
    np.testing.assert_allclose(s8.numpy(), s8_ref, rtol=RTOL)


def test_mixed_batch_parameters():
    """A massless and a massive row in one batch: each row gets the JAX
    engine's parameters for that cosmology."""
    masses = [0.0, 0.06]
    cosmo = Cosmology(engine='native', device='cpu', m_ncdm=[torch.tensor(masses, dtype=torch.float64)])
    got = cosmo.engine._perturbation_params()
    for i, m in enumerate(masses):
        ref = jcp.Cosmology(engine='native', m_ncdm=[m]).engine._perturbation_params()
        for name, value in ref.items():
            want = np.atleast_1d(np.asarray(value, dtype=np.float64))
            row = got[name][..., i].numpy()
            np.testing.assert_allclose(np.atleast_1d(row), want, rtol=1e-14, err_msg=name)


def test_closed_k_grid_and_sections():
    closed = Cosmology(engine='native', device='cpu', Omega_k=-0.05)
    h, omega_k = 0.7, -0.05 * 0.7 ** 2
    K = -omega_k * (100.0 / (299792458.0 / 1e3)) ** 2
    assert closed.engine._kmin() == max(1e-4, 3.2 * np.sqrt(3.0 * K) / h)
    assert Cosmology(engine='native', device='cpu').engine._kmin() == 1e-4
    mixed = Cosmology(engine='native', device='cpu', Omega_k=torch.tensor([0.0, -0.05], dtype=torch.float64))
    with pytest.raises(NotImplementedError, match='different k grids'):
        mixed.engine.pk_tables()
    # the CMB spectra: the |Omega_k| <= 0.12 window on every row, one k grid
    # a batch, and both sections build for a closed model inside the window
    with pytest.raises(CosmologyInputError, match='0.12'):
        Cosmology(engine='native', device='cpu', A_s=2.1e-9, Omega_k=torch.tensor([0.0, -0.13])).get_harmonic()
    mixed = Cosmology(engine='native', device='cpu', A_s=2.1e-9, Omega_k=torch.tensor([0.0, -0.05]))
    with pytest.raises(NotImplementedError, match='different ones'):
        mixed.get_harmonic().unlensed_cl(ellmax=100)
    closed = Cosmology(engine='native', device='cpu', A_s=2.1e-9, Omega_k=-0.05)
    assert callable(closed.get_harmonic().lensed_cl)
    assert callable(closed.get_perturbations().table)
