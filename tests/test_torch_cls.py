"""The native CMB spectra end to end: the port's Harmonic and Perturbations
sections of engine='native' (cosmoprimo_tpu_torch/models/native.py, over
boltzmann/harmonic.py, lensing.py and tensor.py) against the JAX package's
sections, on the CPU.

Both packages run the DESI fiducial with r = 0.05 (the tensor modes on) at
ellmax_cl = 60 with lensing_margin = 40 (the spectra to l = 100) and
ellmax_tensor = 80, at the same reduced step budget, patched into both
packages' module constants: (N_STEPS_A, N_STEPS_B, M_TAB) = (2048, 768,
2048) and N_STEPS_T = 2048 (their defaults, 10240, 6144, 8192 and 8192, cost
minutes a run eagerly on the CPU). The JAX package's recombination and
source loops are jitted for speed (the same functions). The reference's phase-A end point is put on
the streaming switch (tests/native_reference.py).

Bars, and the deviations measured on the CPU:
- unlensed_cl, lensed_cl and lens_potential_cl, each spectrum 1e-8 of its
  max (measured <= 1.6e-11 on tt, ee, te, pp, tp, ep, unlensed bb 5.3e-15,
  lensed bb 6.8e-14);
- Perturbations.table() at k_output_values = (0.01, 0.05) h/Mpc (the budget
  steps_for_kmax gives, which the patch does not touch): every field 1e-9
  of its max (measured <= 5.1e-12).
"""

import types

import numpy as np
import pytest

jax = pytest.importorskip('jax')

from cosmoprimo_tpu.boltzmann import harmonic as JH, perturbations as JP, tensor as JT  # noqa: E402
from cosmoprimo_tpu.boltzmann.thermodynamics import ThermodynamicsResult as JaxResult  # noqa: E402
from cosmoprimo_tpu.fiducial import DESI as JaxDESI  # noqa: E402
from cosmoprimo_tpu_torch.boltzmann import perturbations as P, tensor as T  # noqa: E402
from cosmoprimo_tpu_torch.fiducial import DESI  # noqa: E402
from native_reference import exact_switch  # noqa: E402

CL_BAR = 1e-8
SERIES_BAR = 1e-9
EXTRA = {'lensing_margin': 40, 'ellmax_tensor': 80, 'k_output_values': (0.01, 0.05)}


def jitted(fn):
    """``fn(params, thermo, k, ...)`` of the JAX package, jitted, with the
    package's signature."""
    run = jax.jit(lambda p, t, k, n: {key: value for key, value in (fn(p, JaxResult(**t), k) if n is None else
                                                                    fn(p, JaxResult(**t), k, n_steps=n)).items()
                                       if key != 'names'}, static_argnums=3)

    def wrapper(params, thermo, k, z_nodes=None, n_steps=None):
        assert z_nodes is None
        out = run(params, dict(thermo.__dict__), k, None if n_steps is None else tuple(n_steps))
        out['names'] = JP.PERTURBATION_NAMES
        return out

    return wrapper


def with_jax_thermodynamics(cosmo):
    """``cosmo`` (the JAX package's) with its recombination traced once under
    jit in place of the eager Thermodynamics section (~1 min on the CPU,
    mostly its derived scalars, which the CMB path does not read)."""
    table = jax.jit(lambda: cosmo.clone().get_thermodynamics().table.__dict__)()
    cosmo.engine._sections['thermodynamics'] = types.SimpleNamespace(_th=JaxResult(**table))
    return cosmo


@pytest.fixture(scope='module')
def spectra():
    """Both packages' sections, under the reduced budget."""
    with pytest.MonkeyPatch.context() as mp:
        exact_switch(mp)
        for mod in (JP, P):
            mp.setattr(mod, 'N_STEPS_A', 2048)
            mp.setattr(mod, 'N_STEPS_B', 768)
            mp.setattr(mod, 'M_TAB', 2048)
        for mod in (JT, T):
            mp.setattr(mod, 'N_STEPS_T', 2048)
        mp.setattr(JH, 'compute_los_sources', jitted(JP.compute_los_sources))
        mp.setattr(JT, 'compute_tensor_sources', jitted(JT.compute_tensor_sources))
        mp.setattr(JP, 'compute_perturbation_series', jitted(JP.compute_perturbation_series))
        out = {}
        port = DESI(engine='native', device='cpu', ellmax_cl=60, extra_params=EXTRA).clone(r=0.05)
        ref = with_jax_thermodynamics(JaxDESI(engine='native', ellmax_cl=60, extra_params=EXTRA).clone(r=0.05))
        for name, cosmo in (('port', port), ('jax', ref)):
            hs = cosmo.get_harmonic()
            out[name] = {'unlensed': hs.unlensed_cl(), 'lensed': hs.lensed_cl(), 'potential': hs.lens_potential_cl(),
                         'table': cosmo.get_perturbations().table()}
        return out


@pytest.mark.parametrize('kind', ['unlensed', 'lensed', 'potential'])
def test_harmonic_section(spectra, kind):
    got, ref = spectra['port'][kind], spectra['jax'][kind]
    assert set(got) == set(ref)
    np.testing.assert_array_equal(got['ell'], ref['ell'])
    for name in ref:
        want = np.asarray(ref[name], dtype=np.float64)
        value = np.asarray(got[name])
        assert value.shape == want.shape, name
        assert np.max(np.abs(value - want)) <= CL_BAR * np.max(np.abs(want)), (kind, name)
    if kind != 'potential':
        assert np.all(np.asarray(got['bb'])[2:] > 0.0)


def test_perturbations_section(spectra):
    got, ref = spectra['port']['table'], spectra['jax']['table']
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert g.dtype.names == r.dtype.names
        for name in r.dtype.names:
            scale = max(np.max(np.abs(r[name])), 1e-300)
            assert np.max(np.abs(g[name] - r[name])) <= SERIES_BAR * scale, name
