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
  of its max (measured <= 5.1e-12);
- compute_cls and compute_tensor_cls with ``ells`` given, a cut multipole
  sample, on the sources and arguments the sections' calls recorded (so no
  source is integrated twice): each spectrum 1e-8 of its max, and
  'ells_sampled' echoing the sample;
- project_sources with t_parts = (1, 0, 1, 0) (no Doppler, no ISW) and
  dk_fine twice its default, and project_tensor_sources with that dk_fine,
  replayed on the recorded calls: each raw spectrum 1e-8 of its max
  (measured 1.2e-11 scalar, 7.5e-15 tensor; the options moved tt by 3.8e-2
  and 1.9e-5 of its max);
- the port's compute_los_sources, compute_tensor_sources and
  compute_perturbation_series with ``z_nodes`` every fifth node of the
  default template, on three of the recorded k modes, against the JAX
  package's recorded sources at those nodes and modes (the resampling onto
  tau is pointwise and the k lanes integrate apart): every row 1e-9 of its
  max (measured 1.7e-11, 1.1e-14 and 1.6e-12).
"""

import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')

from cosmoprimo_tpu.boltzmann import harmonic as JH, perturbations as JP, tensor as JT  # noqa: E402
from cosmoprimo_tpu.boltzmann.thermodynamics import ThermodynamicsResult as JaxResult  # noqa: E402
from cosmoprimo_tpu.fiducial import DESI as JaxDESI  # noqa: E402
from cosmoprimo_tpu_torch.boltzmann import bessel, harmonic as H, perturbations as P, tensor as T  # noqa: E402
from cosmoprimo_tpu_torch.fiducial import DESI  # noqa: E402
from cosmoprimo_tpu_torch.models import native as N  # noqa: E402
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


def recording(record, key, fn):
    """``fn``, keeping its last call's arguments and result in ``record[key]``."""
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        record[key] = (args, kwargs, out)
        return out

    return wrapper


def reduced_budget(mp):
    """Both packages' step budgets cut as the module docstring says."""
    for mod in (JP, P):
        mp.setattr(mod, 'N_STEPS_A', 2048)
        mp.setattr(mod, 'N_STEPS_B', 768)
        mp.setattr(mod, 'M_TAB', 2048)
    for mod in (JT, T):
        mp.setattr(mod, 'N_STEPS_T', 2048)


@pytest.fixture(scope='module')
def spectra():
    """Both packages' sections, under the reduced budget; 'record' keeps the
    arguments and results of their compute_cls, compute_tensor_cls, source,
    projection and perturbation-series calls."""
    with pytest.MonkeyPatch.context() as mp:
        exact_switch(mp)
        reduced_budget(mp)
        record = {}
        mp.setattr(JH, 'compute_los_sources', recording(record, 'jax sources', jitted(JP.compute_los_sources)))
        mp.setattr(JT, 'compute_tensor_sources', recording(record, 'jax tensor sources',
                                                           jitted(JT.compute_tensor_sources)))
        mp.setattr(JP, 'compute_perturbation_series', recording(record, 'jax series',
                                                                jitted(JP.compute_perturbation_series)))
        mp.setattr(N, 'compute_perturbation_series', recording(record, 'port series', N.compute_perturbation_series))
        for package, modules in (('jax', (JH, JT)), ('port', (H, T))):
            mp.setattr(modules[0], 'project_sources', recording(record, f'{package} project',
                                                                modules[0].project_sources))
            mp.setattr(modules[1], 'project_tensor_sources', recording(record, f'{package} tensor project',
                                                                       modules[1].project_tensor_sources))
        mp.setattr(JH, 'compute_cls', recording(record, 'jax cls', JH.compute_cls))
        mp.setattr(JT, 'compute_tensor_cls', recording(record, 'jax tensor cls', JT.compute_tensor_cls))
        mp.setattr(H, 'compute_los_sources', recording(record, 'port sources', H.compute_los_sources))
        mp.setattr(T, 'compute_tensor_sources', recording(record, 'port tensor sources', T.compute_tensor_sources))
        mp.setattr(N, 'compute_cls', recording(record, 'port cls', N.compute_cls))
        mp.setattr(N, 'compute_tensor_cls', recording(record, 'port tensor cls', N.compute_tensor_cls))
        out = {'record': record}
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


@pytest.mark.parametrize('kind', ['scalar', 'tensor'])
def test_cls_on_given_ells(spectra, kind):
    """compute_cls / compute_tensor_cls(..., ells=a cut sample) in both
    packages, each replaying its section's call on the sources recorded."""
    record = spectra['record']
    key, sources, fns = (('cls', 'sources', (JH.compute_cls, H.compute_cls)) if kind == 'scalar' else
                         ('tensor cls', 'tensor sources', (JT.compute_tensor_cls, T.compute_tensor_cls)))
    got = {}
    for package, fn in zip(('jax', 'port'), fns):
        args, kwargs, _ = record[f'{package} {key}']
        src = record[f'{package} {sources}'][2]
        ells = bessel.default_ells(kwargs['lmax'])[::3]
        ells = np.unique(np.concatenate([ells, [kwargs['lmax']]]))
        module = (JH if kind == 'scalar' else JT) if package == 'jax' else (H if kind == 'scalar' else T)
        source_fn = 'compute_los_sources' if kind == 'scalar' else 'compute_tensor_sources'
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(module, source_fn, lambda *a, **k: dict(src))
            got[package] = fn(*args, ells=ells, **kwargs)
        np.testing.assert_array_equal(np.asarray(got[package]['ells_sampled']), ells)
    names = ('tt', 'ee', 'te', 'pp', 'tp', 'ep') if kind == 'scalar' else ('tt', 'ee', 'bb', 'te')
    for name in names:
        want = np.asarray(got['jax'][name], dtype=np.float64)
        value = got['port'][name].numpy()[0]
        assert value.shape == want.shape, name
        assert np.max(np.abs(value - want)) <= CL_BAR * np.max(np.abs(want)), (kind, name)


@pytest.mark.parametrize('kind', ['scalar', 'tensor'])
def test_projection_options(spectra, kind):
    """project_sources(..., t_parts=(1, 0, 1, 0), dk_fine=2 DK_FINE) and
    project_tensor_sources(..., dk_fine=2 DK_FINE) in both packages, each
    replaying its section's call on the recorded sources and tables."""
    record = spectra['record']
    options = {'dk_fine': 2.0 * H.DK_FINE}
    if kind == 'scalar':
        options['t_parts'] = (1.0, 0.0, 1.0, 0.0)
        key, fns, names = 'project', (JH.project_sources, H.project_sources), ('tt', 'ee', 'te', 'pp', 'tp', 'ep')
    else:
        key, fns, names = 'tensor project', (JT.project_tensor_sources, T.project_tensor_sources), ('tt', 'ee', 'bb', 'te')
    got, default = {}, {}
    for package, fn in zip(('jax', 'port'), fns):
        args, kwargs, default[package] = record[f'{package} {key}']
        got[package] = fn(*args, **dict(kwargs, **options))
    for name in names:
        want = np.asarray(got['jax'][name], dtype=np.float64)
        value = got['port'][name].to(torch.float64).numpy()[0]
        assert value.shape == want.shape, name
        assert np.max(np.abs(value - want)) <= CL_BAR * np.max(np.abs(want)), (kind, name)
    # the options took effect: tt moved off the default call's by far more than the bar
    # (measured on the CPU: 2e-5 of its max by dk_fine alone, for the tensor modes)
    tt = default['port']['tt'].to(torch.float64).numpy()[0]
    assert np.max(np.abs(got['port']['tt'].to(torch.float64).numpy()[0] - tt)) > 100 * CL_BAR * np.max(np.abs(tt))


@pytest.mark.parametrize('kind', ['sources', 'tensor sources', 'series'])
def test_sources_on_given_z_nodes(spectra, kind):
    """The port's source functions with ``z_nodes`` every fifth node of the
    default template, on three of the recorded k modes (two for the series,
    which has two), against the JAX package's recorded default-template
    results at those nodes and modes."""
    record = spectra['record']
    args, kwargs, _ = record[f'port {kind}']
    ref = record[f'jax {kind}'][2]
    fn, z_nodes = {'sources': (P.compute_los_sources, P._los_z_nodes()),
                   'tensor sources': (T.compute_tensor_sources, T._tensor_z_nodes()),
                   'series': (P.compute_perturbation_series, P._los_z_nodes())}[kind]
    k = args[2]
    k_index = np.unique(np.linspace(0, k.shape[-1] - 1, 3).astype(int))
    z_index = np.arange(0, len(z_nodes), 5)
    with pytest.MonkeyPatch.context() as mp:
        reduced_budget(mp)
        got = fn(*args[:2], k[:, k_index], *args[3:], z_nodes=z_nodes[z_index], **kwargs)
    np.testing.assert_allclose(got['tau'].numpy()[0], np.asarray(ref['tau'])[z_index], rtol=1e-12)
    field = 'series' if kind == 'series' else 'src'
    want = np.asarray(ref[field])[k_index][..., z_index]
    value = got[field].numpy()[0]
    assert value.shape == want.shape
    for r in range(want.shape[1]):
        scale = max(np.max(np.abs(want[:, r])), 1e-300)
        assert np.max(np.abs(value[:, r] - want[:, r])) <= SERIES_BAR * scale, (kind, r)
