"""The native solver's spans and counters (cosmoprimo_tpu_torch/tracing.py,
ops/step_loop.py) on the CPU: each loop counts its steps under its name,
lanes and chunk, with no replay or capture on the eager path, and the
spans nest as named inside a profiled session of the program. The card's
side (replays, captures, spans that close after their kernels) is in
tests/test_torch_kernels.py."""

import copy

import numpy as np
import torch

from cosmoprimo_tpu_torch import Cosmology, tracing
from cosmoprimo_tpu_torch.boltzmann import compute_thermodynamics, thermodynamics
from cosmoprimo_tpu_torch.boltzmann.perturbations import integrate_perturbations, linear_pk

N_STEPS = (64, 32, 256)


def native():
    """A native cosmology, its solver's parameters and two k [h/Mpc]."""
    cosmo = Cosmology(engine='native', device='cpu')
    return cosmo, cosmo.engine._perturbation_params(), torch.from_numpy(np.array([0.01, 0.1]))


def change(before, name):
    return {key: n - before[name].get(key, 0) for key, n in tracing.counters[name].items()
            if n != before[name].get(key, 0)}


def test_the_loops_count_their_steps_on_the_cpu():
    cosmo, params, k = native()
    before = copy.deepcopy(tracing.counters)
    th = compute_thermodynamics(cosmo['omega_b'], cosmo['h'], cosmo['T_cmb'], cosmo.get_background().efunc,
                                tau_reio=cosmo['tau_reio'], N_eff=cosmo['N_eff'])
    linear_pk(params, th, k, [0.0], n_steps=N_STEPS)
    scan = thermodynamics.N_GRID - 1 - thermodynamics.saha_steps()
    assert change(before, 'step_loop.steps') == {('recombination', 1, 32): scan,
                                                 ('phase_a', 2, 32): N_STEPS[0], ('phase_b', 2, 32): N_STEPS[1]}
    assert change(before, 'step_loop.replays') == {} and change(before, 'step_loop.captures') == {}
    assert tracing.counters['step_loop.capture_s'] == before['step_loop.capture_s']


def spans(prof):
    return [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
            if e.name().startswith('cosmoprimo.')]


def parent(events, name):
    """The names of the spans directly around each span ``name``."""
    out = set()
    for n, start, end in events:
        if n != name:
            continue
        around = [e for e in events if e[1] <= start and end <= e[2] and (e[1], e[2]) != (start, end)]
        out.add(min(around, key=lambda e: e[2] - e[1])[0] if around else None)
    return out


def test_the_solver_spans_nest_as_named(monkeypatch):
    cosmo, params, k = native()
    th = compute_thermodynamics(cosmo['omega_b'], cosmo['h'], cosmo['T_cmb'], cosmo.get_background().efunc,
                                tau_reio=cosmo['tau_reio'], N_eff=cosmo['N_eff'])
    # the recombination scan itself is left out of the session (3008 steps of CPU ops): its span is the call's
    monkeypatch.setattr(thermodynamics, '_compute_thermodynamics', lambda *args: th)
    with tracing.profile() as prof:
        assert compute_thermodynamics(cosmo['omega_b'], cosmo['h'], cosmo['T_cmb'], None) is th
        integrate_perturbations(params, th, k[None] * params['h'][:, None], [0.0, 1.0], n_steps=N_STEPS)
    events = spans(prof)
    names = [name for name, _, _ in events]
    for name in ('cosmoprimo.thermodynamics', 'cosmoprimo.perturbations', 'cosmoprimo.perturbations.setup',
                 'cosmoprimo.perturbations.phase_a', 'cosmoprimo.perturbations.phase_b'):
        assert names.count(name) == 1, name
    assert parent(events, 'cosmoprimo.thermodynamics') == {None}
    assert parent(events, 'cosmoprimo.perturbations') == {None}
    for name in ('setup', 'phase_a', 'phase_b'):
        assert parent(events, 'cosmoprimo.perturbations.' + name) == {'cosmoprimo.perturbations'}, name
    # outside a session the synced span is the shared no-op too
    assert tracing.span('cosmoprimo.perturbations.phase_a', sync=True) is tracing.NOOP
