"""The streaming phase's pin of the massive-neutrino fluid
(perturbations._ncdm_unresolved) against a resolved integration, on the
CPU: a light neutrino (1e-3 eV) through the native Fourier sampling call
(benchmark/entries/native_pk.py, nk_pk = 12 to 0.9 h/Mpc).

At the native tests' budget (2048, 768, 2048) the streaming phase's steps
turn the fluid's fastest wave by up to 8.98 radians, past RK4's bound of
2 sqrt 2: unpinned, the integration grows without bound, and 3 of the 12
lanes are pinned. The same row unpinned at 8192 streaming steps turns it by
at most 0.84 radians a step. Measured on the CPU, pinned at 768 steps
against resolved at 8192: P(k) of delta_m 7.20e-07 and of delta_cb
7.20e-07 (the largest |difference| over the largest P, on the emulator's
422 x 30 grid), the size of the step budget's own share: pinned at 1280
steps the row reads 2.43e-07. Unpinned at 768 steps it is not finite. The
bar is 1e-5, a tenth of the benchmark's limit on these tables.
"""

import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import compare  # noqa: E402
from benchmark.entries import native_pk as entry  # noqa: E402
from cosmoprimo_tpu_torch.boltzmann import perturbations as P  # noqa: E402

ROW = {'logA': [3.05], 'n_s': [0.965], 'h': [0.68], 'omega_b': [0.0224], 'omega_cdm': [0.12], 'm_ncdm': [1e-3]}
BAR = 1e-5


def run(monkeypatch, n_steps_b, omega_d_max):
    """The row's P(k) tables at ``n_steps_b`` streaming steps, the fluid
    pinned past ``omega_d_max`` radians a step, and how many lanes were."""
    with open(os.path.join(ROOT, 'benchmark', 'configs', 'native_pk.json')) as f:
        cfg = dict(json.load(f), nk_pk=12, n_steps=[2048, n_steps_b, 2048])
    unresolved, pinned = P._ncdm_unresolved, []

    def counted(c, lanes, steps):
        flag = unresolved(c, lanes, steps)
        pinned.append(flag.reshape((-1,) + flag.shape[-2:]).any(0))
        return flag

    monkeypatch.setattr(P, 'NCDM_OMEGA_D_MAX', omega_d_max)
    monkeypatch.setattr(P, '_ncdm_unresolved', counted)
    got = entry.build(cfg, 'cpu').call({name: torch.tensor(v, dtype=torch.float64) for name, v in ROW.items()})
    monkeypatch.undo()
    return {name: got[name].numpy() for name in ('pk_m', 'pk_cb')}, int(torch.stack(pinned).any(0).sum())


def test_pinned_light_neutrino_against_a_resolved_integration(monkeypatch):
    pinned, n_pinned = run(monkeypatch, 768, P.NCDM_OMEGA_D_MAX)
    assert n_pinned > 0
    # unpinned at 8192 steps, and no step turns a wave by more than a radian
    resolved, n_over = run(monkeypatch, 8192, 1.0)
    assert n_over == 0
    for name in ('pk_m', 'pk_cb'):
        assert np.isfinite(pinned[name]).all() and np.isfinite(resolved[name]).all()
        assert compare.error(pinned[name], resolved[name], axis=1) <= BAR, name
    # without the pin, RK4 past its bound leaves the resolved answer by far more than the bar
    unpinned, n_pinned = run(monkeypatch, 768, np.inf)
    assert n_pinned == 0
    err = compare.error(unpinned['pk_m'], resolved['pk_m'], axis=1)
    assert not err <= 1e-2, err
