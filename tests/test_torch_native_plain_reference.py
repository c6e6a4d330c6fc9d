"""The port's native Fourier sampling call (the 'native-base' recipe's
calculator over the DESI fiducial, benchmark/entries/native_pk.py) against
the benchmark's plain reference of the Einstein-Boltzmann solver
(benchmark/reference/native_pk.py), on the CPU, at the limits of
benchmark/configs/native_pk.json.

Three cosmologies, one with a massless neutrino, one at 0.6 eV and one
at 1e-3 eV, at nk_pk = 12 and the native tests' step budget (2048, 768,
2048). At that budget the light neutrino's waves turn by more than RK4's
bound in the streaming phase at high k, and both hold its fluid on its
quasi-static values there (3 of its 12 lanes; tests/test_torch_ncdm_pin.py
holds that row against a resolved integration). Measured on the CPU (each
row's largest |port - reference| over its largest P on the emulator's
422 x 30 grid; the scalars relative), massless, 0.6 eV, 1e-3 eV: pk_m
1.73e-12, 8.42e-10, 1.72e-09; pk_cb 1.73e-12, 1.03e-09, 1.72e-09; rs_drag
1.20e-14, 9.39e-14, 1.33e-15; z_drag 1.87e-14, 1.24e-14, 8.88e-16; z_star
1.66e-12, 6.13e-13, 1.61e-13.
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
from benchmark.reference import native_pk as reference  # noqa: E402

PARAMS = {'logA': [3.0, 3.1, 3.05], 'n_s': [0.96, 0.97, 0.965], 'h': [0.7, 0.65, 0.68],
          'omega_b': [0.022, 0.023, 0.0224], 'omega_cdm': [0.12, 0.11, 0.12], 'm_ncdm': [0.0, 0.6, 1e-3]}


def config():
    with open(os.path.join(ROOT, 'benchmark', 'configs', 'native_pk.json')) as f:
        return dict(json.load(f), nk_pk=12, n_steps=[2048, 768, 2048])


def test_native_calculator_against_plain_reference():
    cfg = config()
    params = {name: np.array(values) for name, values in PARAMS.items()}
    got = entry.build(cfg, 'cpu').call({name: torch.from_numpy(v) for name, v in params.items()})
    got = {name: value.numpy() for name, value in got.items()}
    ref = reference.compute(params, cfg)
    assert got['pk_m'].shape == ref['pk_m'].shape == (3, 422 * 30)
    checks = compare.compare(got, ref, cfg['outputs'])
    assert compare.correct(checks), checks
    # the massless row's P(k) of delta_m and delta_cb agree; at 0.6 eV the neutrino's share parts them
    assert compare.error(got['pk_m'][:1], got['pk_cb'][:1], axis=1) < 1e-12
    assert compare.error(ref['pk_m'][1:2], ref['pk_cb'][1:2], axis=1) > 1e-3
