"""The plain references against the port's CPU path at a small batch, the
control that has to fail, and the references' independence from the port.

Run from the checkout's root: ``python -m pytest benchmark/tests -q``."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from benchmark import compare, harness, traffic

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIGS = ('eh98_pk_xi', 'desi_bao_template')


def load(name):
    with open(os.path.join(ROOT, 'benchmark', 'configs', name + '.json')) as f:
        return json.load(f)


def port_and_reference(name, rows, seed, dtype=np.float64):
    config = load(name)
    params = traffic.draw_pool(config['params'], rows, 1, seed)[0]
    entry = harness.Cell.module('entries', name).build(config, 'cpu')
    got = {key: value.numpy() for key, value in entry.call(harness.to_device(params, 'cpu')).items()}
    reference = harness.Cell.module('reference', name)
    return config, got, reference.compute(params, config), reference.compute(params, config, dtype=dtype)


@pytest.mark.parametrize('name', CONFIGS)
def test_reference_agrees_with_port(name):
    config, got, ref, _ = port_and_reference(name, 4, 2 ** 31 + 17)
    checks = compare.compare(got, ref, config['outputs'])
    assert compare.correct(checks), checks


@pytest.mark.parametrize('name', CONFIGS)
def test_float32_control_fails(name):
    config = load(name)
    params = traffic.draw_pool(config['params'], 4, 1, 11)[0]
    reference = harness.Cell.module('reference', name)
    checks = compare.compare(reference.compute(params, config, dtype=np.float32), reference.compute(params, config),
                             config['outputs'])
    assert not compare.correct(checks)
    # every number of the control reads above its limit
    assert all(value > limit for value, limit in checks.values()), checks


def test_references_import_nothing_of_the_port():
    code = ('import sys; sys.path.insert(0, %r)\n'
            'import benchmark.reference.eh98_pk_xi, benchmark.reference.desi_bao_template\n'
            'top = {m.split(".")[0] for m in sys.modules}\n'
            'print(sorted(top & {"torch", "jax", "cosmoprimo_tpu", "cosmoprimo_tpu_torch"}))' % ROOT)
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True, check=True).stdout
    assert out.strip() == '[]'


def test_desi_columns_are_one_spectrum():
    """The P(k) table of a callable interpolator ignores growth: every z
    column is the same spectrum, in the port and in the reference."""
    _, got, ref, _ = port_and_reference('desi_bao_template', 2, 5)
    for key in ('pk', 'pknow', 'xi', 'xi_smooth'):
        assert np.array_equal(ref[key][..., 0:1].repeat(ref[key].shape[-1], -1), ref[key])
        assert compare.error(got[key], got[key][..., :1].repeat(got[key].shape[-1], -1), axis=1) < 1e-13


def test_desi_growth_is_compared():
    """P(k, z) carries the growth factor at each DESI redshift: its columns
    differ, and an answer with the growth left out, or rescaled to 1 at the
    first redshift, reads not correct."""
    config, got, ref, _ = port_and_reference('desi_bao_template', 2, 7)
    assert compare.correct(compare.compare(got, ref, config['outputs']))
    ratio = ref['pk_z'][:, 500, :] / ref['pk'][:, 500, :]
    assert np.all(np.diff(ratio, axis=1) < 0)                  # D(z)^2 falls with z
    for wrong in (got['pk'], got['pk_z'] / ratio[:, None, :1]):
        checks = compare.compare(dict(got, pk_z=wrong), ref, config['outputs'])
        assert checks['pk_z'][0] > 1e3 * checks['pk_z'][1], checks['pk_z']
