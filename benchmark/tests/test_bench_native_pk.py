"""The native_pk cell's plain reference (benchmark/reference/native_pk.py)
against the port's CPU path at a tiny size, its float32 control, its
independence from the port, and the cell's four metrics on a hand-made
layers table.

Run from the checkout's root: ``python -m pytest benchmark/tests -q``."""

import functools
import json
import os
import subprocess
import sys

import numpy as np

from benchmark import compare, harness, traffic
from benchmark.metrics import graph_capture_ms, perturbations_in_call_ms, recombination_in_call_ms, rk4_step_us

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@functools.lru_cache(maxsize=None)
def config():
    """The configuration at a tiny size: 6 k to 0.9 h/Mpc, the native CPU
    tests' step budget."""
    with open(os.path.join(ROOT, 'benchmark', 'configs', 'native_pk.json')) as f:
        return dict(json.load(f), nk_pk=6, n_steps=[2048, 768, 2048])


@functools.lru_cache(maxsize=None)
def params():
    """Two rows of the box, the second with a light neutrino, whose waves
    the streaming phase leaves unresolved at high k."""
    rows = traffic.draw_pool(config()['params'], 2, 1, 2 ** 31 + 29)[0]
    rows['m_ncdm'][1] = 1e-3
    return rows


@functools.lru_cache(maxsize=None)
def reference(dtype=np.float64):
    return harness.Cell.module('reference', 'native_pk').compute(params(), config(), dtype=dtype)


def test_reference_agrees_with_port():
    entry = harness.Cell.module('entries', 'native_pk').build(config(), 'cpu')
    got = {key: value.numpy() for key, value in entry.call(harness.to_device(params(), 'cpu')).items()}
    checks = compare.compare(got, reference(), config()['outputs'])
    assert compare.correct(checks), checks


def test_float32_control_fails_every_limit():
    checks = compare.compare(reference(np.float32), reference(), config()['outputs'])
    assert all(np.isfinite(value) and value > limit for value, limit in checks.values()), checks


def test_reference_imports_nothing_of_the_port():
    code = ('import sys; sys.path.insert(0, %r)\n'
            'import benchmark.reference.native_pk\n'
            'top = {m.split(".")[0] for m in sys.modules}\n'
            'print(sorted(top & {"jax", "jaxlib", "cosmoprimo_tpu", "cosmoprimo_tpu_torch"}))' % ROOT)
    out = subprocess.run([sys.executable, '-c', code], capture_output=True, text=True, check=True).stdout
    assert out.strip() == '[]'


def layers_record():
    """A traced run's record with a hand-made layers table of 2 profiled
    calls: the spans' device and idle ms per call, the counters' change."""
    def row(device_ms, idle_ms):
        return {'device_ms': device_ms, 'device_self_ms': 0.0, 'idle_ms': idle_ms, 'idle_self_ms': 0.0,
                'launches': 0.0, 'dtoh': 0.0}

    rows = {'cosmoprimo.thermodynamics': row(3000.0, 500.0), 'cosmoprimo.perturbations': row(9000.0, 1000.0),
            'cosmoprimo.perturbations.phase_a': row(6000.0, 100.0),
            'cosmoprimo.perturbations.phase_b': row(1680.0, 50.0)}
    counters = {'step_loop.steps': {('recombination', 256, 32): 2 * 6144, ('phase_a', 65536, 32): 2 * 2560,
                                    ('phase_b', 65536, 32): 2 * 1280},
                'step_loop.capture_s': 1.5}
    return {'layers': {'calls': 2, 'wall_ms': 13000.0, 'spans_per_call': 12.0, 'rows': rows, 'counters': counters}}


def test_the_cell_metrics_read_a_layers_table():
    record = layers_record()
    assert recombination_in_call_ms.read(record) == 3500.0
    assert perturbations_in_call_ms.read(record) == 10000.0
    assert rk4_step_us.read(record) == 1e3 * (6000.0 + 1680.0) * 2 / (2 * 3840)
    assert graph_capture_ms.read(record) == 750.0


def test_the_cell_metrics_read_nothing_without_the_spans():
    modules = (recombination_in_call_ms, perturbations_in_call_ms, rk4_step_us, graph_capture_ms)
    for record in ({'layers': None}, {}):              # an untraced run, a trace that lost records
        assert all(module.read(record) is None for module in modules)
    # a program from before the solver's spans and counters
    record = layers_record()
    record['layers']['rows'] = {'cosmoprimo.params': record['layers']['rows']['cosmoprimo.thermodynamics']}
    record['layers']['counters'] = {'fftlog.launches': 0}
    assert all(module.read(record) is None for module in modules)
