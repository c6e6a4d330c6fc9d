"""The program's spans in the traced run (benchmark/layers.py) on the CPU:
the attribution on hand-made intervals, the harness's own trace untouched
by the spans, the new metrics with nothing to read, and a traced run of a
tiny cell that reads them."""

import json
import shutil

import pytest
import torch

from benchmark import harness, layers, tracing
from benchmark.tests.test_bench_harness import checkout, last_line, ops_of, run  # noqa: F401  (the fixture)

NEW = ('params_in_call_ms', 'background_in_call_ms', 'linear_pk_in_call_ms', 'bao_filter_in_call_ms',
       'bao_prepare_idle_ms', 'spline_build_in_call_ms', 'to_xi_in_call_ms', 'fftlog_kernel_roofline',
       'kernel_build_s')
SPAN_METRICS = NEW[:-1]


def test_attribute_splits_the_window():
    calls = [(0.0, 100.0), (100.0, 200.0)]
    spans = [('cosmoprimo.a', 5.0, 60.0), ('cosmoprimo.b', 10.0, 30.0), ('cosmoprimo.a', 110.0, 190.0)]
    device = [('kern_x', 20.0, 40.0, 12.0),              # launched in b (inside a)
              ('kern_y', 40.0, 70.0, 50.0),              # launched in a alone
              ('Memcpy DtoH', 80.0, 90.0, 75.0),         # launched outside the spans
              ('kern_z', 150.0, 160.0, None),            # no launch found: its start, in a
              ('kern_w', 190.0, 210.0, 185.0)]           # clipped to the window's end
    out = layers.attribute(spans, ops_of(device), calls)
    assert out['calls'] == 2 and out['wall_ms'] == pytest.approx(0.1)
    rows = {name: {k: v * 2 for k, v in row.items()} for name, row in out['rows'].items()}   # totals
    a, b, outside = rows['cosmoprimo.a'], rows['cosmoprimo.b'], rows[layers.OUTSIDE]
    assert b['device_ms'] == b['device_self_ms'] == pytest.approx(0.020)
    assert a['device_ms'] == pytest.approx(0.020 + 0.030 + 0.010 + 0.010)
    assert a['device_self_ms'] == pytest.approx(0.050)
    assert a['launches'] == 4 and b['launches'] == 1 and outside['launches'] == 0 and outside['dtoh'] == 1
    # idle: 0-20 (outside 0-5, a 5-10, b 10-20), 70-80 and 90-150 (outside 70-80, 90-110; a 110-150),
    # 160-190 (a)
    assert b['idle_self_ms'] == pytest.approx(0.010)
    assert a['idle_self_ms'] == pytest.approx(0.005 + 0.040 + 0.030)
    assert a['idle_ms'] == pytest.approx(a['idle_self_ms'] + b['idle_self_ms'])
    assert outside['idle_ms'] == outside['idle_self_ms'] == pytest.approx(0.005 + 0.010 + 0.020)
    total = sum(row['device_self_ms'] + row['idle_self_ms'] for row in out['rows'].values())
    assert total == pytest.approx(out['wall_ms'])


def test_the_harness_trace_takes_no_span(monkeypatch):
    """The one profiled session (harness.profile) has the program's
    spans on, and its reduction (device time, launches, the breakdown) sees
    the host's operations without them, as on a program without spans;
    the layers' table sees them."""
    from cosmoprimo_tpu_torch import make_pk_to_xi_pipeline_batched
    seen = []

    def spy(host, device, top=10):
        seen.extend(host)
        return reduce(host, device, top)

    reduce = tracing.reduce
    monkeypatch.setattr(tracing, 'reduce', spy)
    fn, _, _ = make_pk_to_xi_pipeline_batched(nk=128)
    args = [torch.full((3,), value, dtype=torch.float64) for value in (0.12, 0.0224, 0.675, 0.965, 3.04)]
    out = harness.profile(lambda i: fn(*args), 2, harness.Host())
    trace = out['trace']
    assert trace['calls'] == 2 and any(name.startswith('aten::') for name, _, _ in seen)
    assert not [name for name, _, _ in seen if name.startswith(layers.PREFIX)]
    assert not [name for name, _ in trace['breakdown']['idle_gaps'] if name.startswith(layers.PREFIX)]
    assert out['layers']['calls'] == 2 and 'cosmoprimo.pipeline.pk_to_xi' in out['layers']['rows']


@pytest.mark.parametrize('name', NEW)
def test_a_metric_with_nothing_to_read_is_none(name, monkeypatch):
    metric = harness.Cell.module('metrics', name)
    device = {'platform': 'gpu', 'kind': 'NVIDIA H100 80GB HBM3', 'count': 1}
    if name != 'kernel_build_s':
        assert metric.read({'trace': None, 'device': device}) is None                 # an untraced run
        empty = {'calls': 20, 'wall_ms': 1.0, 'rows': {layers.OUTSIDE: dict.fromkeys(layers.FIELDS, 0.5)},
                 'counters': {'fftlog.shapes': {}}}
        monkeypatch.setattr(layers, 'table', lambda record: empty)
        assert metric.read({'trace': {}, 'device': device}) is None                   # no such span
    monkeypatch.setattr(layers, 'program_counters', lambda: None)
    monkeypatch.setattr(layers, 'table', lambda record: None)
    assert metric.read({'trace': {}, 'device': device}) is None                       # a program without spans


COUNTED = '''
import atexit, json
from benchmark import traffic
made = {{'entry': 0, 'pool': 0}}
entries = harness.Cell.module('entries', {config!r})
build, draw_pool = entries.build, traffic.draw_pool
def counted_build(*args):
    made['entry'] += 1
    return build(*args)
def counted_pool(*args):
    made['pool'] += 1
    return draw_pool(*args)
entries.build, traffic.draw_pool = counted_build, counted_pool
atexit.register(lambda: print('made: ' + json.dumps(made), file=sys.stderr))
'''


@pytest.mark.parametrize('config', ['eh98_pk_xi', 'desi_bao_template'])
def test_a_traced_tiny_cell_reads_the_layers(checkout, tmp_path, config):  # noqa: F811
    """One traced run of a tiny cell: the entry built and the pool drawn
    once, as many calls profiled as the window's median call gives, the
    layers read from those calls."""
    root = tmp_path / 'layers'
    shutil.copytree(checkout, root)
    spec = json.loads((root / 'BENCHMARK.json').read_text())
    cell = config + '.tiny'
    for metric in spec['per_layer']:
        if metric['name'] in SPAN_METRICS and f'{config}.b' in ' '.join(metric['workloads']):
            metric['workloads'].append(cell)
    (root / 'BENCHMARK.json').write_text(json.dumps(spec))
    rc, out, err = run(root, ['--workload', cell, '--seed', '2147483999', '--seconds', '0.3', '--trace', '1'],
                       patch=COUNTED.format(config=config))
    assert rc == 0, err
    made = next(line for line in err.splitlines() if line.startswith('made: '))
    assert json.loads(made[len('made: '):]) == {'entry': 1, 'pool': 1}
    result = last_line(out)
    metrics = result['metrics']
    for name in ('params_in_call_ms', 'background_in_call_ms', 'linear_pk_in_call_ms', 'spline_build_in_call_ms'):
        assert metrics[name]['value'] > 0 and metrics[name]['unit'] == 'ms'
    if config == 'desi_bao_template':
        assert metrics['bao_filter_in_call_ms']['value'] > metrics['bao_prepare_idle_ms']['value'] > 0
        assert metrics['to_xi_in_call_ms']['value'] > 0
    assert 'fftlog_kernel_roofline' not in metrics          # no kernel on the CPU
    line = next(line for line in err.splitlines() if line.startswith('layers: '))
    table = json.loads(line[len('layers: '):])
    walls = next(line for line in err.splitlines() if line.startswith('call ms (min, q1, median'))
    median_s = float(walls.split(': ')[1].split(', ')[2]) / 1e3
    assert table['calls'] == harness.profiled_calls([median_s]) > 1
    total = sum(row['device_self_ms'] + row['idle_self_ms'] for row in table['rows'].values())
    assert total == pytest.approx(table['wall_ms'], rel=1e-9)
    assert table['counters']['calls']['fftlog.launches'] == 0       # the CPU's engine calls no core
