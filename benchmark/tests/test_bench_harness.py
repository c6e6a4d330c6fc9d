"""The harness on the CPU: a cell, a configuration and a per-layer metric
added as files only are found and run; the last line has the contract's
keys; a run without a card fails; the import guard; the roofline count; the
trace's reduction; and the faults that ``correct`` has to catch.

A run on the CPU uses ``harness.Host`` in the card's place: it exists for
these tests only. Tests that need the card carry the ``cuda`` marker and
look for it inside the test."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from benchmark import guard, roofline, tracing, traffic

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
KEYS = ['correct', 'attempted', 'failed', 'metrics', 'device', 'checks']


@pytest.fixture(scope='module')
def checkout(tmp_path_factory):
    """A copy of BENCHMARK.json and benchmark/ with a tiny traffic mix and the
    two configurations' cells under it, as later changes add cells: files
    and entries only."""
    root = tmp_path_factory.mktemp('checkout')
    shutil.copytree(os.path.join(ROOT, 'benchmark'), root / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        spec = json.load(f)
    for config in ('eh98_pk_xi', 'desi_bao_template'):
        spec['workloads'].append({'name': config + '.tiny', 'config': config, 'traffic': 'tiny', 'chips': 1,
                                  'why': 'a test size'})
    (root / 'benchmark' / 'traffic' / 'tiny.json').write_text(json.dumps(
        {'why': 'a test size', 'batch': 4, 'pool': 2, 'check_calls': 2, 'check_rows': 3}))
    (root / 'BENCHMARK.json').write_text(json.dumps(spec))
    return root


def run(root, argv, patch='', timeout=300):
    """The harness in a fresh process at ``root``, on the CPU, after the
    code ``patch``; returns (rc, stdout, stderr)."""
    script = textwrap.dedent('''
        import sys, time
        t0 = time.perf_counter()
        sys.path.insert(0, {root!r})
        sys.path.append({program!r})
        from benchmark import harness
        {patch}
        sys.exit(harness.main({argv!r}, t0, card=harness.Host()))
    ''').format(root=str(root), program=ROOT, patch=patch, argv=argv)
    proc = subprocess.run([sys.executable, '-c', script], capture_output=True, text=True, timeout=timeout, cwd=root)
    return proc.returncode, proc.stdout, proc.stderr


def last_line(stdout):
    return json.loads(stdout.strip().splitlines()[-1])


def test_added_config_cell_and_metric_are_found(checkout, tmp_path):
    root = tmp_path / 'added'
    shutil.copytree(checkout, root)
    bench = root / 'benchmark'
    (bench / 'configs' / 'chi_only.json').write_text(json.dumps({
        'name': 'chi_only', 'params': {'omega_cdm': [0.11, 0.13], 'omega_b': [0.021, 0.023], 'h': [0.65, 0.7]},
        'z': [0.5, 1.0], 'outputs': {'chi': {'limit': 1e-10}}}))
    (bench / 'entries' / 'chi_only.py').write_text(textwrap.dedent('''
        import numpy as np
        import torch


        class Entry:
            def __init__(self, config, device):
                from cosmoprimo_tpu_torch import make_distance_pipeline
                self.fn, _ = make_distance_pipeline(zq=config['z'])

            def call(self, batch):
                return {'chi': self.fn(batch['omega_cdm'], batch['omega_b'], batch['h'])}

            def spans(self, batch):
                return {'distance': lambda: self.call(batch)}

            def counters(self, batch):
                return {}


        def build(config, device):
            return Entry(config, device)
    '''))
    (bench / 'reference' / 'chi_only.py').write_text(textwrap.dedent('''
        import numpy as np
        from . import common


        def compute(params, config, dtype=np.float64):
            background = common.Background(params['omega_cdm'], params['omega_b'], params['h'], dtype=dtype)
            return {'chi': background.comoving_radial_distance(np.asarray(config['z'], dtype))}
    '''))
    (bench / 'metrics' / 'distance_ms.py').write_text('def read(record):\n    return record["spans"].get("distance")\n')
    spec = json.loads((root / 'BENCHMARK.json').read_text())
    spec['configs'].append({'name': 'chi_only', 'source': 'a test', 'file': 'benchmark/configs/chi_only.json',
                            'reduced': [], 'why': 'a test'})
    spec['workloads'].append({'name': 'chi_only.tiny', 'config': 'chi_only', 'traffic': 'tiny', 'chips': 1,
                              'why': 'a test'})
    spec['per_layer'].append({'name': 'distance_ms', 'unit': 'ms', 'better': 'lower', 'source': 'program_span',
                              'layer': 'background', 'moves': 'cosmo_per_s', 'workloads': ['chi_only.tiny']})
    (root / 'BENCHMARK.json').write_text(json.dumps(spec))
    rc, out, err = run(root, ['--workload', 'chi_only.tiny', '--seed', '3000000019', '--seconds', '0.5',
                              '--trace', '1'])
    assert rc == 0, err
    result = last_line(out)
    assert result['correct'] is True
    assert result['metrics']['distance_ms']['unit'] == 'ms' and result['metrics']['distance_ms']['value'] > 0
    assert 'device_idle_pct' not in result['metrics']         # a metric with nothing to read is left out


@pytest.mark.parametrize('cell', ['eh98_pk_xi.tiny', 'desi_bao_template.tiny'])
def test_last_line_has_the_contract_keys(checkout, cell):
    rc, out, err = run(checkout, ['--workload', cell, '--seed', '2147483999', '--seconds', '0.5', '--trace', '0'])
    assert rc == 0, err
    result = last_line(out)
    assert list(result) == KEYS
    assert result['correct'] is True and result['failed'] == 0 and result['attempted'] > 0
    assert set(result['metrics']) == {'setup_s', 'cosmo_per_s', 'peak_mem_gb'}    # 0 on the CPU
    assert all(set(m) == {'value', 'unit'} for m in result['metrics'].values())
    assert set(result['device']) == {'platform', 'kind', 'count', 'memory_peak_bytes'}
    checks = err.strip().splitlines()[-len(result['checks']):]
    assert all(line.startswith('check ') for line in checks)


def test_the_seed_fixes_the_inputs_and_the_sample():
    box = {'a': [0.0, 1.0], 'b': [2.0, 3.0]}
    seed = 2 ** 31 + 12345
    first, again, other = (traffic.draw_pool(box, 5, 3, s) for s in (seed, seed, seed + 1))
    assert all(np.array_equal(x[k], y[k]) for x, y in zip(first, again) for k in box)
    assert not np.array_equal(first[0]['a'], other[0]['a'])
    assert not np.array_equal(first[0]['a'], first[1]['a'])          # the pool's batches differ

    def plan_of(s, calls=50):
        plan = traffic.SamplePlan(s, 4, 2, 5)
        for call in range(calls):
            slot = plan.slot(call)
            if slot is not None:
                plan.keep(slot, call, call % 3, plan.draw_rows(), None)
        return [(c, p, tuple(rows)) for c, p, rows, _ in plan.samples()]

    assert plan_of(seed) == plan_of(seed) != plan_of(seed + 1)
    assert len(plan_of(seed)) == 4 and len(plan_of(seed, calls=2)) == 2


def test_a_run_without_a_card_fails():
    proc = subprocess.run([sys.executable, os.path.join(ROOT, 'benchmark', 'run.py'), '--workload',
                           'eh98_pk_xi.b40000', '--seed', '1', '--seconds', '1', '--trace', '0'],
                          capture_output=True, text=True, timeout=300, cwd=ROOT,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=''))
    assert proc.returncode != 0
    assert proc.stdout.strip() == ''


def test_import_guard():
    assert guard.loaded({'jax.numpy': None, 'cosmoprimo_tpu_torch.fftlog': None, 'numpy': None}) == ['jax']
    assert guard.loaded({'cosmoprimo_tpu.fftlog': None, 'jaxlib': None, 'flax.linen': None}) == [
        'cosmoprimo_tpu', 'flax', 'jaxlib']
    assert guard.loaded({'cosmoprimo_tpu_torch': None, 'jaxtyping': None, 'flaxen': None}) == []


def test_a_run_that_loads_jax_prints_no_result(checkout):
    patch = 'import types; sys.modules["jax"] = types.ModuleType("jax")'
    rc, out, err = run(checkout, ['--workload', 'eh98_pk_xi.tiny', '--seed', '1', '--seconds', '0.2',
                                  '--trace', '0'], patch=patch)
    assert rc != 0 and out.strip() == ''
    assert 'jax' in err


HALF_BATCH = '''
import torch
entries = harness.Cell.module("entries", {config!r})
call = entries.Entry.call
def half(self, batch):
    n = next(iter(batch.values())).shape[0] // 2
    out = call(self, {{k: v[:n] for k, v in batch.items()}})
    return {{k: torch.cat([v, v]) for k, v in out.items()}}
entries.Entry.call = half
'''

ALTERED = '''
import cosmoprimo_tpu_torch.fftlog as fftlog
core = fftlog.fftlog_core_torch
fftlog.fftlog_core_torch = lambda *args: core(*args) * (1.0 + 1e-6)
'''


@pytest.mark.parametrize('fault', ['half_batch', 'altered'])
@pytest.mark.parametrize('config', ['eh98_pk_xi', 'desi_bao_template'])
def test_faults_are_not_correct(checkout, config, fault):
    patch = HALF_BATCH.format(config=config) if fault == 'half_batch' else ALTERED
    rc, out, err = run(checkout, ['--workload', config + '.tiny', '--seed', '31', '--seconds', '0.3',
                                  '--trace', '0'], patch=patch)
    assert rc == 0, err
    assert last_line(out)['correct'] is False


def ops_of(records):
    """The device's operations (tracing.Ops) from hand-made (name, start,
    end[, launch]) tuples, launch None where none was found."""
    ids = {}
    index = [ids.setdefault(r[0], len(ids)) for r in records]
    times = np.array([r[1:3] for r in records], np.float64).reshape(-1, 2)
    launch = np.array([np.nan if len(r) < 4 or r[3] is None else r[3] for r in records], np.float64)
    return tracing.Ops(list(ids), np.array(index, np.int64), times[:, 0], times[:, 1], launch)


def test_fftlog_bound_at_the_headline_shape():
    peaks = roofline.PEAKS['NVIDIA H100 80GB HBM3']
    ms, kind = roofline.fftlog_bound_ms(40000, 1024, 2048, 1, peaks)
    assert kind == 'bytes'
    assert round(ms, 4) == 0.1956


def test_trace_reduction():
    host = [('bench.call', 0.0, 100.0), ('aten::mul', 10.0, 30.0), ('cudaLaunchKernel', 12.0, 14.0),
            ('bench.call', 100.0, 200.0), ('cudaDeviceSynchronize', 150.0, 199.0)]
    device = [('kern_a', 20.0, 40.0), ('kern_b', 35.0, 50.0), ('Memcpy HtoD', 120.0, 130.0),
              ('kern_a', 160.0, 170.0), ('bench.call', 0.0, 200.0)]
    trace = tracing.reduce(host, ops_of(device))
    assert trace['calls'] == 2 and trace['launches'] == 3
    assert trace['window_s'] == pytest.approx(200e-6) and trace['busy_s'] == pytest.approx(50e-6)
    ops = dict(trace['breakdown']['device_ops'])
    assert ops['kern_a'] == pytest.approx(30e-6)
    idle = dict(trace['breakdown']['idle_gaps'])
    assert idle['aten::mul'] == pytest.approx(20e-6)                 # 0-20: the host in the multiply
    assert idle['python (between operations)'] == pytest.approx(100e-6)   # 50-120 and 130-160
    assert idle['cudaDeviceSynchronize'] == pytest.approx(30e-6)     # 170-200
    assert sum(idle.values()) == pytest.approx(150e-6)



class Record:
    """A profiler record as ``kineto_results.events()`` gives it, made by hand."""

    BASE = 1_790_000_000_000_000_000            # ns, as the profiler's clock reads

    def __init__(self, name, start_us, end_us, corr=0, link=0, thread=1, device=False, annotation=False):
        import torch
        self._name, self._corr, self._link, self._thread, self._annotation = name, corr, link, thread, annotation
        self._start, self._end = self.BASE + int(start_us * 1000), self.BASE + int(end_us * 1000)
        self._type = torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU

    def name(self):
        return self._name

    def device_type(self):
        return self._type

    def start_ns(self):
        return self._start

    def end_ns(self):
        return self._end

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._link

    def start_thread_id(self):
        return self._thread

    def is_user_annotation(self):
        return self._annotation

    def is_hidden_event(self):
        return False


HOST = [('bench.call', 0.0, 100.0), ('aten::mul', 10.0, 30.0), ('cudaLaunchKernel', 12.0, 14.0),
        ('cudaGraphLaunch', 52.0, 53.0), ('bench.call', 100.0, 200.0), ('cudaDeviceSynchronize', 150.0, 199.0)]
DEVICE = [('kern_a', 20.0, 40.0), ('kern_b', 35.0, 50.0), ('kern_g', 54.0, 56.0), ('Memcpy HtoD', 120.0, 130.0),
          ('kern_a', 160.0, 170.0)]


def session_records(lose=False):
    """HOST and DEVICE as a session's records, with what the one pass has
    to leave out: the device's copy of a call, a host operation on another
    thread, one that torch.profiler's event list drops, and a span of the
    program (which labels no idle gap), and a launch into a stream capture,
    which runs nothing. ``lose`` drops kern_b's record."""
    records = [Record('bench.call', 0.0, 100.0, corr=1), Record('aten::mul', 10.0, 30.0, corr=5),
               Record('cudaLaunchKernel', 12.0, 14.0, corr=101, link=5, thread=9999),    # on its op's thread
               Record('cudaLaunchKernel', 31.0, 32.0, corr=102, link=1),
               Record('cudaGraphLaunch', 52.0, 53.0, corr=108),            # outside any op: no link
               Record('kern_g', 54.0, 56.0, corr=108, device=True),
               Record('bench.call', 100.0, 200.0, corr=2), Record('cudaMemcpyAsync', 110.0, 111.0, corr=103, link=2),
               Record('cudaLaunchKernel', 140.0, 141.0, corr=104, link=2),
               Record('cudaStreamGetCaptureInfo_v2', 142.0, 142.5, corr=106, link=2),       # a capture starts:
               Record('cudaLaunchKernel', 143.0, 144.0, corr=107, link=2),                  # launched into it
               Record('cudaDeviceSynchronize', 150.0, 199.0, corr=105, link=2),
               Record('aten::add', 60.0, 90.0, corr=6, thread=2), Record('aten::is_leaf', 55.0, 95.0, corr=7),
               Record('cosmoprimo.layer', 5.0, 95.0, corr=8),
               Record('bench.call', 0.0, 200.0, corr=1, device=True, annotation=True),
               Record('kern_a', 20.0, 40.0, corr=101, link=5, device=True),
               Record('Memcpy HtoD', 120.0, 130.0, corr=103, link=2, device=True),
               Record('kern_a', 160.0, 170.0, corr=104, link=2, device=True)]
    if not lose:
        records.append(Record('kern_b', 35.0, 50.0, corr=102, link=1, device=True))
    return records


def test_one_pass_read_matches_the_reduction():
    """The one pass over a session's records gives the reduction the same
    host intervals and device operations as made by hand: the same busy
    time, launches and breakdown; and the program's span to the layers."""
    got = tracing.read(session_records(), 'cosmoprimo.')
    want = tracing.reduce(HOST, ops_of(DEVICE))
    trace = tracing.reduce(got['host'], got['device'])
    assert trace['calls'] == want['calls'] == 2 and trace['launches'] == want['launches'] == 4
    assert trace['window_s'] == pytest.approx(want['window_s']) and trace['busy_s'] == pytest.approx(want['busy_s'])
    for key in ('device_ops', 'idle_gaps'):
        assert [name for name, _ in trace['breakdown'][key]] == [name for name, _ in want['breakdown'][key]]
        assert [s for _, s in trace['breakdown'][key]] == pytest.approx([s for _, s in want['breakdown'][key]])
    assert got['spans'] == [('cosmoprimo.layer', 5.0, 95.0)] and got['calls'] == [(0.0, 100.0), (100.0, 200.0)]
    assert got['linked'] == {'host': 4, 'runtime': 1, 'none': 0}
    assert got['launches'] == 4 and got['lost'] == 0          # eager launches: the graph's is not checked


def test_a_trace_that_lost_records_says_so():
    got = tracing.read(session_records(lose=True), 'cosmoprimo.')
    assert got['launches'] == 4 and got['lost'] == 1


@pytest.mark.parametrize('call_s, calls', [(0.035, 20), (0.23, 20), (0.5, 20), (0.6, 16), (4.0, 2), (18.3, 1)])
def test_profiled_calls_follow_the_call_wall(call_s, calls):
    """A traced run profiles as many calls as fit PROFILED_SECONDS of the
    window's median call, at most 20: both cells' calls (eh98 ~35 ms, DESI
    ~230 ms) give 20, an 18 s call of the Boltzmann solver gives 1."""
    from benchmark import harness
    assert harness.profiled_calls([call_s * 0.9, call_s, call_s * 5.0]) == calls


def test_card_wide_metrics_for_an_added_cell(checkout, monkeypatch):
    """A cell added as files and a workload entry reports the card-wide
    metrics with no edit to an existing entry: peak_mem_gb, and traced
    device_idle_pct, launches_per_call and call_peak_gb."""
    from benchmark import harness
    monkeypatch.setattr(harness, 'BENCH_DIR', str(checkout / 'benchmark'))
    for name in ('eh98_pk_xi.tiny', 'desi_bao_template.tiny'):
        cell = harness.Cell(name)
        assert {'setup_s', 'cosmo_per_s', 'peak_mem_gb'} <= {m['name'] for m in cell.metrics(False)}
        assert {'device_idle_pct', 'launches_per_call', 'call_peak_gb'} <= {m['name'] for m in cell.metrics(True)}

@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    proc = subprocess.run([sys.executable, os.path.join(ROOT, 'benchmark', 'run.py'), '--workload',
                           'eh98_pk_xi.b40000', '--seed', '2147483711', '--seconds', '2', '--trace', '1'],
                          capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = last_line(proc.stdout)
    assert result['correct'] is True and result['device']['busy_s'] > 0
