"""The harness: one run of one cell.

Everything that belongs to one cell is found by name. ``BENCHMARK.json``
(at the checkout's root) names the cell's configuration and traffic mix, and
the metrics; then

- ``configs/<config>.json``: the configuration as it is run, with the
  parameter box, and the outputs compared with their limits;
- ``entries/<config>.py``: ``build(config, device)``, how one call is made
  from the program's public API (and its layers' calls, for the trace);
- ``reference/<config>.py``: ``compute(params, config, dtype)``, the plain
  reference;
- ``traffic/<traffic>.json``: the batch, the pool and the check's sample,
  read by :mod:`traffic`;
- ``metrics/<metric>.py``: ``read(record)``, one metric from what the run
  recorded, or None where there is nothing to read.

A run: set-up (the program's import, the entry, the pool on the card, two
warm-up calls), a closed loop for ``seconds`` (one caller, each call ending
in a synchronize), with ``trace`` calls of the same entry and pool
profiled in one session (:func:`profile`) and the layers' calls, then the
reference on the sampled answers, and one JSON line.
"""

import argparse
import copy
import gc
import importlib
import json
import os
import sys
import time

import numpy as np

from . import compare, guard, layers, tracing, traffic

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
PROFILED_CALLS, PROFILED_SECONDS = 20, 10.0      # a traced run profiles at most 20 calls, as many as fit 10 s


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Card:
    """The CUDA card: synchronisation, peak memory, CUDA-event time."""

    def __init__(self):
        import torch
        self.torch = torch
        self.device = torch.device('cuda')

    def sync(self):
        self.torch.cuda.synchronize()

    def reset_peak(self):
        self.torch.cuda.reset_peak_memory_stats()

    def peak_bytes(self):
        return int(self.torch.cuda.max_memory_allocated())

    def elapsed_ms(self, fn, reps):
        start, end = (self.torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        self.torch.cuda.synchronize()
        return start.elapsed_time(end)

    def describe(self):
        return {'platform': 'gpu', 'kind': self.torch.cuda.get_device_name(0), 'count': 1}


class Host:
    """The CPU in the card's place: for the CPU tests of the harness only;
    it measures no device."""

    device = 'cpu'

    def sync(self):
        pass

    def reset_peak(self):
        pass

    def peak_bytes(self):
        return 0

    def elapsed_ms(self, fn, reps):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3

    def describe(self):
        return {'platform': 'cpu', 'kind': 'cpu', 'count': 1}


class Cell:
    """A cell's files, found by its name in ``BENCHMARK.json``."""

    def __init__(self, name):
        self.root = os.path.dirname(BENCH_DIR)
        self.spec = load_json(os.path.join(self.root, 'BENCHMARK.json'))
        cells = {w['name']: w for w in self.spec['workloads']}
        if name not in cells:
            raise SystemExit(f'benchmark: no workload {name!r} in BENCHMARK.json')
        self.name, self.workload = name, cells[name]
        config = {c['name']: c for c in self.spec['configs']}[self.workload['config']]
        self.config_name = config['name']
        self.config = load_json(os.path.join(self.root, config['file']))
        self.traffic = load_json(os.path.join(BENCH_DIR, 'traffic', self.workload['traffic'] + '.json'))

    @staticmethod
    def module(kind, name):
        """``<kind>/<name>.py`` of the benchmark, by name."""
        return importlib.import_module(f'{__package__}.{kind}.{name}')

    def metrics(self, trace):
        """The metric entries this cell reports: the end-to-end ones, or
        with ``trace`` the per-layer ones."""
        entries = self.spec['per_layer' if trace else 'end_to_end']
        if not trace:
            return [m for m in entries if self.name in m.get('workloads', [self.name])]
        reported = {m['name'] for m in self.metrics(False)}
        return [m for m in entries if (self.name in m['workloads'] if 'workloads' in m else m['moves'] in reported)]


def to_device(batch, device):
    import torch
    return {name: torch.from_numpy(values).to(device) for name, values in batch.items()}


def closed_loop(entry, pool_dev, plan, card, seconds=None, calls=None):
    """Calls of the closed loop, cycling through the pool, each ending in a
    synchronize, for ``seconds`` (or ``calls`` calls); the plan keeps its
    sample of answers. Returns the calls' walls (s) and the loop's time."""
    import torch
    walls = []
    start = now = time.perf_counter()
    call = 0
    while (now - start < seconds) if seconds is not None else (call < calls):
        t_call = time.perf_counter()
        p = call % len(pool_dev)
        out = entry.call(pool_dev[p])
        slot = plan.slot(call)
        if slot is not None:
            rows = plan.draw_rows()
            index = torch.from_numpy(rows).to(out[next(iter(out))].device)
            plan.keep(slot, call, p, rows, {name: value.index_select(0, index) for name, value in out.items()})
        card.sync()
        now = time.perf_counter()
        walls.append(now - t_call)
        call += 1
    return walls, now - start


def profiled_calls(walls):
    """The calls a traced run profiles: as many of the window's median call
    (``walls``, s) as fit PROFILED_SECONDS, at least 1 and at most
    PROFILED_CALLS."""
    return max(1, min(PROFILED_CALLS, int(PROFILED_SECONDS // float(np.median(walls)))))


def profile(call, ncalls, card):
    """Profile ``ncalls`` calls of ``call(i)`` in one session: the
    program's own where it has one (``layers.program_tracing``), its spans
    on. Returns {'trace': ``tracing.reduce``'s result, 'layers':
    ``layers.attribute``'s table with the program's counters' change over
    the calls under 'counters'}, each None where there is nothing to read,
    and prints the table as the ``layers`` line. A trace that lost records
    is said so on standard error and gives nothing."""
    program = layers.program_tracing()
    before = copy.deepcopy(program.counters) if program is not None else None
    got = tracing.profile_calls(call, ncalls, card, program.profile() if program is not None else None, layers.PREFIX)
    if got['lost']:
        print(f'trace: {got["lost"]} of the {got["launches"]} eager kernel launches in the profiled calls have no '
              'device record: the trace lost records, and the metrics that read it are left out',
              file=sys.stderr, flush=True)
        return {'trace': None, 'layers': None}
    out = {'trace': tracing.reduce(got['host'], got['device']), 'layers': None}
    if program is not None:
        table = dict(layers.attribute(got['spans'], got['device'], got['calls']), linked=got['linked'])
        out['layers'] = layers.report(table, before, copy.deepcopy(program.counters))
    return out


def sampled(pool, plan, names):
    """The sampled rows' parameters and answers (numpy), in the plan's order."""
    samples = plan.samples()
    params = {name: np.concatenate([pool[p][name][rows] for _, p, rows, _ in samples]) for name in names}
    got = {name: np.concatenate([answers[name].cpu().numpy() for _, _, _, answers in samples])
           for name in samples[0][3]}
    return params, got


def run(cell, seed, seconds, trace, card, t0):
    """One run of ``cell`` from the set-up's start ``t0`` (perf_counter);
    returns the result, its checks under the last key and the window's call
    walls (s) under ``walls_s``, which :func:`main` logs and takes out."""
    import torch
    config, plan_spec = cell.config, cell.traffic
    entry = cell.module('entries', cell.config_name).build(config, card.device)
    batch = int(plan_spec['batch'])
    pool = traffic.draw_pool(config['params'], batch, int(plan_spec['pool']), seed)
    pool_dev = [to_device(b, card.device) for b in pool]
    # warm-up: two calls of the window's own loop, the sample's gather included
    closed_loop(entry, pool_dev, traffic.SamplePlan(seed, 2, plan_spec['check_rows'], batch), card, calls=2)
    guard.check('after set-up')
    setup_peak = card.peak_bytes()
    plan = traffic.SamplePlan(seed, plan_spec['check_calls'], plan_spec['check_rows'], batch)

    card.reset_peak()
    setup_s = time.perf_counter() - t0
    walls, window_s = closed_loop(entry, pool_dev, plan, card, seconds=seconds)
    window_peak = card.peak_bytes()
    guard.check('after the window')
    # the card memory one call needs: one more call, entered with no garbage
    # that Python's collector has yet to free (within the window, reference
    # cycles that hold card tensors are freed when the collector runs, and
    # the window's peak holds them too)
    gc.collect()
    card.reset_peak()
    entry.call(pool_dev[0])
    card.sync()
    call_peak = card.peak_bytes()

    record = {'cell': cell.name, 'batch': batch, 'calls': len(walls), 'window_s': window_s, 'walls_s': walls,
              'setup_s': setup_s, 'window_peak_bytes': window_peak, 'call_peak_bytes': call_peak,
              'device': card.describe(),
              'trace': None, 'layers': None, 'spans': {}, 'counters': {}}
    if trace:
        record.update(profile(lambda i: entry.call(pool_dev[i % len(pool_dev)]), profiled_calls(walls), card))
        record['spans'] = {name: tracing.span_ms(fn, card) for name, fn in entry.spans(pool_dev[0]).items()}
        record['counters'] = entry.counters(pool_dev[0])
    params, got = sampled(pool, plan, config['params'])
    del entry, pool_dev, plan
    if isinstance(card, Card):
        torch.cuda.empty_cache()

    # the reference, after the window, on the sampled answers
    ref = cell.module('reference', cell.config_name).compute(params, config)
    checks = compare.compare(got, ref, config['outputs'])
    finite = np.ones(len(params[next(iter(params))]), bool)
    for value in got.values():
        finite &= np.isfinite(value.reshape(value.shape[0], -1)).all(axis=1)

    metrics = {}
    for spec in cell.metrics(trace):
        value = cell.module('metrics', spec['name']).read(record)
        if value is not None:
            metrics[spec['name']] = {'value': value, 'unit': spec['unit']}
        elif not trace:
            raise SystemExit(f'benchmark: end-to-end metric {spec["name"]} read nothing')
    device = dict(card.describe(), memory_peak_bytes=max(setup_peak, window_peak, call_peak))
    result = {'walls_s': walls, 'correct': compare.correct(checks), 'attempted': len(walls) * batch,
              'failed': int((~finite).sum()),      # sampled cosmologies with an answer that is not a number
              'metrics': metrics, 'device': device}
    if record['trace']:
        device.update(busy_s=record['trace']['busy_s'], window_s=record['trace']['window_s'])
        result['breakdown'] = record['trace']['breakdown']
    result['checks'] = {name: {'value': value, 'limit': limit} for name, (value, limit) in checks.items()}
    return result


def parse(argv):
    parser = argparse.ArgumentParser(description='Run one cell of the benchmark once.')
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def main(argv, t0, card=None):
    """Run the cell and print its result as the last line of standard
    output, its checks as the last lines of standard error. Without a
    ``card``, the run needs the CUDA cards its cell asks for."""
    args = parse(argv)
    cell = Cell(args.workload)
    if card is None:
        import torch
        chips = int(cell.workload['chips'])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f'benchmark: {args.workload} needs {chips} CUDA device(s); found '
                  f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}', file=sys.stderr)
            return 2
        card = Card()
    result = run(cell, args.seed, args.seconds, bool(args.trace), card, t0)
    guard.check('before the result')
    walls = result.pop('walls_s')
    print('call ms (min, q1, median, q3, p95, max): '
          + ', '.join(f'{w:.3f}' for w in np.quantile(walls, [0.0, 0.25, 0.5, 0.75, 0.95, 1.0]) * 1e3)
          + f'; the slowest is call {int(np.argmax(walls))} of {len(walls)}', file=sys.stderr)
    for name, check in result['checks'].items():
        print(f'check {name}: {check["value"]!r} (limit {check["limit"]!r})', file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
