"""The program's own spans and counters, read in the traced run.

The program opens a span (``cosmoprimo_tpu_torch.tracing.span``) at each
layer's boundary: a range named ``cosmoprimo.<layer>`` on the profiler's
host clock, recorded inside a profiled session of the program
(``tracing.profile``) and nowhere else, so the harness's own trace
(:mod:`benchmark.tracing`) reads as it would without them. Once a traced
run, at the first metric that asks, :func:`table` builds the cell's entry
again and profiles ``harness.PROFILED_CALLS`` calls of its loop in such a
session: the calls the user makes, with the program's spans inside them.

:func:`attribute` reduces that trace, on plain intervals so that it is
tested on the CPU: each device operation goes to the span that was the
innermost open one on the host when it was launched (the launch linked by
the profiler's correlation id), each stretch of device idle time to the
span the host was in. The table is printed to standard error as one line,
``layers: {...}``, with the program's counters after the profiled calls
and their change over them.

A program without ``cosmoprimo_tpu_torch.tracing`` (before it had spans)
reads nothing: :func:`table` and :func:`program_counters` return None, and
the metrics that read them are left out.
"""

import argparse
import bisect
import copy
import importlib
import importlib.util
import json
import sys

from . import harness, traffic
from .tracing import CALL_SPAN

PREFIX = 'cosmoprimo.'
OUTSIDE = "(outside the program's spans)"
FIELDS = ('device_ms', 'device_self_ms', 'idle_ms', 'idle_self_ms', 'launches', 'dtoh')

_tables = {}


def _segments(spans, lo, hi):
    """[lo, hi] cut where a span opens or closes: [(start, end, names of the
    open spans, outermost first)]."""
    bounds = sorted({lo, hi} | {t for _, s, e in spans for t in (s, e) if lo < t < hi})
    order = sorted(spans, key=lambda e: (e[1], -e[2]))
    segments, stack, i = [], [], 0
    for a, b in zip(bounds[:-1], bounds[1:]):
        while i < len(order) and order[i][1] <= a:
            stack.append(order[i])
            i += 1
        stack = [e for e in stack if e[2] > a]
        segments.append((a, b, tuple(e[0] for e in stack)))
    return segments


def attribute(spans, device, calls):
    """The layers of a trace, per profiled call: ``spans`` the program's
    (name, start, end) on the calling thread, which nest; ``device`` the
    device's operations (name, start, end, launch), ``launch`` the host time
    of its launch or None (then its start stands in); ``calls`` the calls'
    (start, end); times in microseconds. Returns {'calls', 'wall_ms',
    'spans_per_call', 'rows': {name: {field: value}}} with, for each span name and for
    OUTSIDE (no span open), the device ms of the operations launched under
    the span, inclusive of the spans inside it and self (the span
    innermost), the idle ms of the device while the host was in it,
    inclusive and self, and the kernel launches and device-to-host copies
    launched under it, inclusive. Over the rows, the self device ms and the
    self idle ms add up to the wall of the calls' window, plus the time
    during which two device operations overlapped."""
    lo, hi = min(s for s, _ in calls), max(e for _, e in calls)
    segments = _segments(spans, lo, hi)
    starts = [s for s, _, _ in segments]
    rows = {}

    def add(names, field, value, self_field=None):
        for name in (set(names) or {OUTSIDE}):
            rows.setdefault(name, dict.fromkeys(FIELDS, 0.0))[field] += value
        if self_field:
            rows.setdefault(names[-1] if names else OUTSIDE, dict.fromkeys(FIELDS, 0.0))[self_field] += value

    busy = []
    for name, start, end, launch in device:
        start, end = max(start, lo), min(end, hi)
        if end <= start:
            continue
        busy.append((start, end))
        t = launch if launch is not None and lo <= launch <= hi else start
        names = segments[max(bisect.bisect_right(starts, t) - 1, 0)][2]
        add(names, 'device_ms', (end - start) / 1e3, 'device_self_ms')
        if not name.startswith(('Memcpy', 'Memset')):
            add(names, 'launches', 1)
        if 'DtoH' in name:
            add(names, 'dtoh', 1)
    merged = []
    for start, end in sorted(busy):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    gaps = [(a[1], b[0]) for a, b in zip([[lo, lo]] + merged, merged + [[hi, hi]]) if b[0] > a[1]]
    j = 0
    for a, b in gaps:
        while segments[j][1] <= a:
            j += 1
        k = j
        while k < len(segments) and segments[k][0] < b:
            s, e, names = segments[k]
            add(names, 'idle_ms', (min(b, e) - max(a, s)) / 1e3, 'idle_self_ms')
            k += 1
    n = len(calls)
    return {'calls': n, 'wall_ms': (hi - lo) / 1e3 / n, 'spans_per_call': len(spans) / n,
            'rows': {name: {field: value / n for field, value in row.items()} for name, row in rows.items()}}


def collect(prof):
    """From a finished ``torch.profiler.profile``: the program's spans on
    the thread of the calls, the device's operations with the host time of
    their launch, the calls, and how many operations each way found its
    launch. The launch is the start of the host operation (or the innermost
    record function) that the operation is linked to, on the spans' own
    clock, else the start of the CUDA runtime call with its correlation id
    (timed by CUPTI), else None. Times in microseconds."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    thread = next(e.start_thread_id() for e in events if e.name() == CALL_SPAN and e.device_type() != cuda)
    spans, calls, device, runtime, host = [], [], [], {}, {}
    for e in events:
        name, start, end = e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3
        if e.device_type() == cuda:
            if not (e.is_user_annotation() or name.startswith(('bench.', PREFIX))):
                device.append((name, start, end, e.correlation_id(), e.linked_correlation_id()))
        elif e.linked_correlation_id() > 0:          # a call of the CUDA runtime
            runtime[e.correlation_id()] = start
        elif e.start_thread_id() == thread:
            host[e.correlation_id()] = start
            if name == CALL_SPAN:
                calls.append((start, end))
            elif name.startswith(PREFIX):
                spans.append((name, start, end))
    linked = {'host': 0, 'runtime': 0, 'none': 0}
    ops = []
    for name, start, end, corr, link in device:
        launch = host.get(link)
        way = 'host' if launch is not None else 'runtime' if runtime.get(corr) is not None else 'none'
        linked[way] += 1
        ops.append((name, start, end, launch if launch is not None else runtime.get(corr)))
    return spans, ops, calls, linked


def program_counters():
    """The program's counters (``cosmoprimo_tpu_torch.tracing.counters``),
    or None where the program has none."""
    if importlib.util.find_spec('cosmoprimo_tpu_torch.tracing') is None:
        return None
    return importlib.import_module('cosmoprimo_tpu_torch.tracing').counters


def _seed():
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument('--seed', type=int, default=0)
    return parser.parse_known_args(sys.argv[1:])[0].seed


def _profile(record):
    """Profile the cell's calls in a session of the program; returns
    (attribute's table, the counters after the calls, their change)."""
    tracing = importlib.import_module('cosmoprimo_tpu_torch.tracing')
    card = harness.Card() if record['device']['platform'] == 'gpu' else harness.Host()
    cell = harness.Cell(record['cell'])
    entry = cell.module('entries', cell.config_name).build(cell.config, card.device)
    pool = traffic.draw_pool(cell.config['params'], int(cell.traffic['batch']), int(cell.traffic['pool']), _seed())
    pool_dev = [harness.to_device(b, card.device) for b in pool]
    from torch.profiler import record_function
    for i in range(2):                 # warm-up, as the harness's set-up
        entry.call(pool_dev[i % len(pool_dev)])
        card.sync()
    before = copy.deepcopy(tracing.counters)
    with tracing.profile() as prof:
        for i in range(harness.PROFILED_CALLS):
            with record_function(CALL_SPAN):
                entry.call(pool_dev[i % len(pool_dev)])
                card.sync()
    after = copy.deepcopy(tracing.counters)
    del entry, pool_dev
    if isinstance(card, harness.Card):
        card.torch.cuda.empty_cache()
    spans, device, calls, linked = collect(prof)
    layers = attribute(spans, device, calls)
    layers['linked'] = linked
    change = {}
    for name, value in after.items():          # a count, or counts by shape
        old = before.get(name, {} if isinstance(value, dict) else 0)
        change[name] = ({shape: n - old.get(shape, 0) for shape, n in value.items() if n != old.get(shape, 0)}
                        if isinstance(value, dict) else value - old)
    return layers, after, change


def table(record):
    """The traced run's layers (:func:`attribute`, with the counters'
    change over the profiled calls under 'counters'), made once a run; None
    where the run is not traced or the program has no spans."""
    if record.get('trace') is None or program_counters() is None:
        return None
    key = id(record)
    if key not in _tables:
        layers, after, change = _profile(record)
        print('layers: ' + json.dumps(dict(layers, counters={'after_calls': _jsonable(after),
                                                             'calls': _jsonable(change)})), file=sys.stderr, flush=True)
        _tables[key] = dict(layers, counters=change)
    return _tables[key]


def _jsonable(counters):
    """The counters with the counts by shape keyed by 'rows,size,padded,nparallel'."""
    return {name: {','.join(map(str, shape)): n for shape, n in value.items()} if isinstance(value, dict) else value
            for name, value in counters.items()}


def in_call_ms(record, name):
    """The span ``name``'s device ms plus idle ms per profiled call,
    inclusive of the spans inside it, or None."""
    layers = table(record)
    row = layers and layers['rows'].get(name)
    return None if not row else row['device_ms'] + row['idle_ms']
