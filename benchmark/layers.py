"""The program's own spans and counters, read in the traced run.

The program opens a span (``cosmoprimo_tpu_torch.tracing.span``) at each
layer's boundary: a range named ``cosmoprimo.<layer>`` on the profiler's
host clock, recorded inside a profiled session of the program
(``tracing.profile``) and nowhere else. The traced run profiles its calls
once, in such a session where the program has one
(``benchmark.harness.profile``): the calls the user makes, with the
program's spans inside them, and the program's counters read around them.

:func:`attribute` reduces that trace, on plain intervals and arrays so that
it is tested on the CPU: each device operation goes to the span that was
the innermost open one on the host when it was launched (the launch linked
by the profiler's correlation id), each stretch of device idle time to the
span the host was in. :func:`report` prints the table to standard error as
one line, ``layers: {...}``, with the program's counters after the profiled
calls and their change over them, and :func:`table` gives it to the
metrics from the run's record.

A program without ``cosmoprimo_tpu_torch.tracing`` (before it had spans)
reads nothing: :func:`table` and :func:`program_counters` return None, and
the metrics that read them are left out.
"""

import importlib
import importlib.util
import json
import sys

import numpy as np

from .tracing import merged

PREFIX = 'cosmoprimo.'
OUTSIDE = "(outside the program's spans)"
FIELDS = ('device_ms', 'device_self_ms', 'idle_ms', 'idle_self_ms', 'launches', 'dtoh')


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
    device's operations (``benchmark.tracing.Ops``), whose launch is the
    host time of its launch or nan (then its start stands in); ``calls``
    the calls' (start, end); times in microseconds. Returns {'calls',
    'wall_ms', 'spans_per_call', 'rows': {name: {field: value}}} with, for
    each span name and for OUTSIDE (no span open), the device ms of the
    operations launched under the span, inclusive of the spans inside it and
    self (the span innermost), the idle ms of the device while the host was
    in it, inclusive and self, and the kernel launches and device-to-host
    copies launched under it, inclusive. Over the rows, the self device ms
    and the self idle ms add up to the wall of the calls' window, plus the
    time during which two device operations overlapped."""
    lo, hi = min(s for s, _ in calls), max(e for _, e in calls)
    segments = _segments(spans, lo, hi)
    bounds = np.array([s for s, _, _ in segments] + [hi])
    start, end = np.maximum(device.start, lo), np.minimum(device.end, hi)
    keep = end > start
    start, end, index, launch = start[keep], end[keep], device.index[keep], device.launch[keep]
    at = np.where((launch >= lo) & (launch <= hi), launch, start)           # nan compares false
    seg = np.maximum(np.searchsorted(bounds[:-1], at, side='right') - 1, 0)
    kernel = np.array([not name.startswith(('Memcpy', 'Memset')) for name in device.names], bool)
    dtoh = np.array(['DtoH' in name for name in device.names], bool)
    busy_start, busy_end = merged(start, end)
    idle = np.diff(bounds) - np.diff(_busy_before(bounds, busy_start, busy_end))
    idle[idle < 1e-9] = 0.0                   # rounding: the times are whole ns
    n_seg = len(segments)
    per_segment = {'device_ms': np.bincount(seg, weights=end - start, minlength=n_seg) / 1e3,
                   'launches': np.bincount(seg, weights=kernel[index], minlength=n_seg),
                   'dtoh': np.bincount(seg, weights=dtoh[index], minlength=n_seg),
                   'idle_ms': idle / 1e3}
    rows = {}
    for j, (_, _, names) in enumerate(segments):
        inner = names[-1] if names else OUTSIDE
        for field, values in per_segment.items():
            value = float(values[j])
            if not value:
                continue
            for name in (set(names) or {OUTSIDE}):
                rows.setdefault(name, dict.fromkeys(FIELDS, 0.0))[field] += value
            if field in ('device_ms', 'idle_ms'):
                rows.setdefault(inner, dict.fromkeys(FIELDS, 0.0))[field.replace('_ms', '_self_ms')] += value
    n = len(calls)
    return {'calls': n, 'wall_ms': (hi - lo) / 1e3 / n, 'spans_per_call': len(spans) / n,
            'rows': {name: {field: value / n for field, value in row.items()} for name, row in rows.items()}}


def _busy_before(t, start, end):
    """The busy time before each of the times ``t``, over the sorted
    disjoint intervals [start, end]."""
    if not len(start):
        return np.zeros(len(t))
    k = np.searchsorted(start, t, side='right') - 1          # the last interval that starts at or before t
    j = np.maximum(k, 0)
    done = np.cumsum(end - start) - (end - start)
    return np.where(k >= 0, done[j] + np.minimum(t, end[j]) - start[j], 0.0)


def program_tracing():
    """The program's ``tracing`` module, or None where the program has none."""
    if importlib.util.find_spec('cosmoprimo_tpu_torch.tracing') is None:
        return None
    return importlib.import_module('cosmoprimo_tpu_torch.tracing')


def program_counters():
    """The program's counters (``cosmoprimo_tpu_torch.tracing.counters``),
    or None where the program has none."""
    program = program_tracing()
    return None if program is None else program.counters


def report(layers, before, after):
    """Print the ``layers`` line of :func:`attribute`'s table with the
    program's counters ``after`` the profiled calls and their change since
    ``before``; returns the table with the change under 'counters'."""
    change = {}
    for name, value in after.items():          # a count, or counts by shape
        old = before.get(name, {} if isinstance(value, dict) else 0)
        change[name] = ({shape: n - old.get(shape, 0) for shape, n in value.items() if n != old.get(shape, 0)}
                        if isinstance(value, dict) else value - old)
    print('layers: ' + json.dumps(dict(layers, counters={'after_calls': _jsonable(after), 'calls': _jsonable(change)})),
          file=sys.stderr, flush=True)
    return dict(layers, counters=change)


def table(record):
    """The traced run's layers (:func:`attribute`, with the counters'
    change over the profiled calls under 'counters'), as the harness put
    them in the run's record; None where the run is not traced, its trace
    lost records or the program has no spans."""
    return record.get('layers')


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
