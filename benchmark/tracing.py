"""What the traced run reads: one profiled session over whole calls of the
window's loop, read in one pass over the profiler's records.

:func:`profile_calls` profiles the calls in the session it is given (the
program's own, its spans on, where the program has one) or else a bare
``torch.profiler``, and :func:`read` takes the records once, into the
host's intervals on the calling thread, the program's spans, the calls and
the device's operations as arrays. From them :func:`reduce` gives the
device's busy time, its idle gaps labelled by what the host was doing, the
device operations that took the most time and the kernel launches, and
``layers.attribute`` the program's layers. An eager kernel launch of the
CUDA runtime in the calls with no device record means the trace lost
records. Launches are checked one by one only where they are eager: a CUDA
graph's replay has no runtime record per kernel (none of ``cudaGraphLaunch``
either, on the card measured), so records lost from a replay are not seen.

The reductions work on plain intervals in microseconds and on arrays of
the device's operations (:class:`Ops`), so that they are tested on the CPU
with intervals made by hand, and cost a few array passes for a call of
10^7 kernels. The CUDA-event time of a layer's call is :func:`span_ms`.
"""

import array
import time
from typing import NamedTuple

import numpy as np

CALL_SPAN = 'bench.call'
NAME_CHARS = 120              # a kernel's templated name is cut to this length in the breakdown
SPAN_SECONDS, SPAN_MAX_REPS = 0.5, 50
LAUNCH_CALLS = ('LaunchKernel', 'LaunchCooperativeKernel')     # the runtime's eager launches of a kernel
CAPTURE_QUERY = 'cudaStreamGetCaptureInfo'


class Ops(NamedTuple):
    """The device's operations: ``names`` the distinct names, and per
    operation ``index`` into them, ``start`` and ``end`` (us), and
    ``launch``, the host time of its launch (us; nan where none was found)."""
    names: list
    index: np.ndarray
    start: np.ndarray
    end: np.ndarray
    launch: np.ndarray


def flags(names, test):
    """A boolean per distinct name."""
    return np.array([bool(test(name)) for name in names], bool)


def merged(start, end):
    """The union of the intervals [start, end] as sorted disjoint (starts, ends)."""
    if not len(start):
        return start, end
    order = np.argsort(start, kind='stable')
    start, reach = start[order], np.maximum.accumulate(end[order])
    first = np.flatnonzero(np.r_[True, start[1:] > reach[:-1]])
    return start[first], reach[np.r_[first[1:] - 1, len(start) - 1]]


def gaps(busy_start, busy_end, lo, hi):
    """The stretches of [lo, hi] outside the busy intervals: (starts, ends)."""
    a, b = np.r_[lo, busy_end], np.r_[busy_start, hi]
    keep = b > a
    return a[keep], b[keep]


def innermost(host):
    """The host's innermost interval over time, from ``host`` (name, start,
    end) on one thread, whose intervals nest: (cuts, labels), label j (a
    name or None) holding from cuts[j], each interval's ends included."""
    cuts, labels, stack = [-np.inf], [None], []

    def cut(t, label):
        t = max(t, cuts[-1])
        if t == cuts[-1]:
            labels[-1] = label
        else:
            cuts.append(t)
            labels.append(label)

    def close(until):
        while stack and stack[-1][2] < until:
            end = stack.pop()[2]
            cut(float(np.nextafter(end, np.inf)), stack[-1][0] if stack else None)

    for event in sorted(host, key=lambda e: (e[1], -e[2])):
        close(event[1])
        stack.append(event)
        cut(event[1], event[0])
    close(np.inf)
    return np.array(cuts), labels


def reduce(host, device, top=10):
    """Reduce a trace: ``host`` the host's (name, start_us, end_us) on the
    calling thread, the calls among them named CALL_SPAN; ``device`` the
    device's operations (:class:`Ops`). Returns the calls, the traced window
    and the device's busy time (s), the kernel launches, and the breakdown:
    the device operations that took the most time and the idle time by what
    the host was doing (the innermost host interval at each idle gap's
    middle), each [[name, seconds], ...]."""
    calls = [e for e in host if e[0] == CALL_SPAN]
    if not calls:
        raise ValueError('the trace holds no call')
    lo, hi = min(e[1] for e in calls), max(e[2] for e in calls)
    keep = ~flags(device.names, lambda name: name.startswith('bench.'))[device.index]
    index, start, end = device.index[keep], device.start[keep], device.end[keep]
    inside = (end > lo) & (start < hi)
    busy = merged(np.maximum(start[inside], lo), np.minimum(end[inside], hi))
    gap_start, gap_end = gaps(*busy, lo, hi)
    cuts, labels = innermost([e for e in host if e[0] != CALL_SPAN])
    at = np.searchsorted(cuts, (gap_start + gap_end) / 2.0, side='right') - 1
    idle = {}
    for j, seconds in enumerate(np.bincount(at, weights=gap_end - gap_start, minlength=len(labels)) / 1e6):
        if seconds > 0:
            label = labels[j] or 'python (between operations)'
            idle[label] = idle.get(label, 0.0) + float(seconds)
    ops_s = {}
    count = np.bincount(index, minlength=len(device.names))
    seconds_by_name = np.bincount(index, weights=end - start, minlength=len(device.names)) / 1e6
    for name, n, seconds in zip(device.names, count, seconds_by_name):
        if n:
            name = name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + '...'
            ops_s[name] = ops_s.get(name, 0.0) + float(seconds)
    kernels = ~flags(device.names, lambda name: name.startswith(('Memcpy', 'Memset', 'bench.')))
    return {
        'calls': len(calls),
        'window_s': (hi - lo) / 1e6,
        'busy_s': float(np.sum(busy[1] - busy[0])) / 1e6,
        'launches': int(kernels[device.index].sum()),
        'breakdown': {'device_ops': sorted(([n, s] for n, s in ops_s.items()), key=lambda x: -x[1])[:top],
                      'idle_gaps': sorted(([n, s] for n, s in idle.items()), key=lambda x: -x[1])[:top]},
    }


def read(events, prefix):
    """One pass over a finished session's records
    (``prof.profiler.kineto_results.events()``), the program's spans being
    the ranges whose name starts with ``prefix``. Returns a dict of:
    ``host``, the host's (name, start, end) on the thread of the calls, the
    program's spans left out; ``spans``, the program's; ``calls``, the
    calls' (start, end); ``device``, the device's operations (:class:`Ops`), each with the
    host time of its launch: the start of the host operation or the
    innermost range (a span) that it is linked to, else of the CUDA runtime
    call with its correlation id, else none; ``linked``, how many
    operations each way found its launch; ``launches`` and ``lost``, the
    runtime's eager kernel launches in the calls and those of them with no
    device record that no stream capture explains. Times in microseconds
    from the first call's start.

    A launch into a stream that is being captured into a CUDA graph runs
    nothing, so it has no device record: such a launch is not lost where
    the host asked for a stream's capture state (``cudaStreamGetCaptureInfo``,
    which a capture's start and each allocation during it call) after the
    last launch that has a device record and before it."""
    import torch
    from torch.autograd.profiler_util import _filter_name     # what torch.profiler's event list leaves out
    cuda = torch.autograd.DeviceType.CUDA
    ids = {}
    d_index, d_start, d_end, d_corr, d_link = (array.array('q') for _ in range(5))
    cpu = []
    for e in events:
        if e.device_type() == cuda:
            if e.is_user_annotation():
                continue
            name = e.name()
            i = ids.get(name)
            if i is None:
                i = ids[name] = len(ids)
            d_index.append(i)
            d_start.append(e.start_ns())
            d_end.append(e.end_ns())
            d_corr.append(e.correlation_id())
            d_link.append(e.linked_correlation_id())
        elif not e.is_hidden_event():
            cpu.append((e.name(), e.start_ns(), e.end_ns(), e.correlation_id(), e.linked_correlation_id(),
                        e.start_thread_id()))
    thread = next(t for name, _, _, _, link, t in cpu if name == CALL_SPAN and not link)
    base = min(s for name, s, _, _, link, t in cpu if name == CALL_SPAN and not link and t == thread)
    frontend = {corr: ((s - base) / 1e3, t) for name, s, _, corr, link, t in cpu if not (link or name.startswith('cu'))}
    host, spans, calls, runtime, launches, capture = [], [], [], {}, [], []
    for name, s, e, corr, link, t in cpu:
        s, e = (s - base) / 1e3, (e - base) / 1e3
        if link or name.startswith('cu'):         # a call of the CUDA runtime, on its op's thread
            runtime[corr] = s
            if frontend.get(link, (s, t))[1] != thread:
                continue
            if any(word in name for word in LAUNCH_CALLS):
                launches.append((s, corr))
        elif t != thread or _filter_name(name):
            continue
        if name.startswith(CAPTURE_QUERY):
            capture.append(s)
        if name.startswith(prefix):
            spans.append((name, s, e))
            continue
        host.append((name, s, e))
        if name == CALL_SPAN:
            calls.append((s, e))
    names = list(ids)
    program = flags(names, lambda name: name.startswith(('bench.', prefix)))
    index = np.frombuffer(d_index, np.int64)
    keep = ~program[index]
    corr, link = np.frombuffer(d_corr, np.int64)[keep], np.frombuffer(d_link, np.int64)[keep]
    on_thread = {c: s for c, (s, t) in frontend.items() if t == thread}
    by_host = np.array([on_thread.get(c, np.nan) for c in link.tolist()], np.float64)
    by_runtime = np.array([runtime.get(c, np.nan) for c in corr.tolist()], np.float64)
    launch = np.where(np.isnan(by_host), by_runtime, by_host)
    linked = {'host': int((~np.isnan(by_host)).sum()),
              'runtime': int((np.isnan(by_host) & ~np.isnan(by_runtime)).sum()),
              'none': int(np.isnan(launch).sum())}
    hi = max(end for _, end in calls)
    when, which = np.array([(s, c) for s, c in sorted(launches) if 0.0 <= s <= hi], np.float64).reshape(-1, 2).T
    ran = np.isin(which.astype(np.int64), corr)
    last_ran = np.searchsorted(when[ran], when, side='left') - 1        # the last launch before that ran
    last_query = np.searchsorted(np.sort(capture), when, side='left') - 1
    ran_at = np.r_[-np.inf, when[ran]][last_ran + 1]
    query_at = np.r_[-np.inf, np.sort(capture)][last_query + 1]
    us = (lambda ns: (np.frombuffer(ns, np.int64)[keep] - base) / 1e3)
    device = Ops(names, index[keep], us(d_start), us(d_end), launch)
    return {'host': host, 'spans': spans, 'calls': calls, 'device': device, 'linked': linked,
            'launches': len(when), 'lost': int((~ran & ~(query_at > ran_at)).sum())}


def profile_calls(call, ncalls, card, session, prefix):
    """Profile ``ncalls`` calls of ``call(i)``, each under CALL_SPAN and
    ending in a synchronize as the window's loop makes them, in ``session``
    (a profiler's context manager; None: a bare ``torch.profiler``);
    returns :func:`read` of its records."""
    from torch.profiler import ProfilerActivity, profile, record_function
    if session is None:
        session = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with session as prof:
        for i in range(ncalls):
            with record_function(CALL_SPAN):
                call(i)
                card.sync()
    return read(prof.profiler.kineto_results.events(), prefix)


def span_ms(fn, card):
    """Mean ms of one call of ``fn`` on the card's clock (CUDA events around
    a run of calls, after one warm-up), as many calls as fit SPAN_SECONDS,
    at least 3 and at most SPAN_MAX_REPS."""
    fn()
    card.sync()
    t0 = time.perf_counter()
    fn()
    card.sync()
    once = time.perf_counter() - t0
    reps = int(min(SPAN_MAX_REPS, max(3, SPAN_SECONDS / max(once, 1e-6))))
    return card.elapsed_ms(fn, reps) / reps
