"""What the traced run reads: torch.profiler over whole calls of the
window's loop, reduced to the device's busy time, its idle gaps labelled by
what the host was doing, the device operations that took the most time and
the kernel launches; and the CUDA-event time of a layer's call.

The reduction works on plain (name, start, end) intervals in microseconds,
so that it is tested on the CPU with intervals made by hand."""

import time

CALL_SPAN = 'bench.call'
NAME_CHARS = 120              # a kernel's templated name is cut to this length in the breakdown
SPAN_SECONDS, SPAN_MAX_REPS = 0.5, 50


def _union(intervals, lo, hi):
    """The merged intervals of ``intervals`` clipped to [lo, hi]."""
    merged = []
    for start, end in sorted((max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _innermost(host, times):
    """For each of the sorted ``times``, the name of the shortest host
    interval that covers it (the host's intervals on one thread nest), or
    None."""
    events = sorted(host, key=lambda e: (e[1], -e[2]))
    labels, stack, i = [], [], 0
    for t in times:
        while i < len(events) and events[i][1] <= t:
            stack.append(events[i])
            i += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        cover = [e for e in stack[-8:] if e[2] >= t]
        labels.append(min(cover, key=lambda e: e[2] - e[1])[0] if cover else None)
    return labels


def reduce(host, device, top=10):
    """Reduce a trace: ``host`` the host's (name, start_us, end_us) on the
    calling thread, the calls among them named CALL_SPAN; ``device`` the
    device's operations (name, start_us, end_us). Returns the calls, the
    traced window and the device's busy time (s), the kernel launches, and
    the breakdown: the device operations that took the most time and the
    idle time by what the host was doing, each [[name, seconds], ...]."""
    calls = [e for e in host if e[0] == CALL_SPAN]
    if not calls:
        raise ValueError('the trace holds no call')
    lo, hi = min(e[1] for e in calls), max(e[2] for e in calls)
    device = [e for e in device if not e[0].startswith('bench.')]
    busy = _union([(e[1], e[2]) for e in device], lo, hi)
    gaps = [(a[1], b[0]) for a, b in zip([[lo, lo]] + busy, busy + [[hi, hi]]) if b[0] > a[1]]
    inner = [e for e in host if e[0] != CALL_SPAN]
    labels = _innermost(inner, [(a + b) / 2.0 for a, b in gaps])
    idle = {}
    for (a, b), label in zip(gaps, labels):
        label = label or 'python (between operations)'
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
    ops = {}
    for name, start, end in device:
        name = name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + '...'
        ops[name] = ops.get(name, 0.0) + (end - start) / 1e6
    launches = sum(1 for e in device if not e[0].startswith(('Memcpy', 'Memset')))
    return {
        'calls': len(calls),
        'window_s': (hi - lo) / 1e6,
        'busy_s': sum(b - a for a, b in busy) / 1e6,
        'launches': launches,
        'breakdown': {'device_ops': sorted(([n, s] for n, s in ops.items()), key=lambda x: -x[1])[:top],
                      'idle_gaps': sorted(([n, s] for n, s in idle.items()), key=lambda x: -x[1])[:top]},
    }


def profile_calls(call, ncalls, card):
    """torch.profiler over ``ncalls`` calls of ``call(i)``, each ending in a
    synchronize, as the window's loop makes them; returns :func:`reduce`."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(ncalls):
            with record_function(CALL_SPAN):
                call(i)
                card.sync()
    events = prof.events()
    threads = {e.thread for e in events if e.name == CALL_SPAN}
    host, device = [], []
    for e in events:
        interval = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device.append(interval)
        elif e.thread in threads:
            host.append(interval)
    return reduce(host, device)


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
