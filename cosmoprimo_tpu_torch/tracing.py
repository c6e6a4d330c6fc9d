"""The program's spans and counters.

Spans. ``with span('cosmoprimo.<layer>'):`` marks a layer's boundary. Inside
a profiled session of the program (:func:`profile`, and
``utils.profile_trace`` on it) each span is a range on the profiler's own
host timeline, the clock of its device trace, so every kernel and every idle
gap of the device can be matched to the span that was open on the host.
Elsewhere :func:`span` returns one shared no-op object: one check of a
module flag, nothing recorded. A bare ``torch.profiler`` session leaves the
spans off, so a trace that the program did not ask for reads as it would
without them. Spans sit at layer boundaries only, never inside a per-step
loop or a CUDA-graph capture. The range is torch's fast record function
(``torch._C._profiler._RecordFunctionFast``, the profiler's function
scope), not ``torch.profiler.record_function`` (the user scope): it makes
no device-side copy of itself and runs inside ``torch.func`` transforms
(jacfwd, jvp, vmap). The class is private; a torch without it takes
``torch.profiler.record_function``, whose device-side copies the
benchmark's layer reader leaves out.

Counters. :data:`counters` is one plain dict, always on: each count is one
increment at a boundary that runs a few times a call. Read it and reset it
with dict operations (``counters['fftlog.launches'] = 0``).

- ``fftlog.launches``: the FFTLog core kernel's launches
  (``ops/fftlog_kernel.py``), counted once the launch has returned without
  error; a call with no rows, or on CPU tensors, launches nothing;
- ``fftlog.shapes``: those launches by ``(rows, size, padded, nparallel)``;
- ``fftlog.calls``: calls of the FFTLog core on either device, by the same
  shape: the kernel's on CUDA tensors, its plain version's on CPU tensors;
- ``spline.launches``: the spline solve kernel's launches
  (``ops/spline_kernel.py``), counted once the launch has returned without
  error; CPU tensors take the plain version and launch nothing;
- ``spline.shapes``: those launches by ``(systems, knots, layout)``, the
  layout 'tiled' or 'strided' (the knot axis contiguous or not) and
  'shared' or 'rows' (the knots shared by every system or not);
- ``fftlog_kernel.builds``: nvcc runs of the kernel's build in this process;
- ``fftlog_kernel.build_s``: host seconds of the kernel library's first
  use: its build (or the check of a cached build) and its load;
- ``bao_filter.fiducial_fits``: host fits of the BAO filters' fiducial.

This module imports no JAX.
"""

import contextlib

import torch
from torch.profiler import ProfilerActivity

counters = {
    'fftlog.launches': 0,
    'fftlog.shapes': {},
    'fftlog.calls': {},
    'spline.launches': 0,
    'spline.shapes': {},
    'fftlog_kernel.builds': 0,
    'fftlog_kernel.build_s': 0.0,
    'bao_filter.fiducial_fits': 0,
}

_sessions = 0       # profiled sessions of the program open in this process
_range = getattr(torch._C._profiler, '_RecordFunctionFast', None) or torch.profiler.record_function


class _Noop:
    """The span outside a profiled session: enters and leaves, records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


def span(name):
    """The span ``name`` (a context manager): a profiler range inside a
    profiled session of the program, else :data:`NOOP`."""
    return _range(name) if _sessions else NOOP


@contextlib.contextmanager
def profile():
    """``torch.profiler.profile`` over the block, of the CPU and, where
    there is a card, of CUDA, with the program's spans on; yields the
    profiler."""
    global _sessions
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with torch.profiler.profile(activities=activities) as prof:
        _sessions += 1
        try:
            yield prof
        finally:
            _sessions -= 1
