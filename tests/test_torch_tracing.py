"""The program's spans and counters (cosmoprimo_tpu_torch/tracing.py) and
its trace exporter (utils.profile_trace), on the CPU: off outside a
profiled session of the program, nested as the layers nest inside one,
transparent to torch.func, and the FFTLog counters.

The spans are read here from the profiler's raw events, as the benchmark's
layer reader reads them on the card."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity

from cosmoprimo_tpu_torch import (Cosmology, PowerSpectrumBAOFilter, PowerToCorrelation, make_pk_to_xi_pipeline,
                                  make_pk_to_xi_pipeline_batched, tracing)
from cosmoprimo_tpu_torch.fiducial import DESI
from cosmoprimo_tpu_torch.utils import profile_trace

PARAMS = (0.12, 0.0224, 0.675, 0.965, 3.04)


def batch(n):
    rng = np.random.default_rng(3)
    return [torch.from_numpy(rng.uniform(0.99, 1.01, n) * p) for p in PARAMS]


def spans(prof):
    """The program's spans of a finished profile: [(name, start_ns, end_ns)]."""
    return [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
            if e.name().startswith('cosmoprimo.')]


def parents(events):
    """Each span name with the set of names of the spans directly around it
    (None at the top)."""
    out = {}
    for name, start, end in events:
        around = [e for e in events if e[1] <= start and end <= e[2] and (e[1], e[2]) != (start, end)]
        parent = min(around, key=lambda e: e[2] - e[1])[0] if around else None
        out.setdefault(name, set()).add(parent)
    return out


def test_a_span_is_the_shared_noop_outside_a_session():
    assert tracing.span('cosmoprimo.params') is tracing.NOOP
    fn, _, _ = make_pk_to_xi_pipeline_batched(nk=128)
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:    # a bare profiler: spans stay off
        assert tracing.span('cosmoprimo.params') is tracing.NOOP
        fn(*batch(2))
    assert spans(prof) == []
    with tracing.profile():
        assert tracing.span('cosmoprimo.params') is not tracing.NOOP
    assert tracing.span('cosmoprimo.params') is tracing.NOOP


def test_the_pipeline_spans_nest_as_the_layers():
    fn, _, _ = make_pk_to_xi_pipeline_batched(nk=128, z=(0.0, 1.0))
    with tracing.profile() as prof:
        fn(*batch(2))
    found = parents(spans(prof))
    assert found['cosmoprimo.pipeline.pk_to_xi'] == {None}
    for name in ('cosmoprimo.params', 'cosmoprimo.linear_pk', 'cosmoprimo.fftlog'):
        assert found[name] == {'cosmoprimo.pipeline.pk_to_xi'}, name
    # chi's table is built inside the call that first reads it
    assert found['cosmoprimo.background'] == {'cosmoprimo.pipeline.pk_to_xi', 'cosmoprimo.background'}


def test_the_bao_template_spans_nest_as_the_layers():
    params = dict(zip(('omega_cdm', 'omega_b', 'h', 'n_s', 'logA'), batch(2)))
    z = np.array([0.5, 1.0])
    fiducial = DESI(engine='eisenstein_hu', device='cpu')
    with tracing.profile() as prof:
        cosmo = Cosmology(engine='eisenstein_hu', m_ncdm=[torch.full((2,), 0.06, dtype=torch.float64)], **params)
        pk = cosmo.get_fourier().pk_interpolator(z=z)
        filt = PowerSpectrumBAOFilter(pk, engine='peakaverage', cosmo=cosmo, cosmo_fid=fiducial)
        filt.smooth_pk_interpolator().to_xi(nk=256)
        cosmo.comoving_radial_distance(torch.from_numpy(z))
    found = parents(spans(prof))
    assert found['cosmoprimo.bao_filter'] == {None}
    for name in ('evaluate', 'prepare', 'compute'):
        assert found['cosmoprimo.bao_filter.' + name] == {'cosmoprimo.bao_filter'}
    assert found['cosmoprimo.to_xi'] == {None}
    assert found['cosmoprimo.fftlog'] == {'cosmoprimo.to_xi'}
    # the filter's per-row splines and to_xi's spline of xi, among the tables' and the smooth P(k)'s
    assert {'cosmoprimo.bao_filter.compute', 'cosmoprimo.to_xi'} <= found['cosmoprimo.spline_build']
    # P(k) of the cosmology, of the fiducial and EH's no-wiggle P(k)
    assert found['cosmoprimo.linear_pk'] == {'cosmoprimo.bao_filter.' + name for name in ('evaluate', 'prepare',
                                                                                         'compute')}
    assert None in found['cosmoprimo.background'] and None in found['cosmoprimo.params']


def test_jacfwd_of_the_pipeline_is_the_same_under_the_profiler():
    fn, _, _ = make_pk_to_xi_pipeline(nk=128, fft_engine='kernel')
    args = [p[0] for p in batch(1)]
    jac = torch.func.jacfwd(lambda *a: fn(*a)[0], argnums=(0, 2))
    plain = jac(*args)
    with tracing.profile() as prof:
        traced = jac(*args)
    assert all(torch.equal(a, b) for a, b in zip(plain, traced))
    assert {'cosmoprimo.pipeline.pk_to_xi', 'cosmoprimo.fftlog'} <= {name for name, _, _ in spans(prof)}


def test_the_fftlog_counters_count_the_cpu_path():
    k = np.geomspace(1e-4, 10.0, 100)
    transform = PowerToCorrelation(k, engine='kernel')
    x = torch.from_numpy(k ** -1.5)[None].expand(5, -1).contiguous()
    counters = tracing.counters
    shape = (5, 100, transform.padded_size, 1)
    launches, shapes, before = counters['fftlog.launches'], dict(counters['fftlog.shapes']), \
        counters['fftlog.calls'].get(shape, 0)
    transform(x)
    torch.func.jvp(lambda f: transform(f)[1], (x,), (x,))      # the primal and the tangent: two calls
    assert counters['fftlog.calls'][shape] == before + 3
    # the plain version on CPU tensors launches no kernel
    assert counters['fftlog.launches'] == launches and counters['fftlog.shapes'] == shapes
    PowerToCorrelation(k, engine='torch')(x)                 # the unfused engine calls no core
    assert counters['fftlog.calls'][shape] == before + 3


def test_profile_trace_writes_the_spans_and_the_counters(tmp_path):
    k = np.geomspace(1e-4, 10.0, 100)
    with profile_trace(str(tmp_path / 'trace')) as dirname:
        PowerToCorrelation(k, engine='kernel')(torch.from_numpy(k ** -1.5))
    with open(tmp_path / 'trace' / 'trace.json') as f:
        names = {event.get('name') for event in json.load(f)['traceEvents']}
    assert 'cosmoprimo.fftlog' in names
    with open(tmp_path / 'trace' / 'counters.json') as f:
        counters = json.load(f)
    assert dirname == str(tmp_path / 'trace')
    assert counters['fftlog.calls']['1,100,256,1'] >= 1
    assert set(counters) == set(tracing.counters)


@pytest.mark.parametrize('name', ['cosmoprimo.params', 'cosmoprimo.fftlog.kernel'])
def test_a_span_enters_and_leaves_in_a_session(name):
    with tracing.profile() as prof:
        with tracing.span(name):
            torch.ones(3).sum()
    assert [e[0] for e in spans(prof)] == [name]


def test_a_span_falls_back_to_the_public_record_function(monkeypatch):
    """A torch without the fast record function: the span is
    torch.profiler.record_function, on the same timeline."""
    monkeypatch.setattr(tracing, '_range', torch.profiler.record_function)
    with tracing.profile() as prof:
        with tracing.span('cosmoprimo.params'):
            torch.ones(3).sum()
    assert [e[0] for e in spans(prof)] == ['cosmoprimo.params']
