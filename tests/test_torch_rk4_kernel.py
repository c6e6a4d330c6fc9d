"""Phase A's dispatch between its hand-written CUDA kernel
(ops/rk4_kernel.py, csrc/rk4_phase_a.cu) and the PyTorch loop, on the CPU,
where every call takes the PyTorch loop: CPU tensors, dual tensors and
the emitting runs (the CMB sources and the perturbation series) each count
a fallback with its reason and no launch, and give what the PyTorch loop
gives called directly, bit for bit; and the
wrapper's checks raise on what the kernel does not take. The kernel itself runs in
tests/test_torch_kernels.py, on the card; here its source is compiled for
the CPU with the host's C++ compiler, a std::thread for each thread of a
block, and held to the PyTorch loop (skipped without g++), so that the two
cannot drift apart."""

import copy
import ctypes
import os
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from cosmoprimo_tpu_torch import Cosmology, tracing
from cosmoprimo_tpu_torch.boltzmann import compute_thermodynamics, perturbations as P
from cosmoprimo_tpu_torch.ops import rk4_kernel

N_STEPS = (32, 16, 256)


@pytest.fixture(scope='module')
def native():
    """Two cosmologies (massless and 0.06 eV), their recombination history
    and 4 modes each [1/Mpc]."""
    def t(v):
        return torch.tensor(v, dtype=torch.float64)

    cosmo = Cosmology(engine='native', omega_cdm=t([0.12, 0.11]), h=t([0.68, 0.7]), m_ncdm=[t([0.0, 0.06])],
                      device='cpu')
    params = cosmo.engine._perturbation_params()
    th = compute_thermodynamics(cosmo['omega_b'], cosmo['h'], cosmo['T_cmb'], cosmo.get_background().efunc,
                                tau_reio=cosmo['tau_reio'], N_eff=cosmo['N_eff'])
    k = torch.from_numpy(np.geomspace(1e-3, 0.5, 4))[None] * params['h'][:, None]
    return params, th, k


@pytest.fixture
def run(native):
    params, th, k = native
    return P._setup(params, th, k, [0.0, 1.0], N_STEPS)


def change(before, name):
    return {key: n - before[name].get(key, 0) for key, n in tracing.counters[name].items()
            if n != before[name].get(key, 0)}


def reference(run, name='phase_a', harvest=True):
    """The PyTorch loop as phase A called it before the kernel."""
    return P._rk4_loop(P.deriv_full, P._coefs_a, P._project_a, run['y0'], run['eta_A'], run['tabs'], run['lanes'],
                       True, name, harvest=(run['eta_t'], P._rows_a(run['lanes'].ns)) if harvest else None)


def test_cpu_tensors_take_the_pytorch_loop(run):
    before = copy.deepcopy(tracing.counters)
    yA, outA = P._phase_a(run, True)
    assert change(before, 'rk4_kernel.fallbacks') == {('phase_a', 'device'): 1}
    assert change(before, 'rk4_kernel.launches') == {}
    assert change(before, 'step_loop.steps') == {('phase_a', 8, 32): N_STEPS[0]}
    y_ref, out_ref, _ = reference(run)
    assert torch.equal(yA, y_ref) and torch.equal(outA, out_ref)


def test_dual_tensors_take_the_pytorch_loop(run):
    y_ref, out_ref, _ = reference(run)
    before = copy.deepcopy(tracing.counters)
    with fwAD.dual_level():
        run['y0'] = fwAD.make_dual(run['y0'], torch.ones_like(run['y0']))
        yA, outA = P._phase_a(run, True)
        y, tangent = fwAD.unpack_dual(yA)
        assert tangent is not None and bool(torch.isfinite(tangent).all())
    assert change(before, 'rk4_kernel.fallbacks') == {('phase_a', 'dual'): 1}
    assert change(before, 'rk4_kernel.launches') == {}
    assert torch.equal(y, y_ref) and torch.equal(fwAD.unpack_dual(outA).primal, out_ref)


def test_emitting_runs_take_the_pytorch_loop(native):
    params, th, k = native
    before = copy.deepcopy(tracing.counters)
    run, src, _ = P._emitting_run(params, th, k, N_STEPS, True, (P._emit_series_a, P._emit_series_b))
    assert change(before, 'rk4_kernel.fallbacks') == {('sources_a', 'emit'): 1}
    assert change(before, 'rk4_kernel.launches') == {}
    ref = P._rk4_loop(P.deriv_full, P._coefs_a, P._project_a, run['y0'], run['eta_A'], run['tabs'], run['lanes'],
                      True, 'sources_a', emit=P._emit_series_a)[2]
    assert torch.equal(src, ref)


def test_fallback_reasons():
    x = torch.ones(3, dtype=torch.float64)
    assert rk4_kernel.fallback_reason([x], 1, emit=P._emit_series_a) == 'emit'
    with fwAD.dual_level():
        assert rk4_kernel.fallback_reason([x, fwAD.make_dual(x, x)], 1) == 'dual'
    assert rk4_kernel.fallback_reason([x, x.clone().requires_grad_(True)], 1) == 'grad'
    with torch.no_grad():
        assert rk4_kernel.fallback_reason([x, x.clone().requires_grad_(True)], 1) == 'device'
    assert rk4_kernel.fallback_reason([x.float()], 1) == 'device'
    assert 'rk4_kernel.launches' in tracing.counters and 'rk4_kernel.fallbacks' in tracing.counters


def test_functorch_jvp_is_dual():
    """A tangent wrapped by torch.func.jvp is a dual tensor for the dispatch."""
    seen = []

    def f(v):
        seen.append(rk4_kernel.fallback_reason([v], 1))
        return v * 2.0

    torch.func.jvp(f, (torch.ones(3, dtype=torch.float64),), (torch.ones(3, dtype=torch.float64),))
    assert seen == ['dual']


def args_of(run):
    lanes = run['lanes']
    return (run['y0'], run['eta_A'], run['tabs'], lanes, run['eta_t'], P._n_state(lanes.ns), len(P._rows_a(lanes.ns)))


def test_plan_lays_out_the_arguments(run):
    p = rk4_kernel.plan(*args_of(run))
    N, B, nk = run['y0'].shape
    lanes = run['lanes']
    assert p['sizes'] == (B * nk, nk, B, run['tabs']['stack'].shape[-1], N_STEPS[0], 2, 1)
    assert len(p['arrays']) == 14 and all(t.is_contiguous() and t.dtype == torch.float64 for t in p['arrays'])
    assert p['arrays'][-2] is p['y'] and p['arrays'][-1] is p['harvest']
    assert p['y'].shape == (N, B, nk) and p['harvest'].shape == (2, len(P._rows_a(1)), B, nk)
    assert not bool(p['harvest'].any())
    # the momentum grid in the kernel's order: q, q^2, dlnf0, w2, w2 q, w2 q^2
    grid = torch.stack([getattr(lanes, key).reshape(-1) for key in ('q', 'q2', 'dlnf0', 'w2', 'w2q', 'w2q2')])
    assert torch.equal(torch.from_numpy(p['consts']).reshape(6, 5), grid)


def with_lanes(lanes, **changes):
    """A stand-in for ``lanes`` with some of its attributes replaced."""
    return types.SimpleNamespace(**dict(vars(lanes), **changes))


def test_wrapper_checks_raise(run):
    y0, eta, tabs, lanes, hz, n_state, n_rows = args_of(run)
    cases = [
        (TypeError, 'float64', (y0.float(), eta, tabs, lanes, hz)),
        (TypeError, 'tensor', (y0, eta, tabs, with_lanes(lanes, k=lanes.k.numpy()), hz)),
        (ValueError, 'state rows', (y0[1:], eta, tabs, lanes, hz)),
        (ValueError, 'eta', (y0, eta[:1], tabs, lanes, hz)),
        (ValueError, 'eta', (y0, eta[:, :1], tabs, lanes, hz)),
        (ValueError, 'stack', (y0, eta, dict(tabs, stack=tabs['stack'][:12]), lanes, hz)),
        (ValueError, 'massive species', (y0, eta, dict(tabs, am=tabs['am'].repeat(4, 1, 1)), lanes, hz)),
        (ValueError, 'K', (y0, eta, dict(tabs, K=tabs['K'][:1]), lanes, hz)),
        (ValueError, 'eta_rsa', (y0, eta, tabs, with_lanes(lanes, eta_rsa=lanes.eta_rsa[:, :2]), hz)),
        (ValueError, 'harvest_eta', (y0, eta, tabs, lanes, hz[:1])),
        (ValueError, 'momentum grid', (y0, eta, tabs, with_lanes(lanes, grid=lanes.grid[:29]), hz)),
    ]
    for error, match, args in cases:
        with pytest.raises(error, match=match):
            rk4_kernel.plan(*args, n_state, n_rows)
    with pytest.raises(ValueError, match='CUDA'):
        rk4_kernel.launch(y0, eta, tabs, lanes, hz, n_state, n_rows)


# The kernel's source on the CPU: everything above its launch section, with
# the CUDA qualifiers defined away, __ldg a load, the block's shared memory
# a buffer and __syncthreads a std::barrier over the block's threads.
CUDA_STUB = r"""
#pragma once
#include <barrier>
#include <cmath>
typedef int cudaError_t;
typedef void* cudaStream_t;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict
struct EmuDim { int x; };
extern thread_local EmuDim threadIdx;
extern EmuDim blockIdx;
extern double* emu_smem;
extern std::barrier<>* emu_barrier;
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
template <class T> inline T __ldg(const T* p) { return *p; }
"""

EMU_LAUNCH = r"""
#include "cuda_runtime.h"
#include <thread>
#include <vector>
thread_local EmuDim threadIdx;
EmuDim blockIdx;
double* emu_smem;
std::barrier<>* emu_barrier;
#include "kernel_body.inc"
}  // namespace
extern "C" int emu_launch(void* const* ptrs, const double* consts, const long long* sizes) {
    if (sizes[6] != 1) return 1;
    Args a;
    const double** in[] = {&a.y0, &a.eta, &a.stack, &a.lneta0, &a.dlneta, &a.K, &a.wa, &a.cs2, &a.am, &a.k,
                           &a.eta_rsa, &a.hz};
    for (int i = 0; i < 12; ++i) *in[i] = (const double*)ptrs[i];
    a.y_out = (double*)ptrs[12];
    a.harvest = (double*)ptrs[13];
    double* grid[] = {a.q, a.q2, a.dlnf0, a.w2, a.w2q, a.w2q2};
    for (int g = 0; g < 6; ++g)
        for (int q = 0; q < kNq; ++q) grid[g][q] = consts[g * kNq + q];
    a.lanes = sizes[0]; a.nk = (int)sizes[1]; a.B = (int)sizes[2]; a.M = (int)sizes[3];
    a.n_steps = (int)sizes[4]; a.nz = (int)sizes[5];
    constexpr int T = lanes_per_block(1), nt = threads_per_block(1);
    std::vector<double> shared(T * lane_doubles(1));
    emu_smem = shared.data();
    for (long long b = 0; b < (a.lanes + T - 1) / T; ++b) {
        blockIdx.x = (int)b;
        std::barrier<> bar(nt);
        emu_barrier = &bar;
        std::vector<std::thread> threads;
        for (int t = 0; t < nt; ++t) threads.emplace_back([&a, t] { threadIdx.x = t; rk4_phase_a_kernel<1, T>(a); });
        for (auto& thread : threads) thread.join();
    }
    return 0;
}
"""


def test_kernel_source_on_the_cpu_against_the_pytorch_loop(run, tmp_path):
    """The kernel's arithmetic against the PyTorch loop on the CPU (one
    massive species, both cosmologies of the fixture): the end state per
    (row, cosmology) and the harvest per (z, row, cosmology) at 1e-10 of
    their largest |value| over the modes (measured ~1e-13 at this budget;
    the two add the momentum bins in other orders)."""
    cxx = shutil.which('g++')
    if cxx is None:
        pytest.skip('needs g++ to build the kernel source for the CPU')
    src = os.path.join(os.path.dirname(rk4_kernel.__file__), os.pardir, 'csrc', 'rk4_phase_a.cu')
    with open(src) as f:
        body = f.read().split('// ---- the launch')[0]
    body = body.replace('extern __shared__ double smem[];', 'double* smem = emu_smem;')
    (tmp_path / 'kernel_body.inc').write_text(body)
    (tmp_path / 'cuda_runtime.h').write_text(CUDA_STUB)
    (tmp_path / 'emu.cpp').write_text(EMU_LAUNCH)
    lib = tmp_path / 'libemu.so'
    subprocess.run([cxx, '-std=c++20', '-O1', '-pthread', '-shared', '-fPIC', f'-I{tmp_path}', '-o', str(lib),
                    str(tmp_path / 'emu.cpp')], check=True, capture_output=True, timeout=300)
    emu = ctypes.CDLL(str(lib))
    emu.emu_launch.argtypes = [ctypes.c_void_p] * 3
    p = rk4_kernel.plan(*args_of(run))
    ptrs = (ctypes.c_void_p * len(p['arrays']))(*[t.data_ptr() for t in p['arrays']])
    assert emu.emu_launch(ptrs, p['consts'].ctypes.data_as(ctypes.c_void_p),
                          (ctypes.c_longlong * len(p['sizes']))(*p['sizes'])) == 0
    y_ref, out_ref, _ = reference(run)
    for got, ref in ((p['y'], y_ref), (p['harvest'], out_ref)):
        assert bool(torch.isfinite(ref).all())
        scale = ref.abs().amax(dim=-1)
        err = (got - ref).abs().amax(dim=-1)
        assert bool((err[scale == 0] == 0).all())
        assert (err[scale > 0] / scale[scale > 0]).max().item() <= 1e-10
