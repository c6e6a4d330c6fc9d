"""Per-stage device profile of the halofit, HMcode, BAO-template and native
Boltzmann paths on one CUDA card:

    python3 -m cosmoprimo_tpu_torch.stage_profile [halofit] [HMcode] [BAO] [native] [harmonic] [emulated] [train]

(all seven without an argument; 'emulated' from the repository's root).

For each stage (set-up, linear P(k), the sigma^2 matmul, halofit's Newton
block, HMcode's growth ODE, dewiggle and one-halo NFW tensor, the whole
non-linear transform through ``apply_non_linear``, the FFTLog kernel) it
prints the device busy ms and kernel launches of one call under
``torch.profiler`` and the stream ms between CUDA events; then, for each
pipeline, the device busy time of one profiled call against its wall time
without the profiler (the device's idle share) and its top kernels. Sizes
are those of chip_smoke.py: halofit at B = 16 384, nk = 1024, HMcode at
B = 4096, nk = 384, z = [0]; the BAO template (chip_smoke's phase 8) at
B = 4096 cosmologies with one massive neutrino species, nk = 1024, the
seven DESI DR1 redshifts and the DESI fiducial: the set-up, the P(k) table
on the filters' grid, each traced filter, to_xi of the smooth and of the
linear spectrum, kirkby2013 and to_pk, then one peakaverage filter and
to_xi as a whole. The native path (make_native_pk_pipeline_batched at
B = 64, nk = 256, kmax = 1.0, z = [0, 1]) by stage: set-up, thermodynamics,
tables and grids, phase A (one launch of its kernel, profiled whole),
phase B, assembly and sigma8; phase B with CUDA graphs and eagerly: its
device ms and launches per step under torch.profiler on an eager slice of
256 steps (a full phase is millions of launches), its stream ms over the
whole stage (CUDA events; eagerly, the slice's per step times the steps),
and the device's busy share; the recombination scan is timed, not
profiled. The native CMB path (harmonic:
B = 8, lmax 2900, the 198-k coarse grid): the emitting RK4 steps with and
without the line-of-sight taps (device ms and launches a step, profiled
eagerly on a slice), the sources with graphs, the projection beside its
bound, Limber, the tensors and the lensing. The emulated path (chip_smoke's
phase 21: the 'native-base' layout at B = 4096) by section, with the
FourierNormOperation and the FFTLog stages, and the converted cosmopower
release of phase 22. The training path (train: chip_smoke's phase-23 nets,
the 'native-base' fourier nets 64 x 5 silu on 4096 samples with 12 660 and
422 outputs, and the thermodynamics nets 10 x 5 tanh on 256): the device
ms and launches of one Adam step and of one validation, and one epoch
against its wall (the host's gaps). Parameters and data are drawn from a
seed. Informational only: it checks nothing, and prints the
card's name and power limit.
"""

import subprocess
import sys
import time

import numpy as np
import torch

from . import Cosmology, PowerToCorrelation, constants, make_native_pk_pipeline_batched, make_pk_to_xi_pipeline_batched
from .models import halofit, hmcode
from .pipelines import apply_non_linear

DEVICE = 'cuda'
SIZES = (('halofit', 'halofit', 16384, 1024), ('HMcode', 'mead', 4096, 384))


def cuda_ms(fn, reps=5):
    """Mean stream ms of ``fn`` between CUDA events, after 3 warm-ups."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps=5):
    """Median host wall ms of ``fn`` ending in a synchronize, after a warm-up."""
    fn()
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls)) * 1e3


def profile_events(fn):
    """Device busy ms, profiled wall ms, kernel kinds, launches and the top
    kernels of one call of ``fn`` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return busy, wall, len(kernels), sum(e.count for e in kernels), [
        (e.key[:70], e.self_device_time_total / 1e3, e.count) for e in top]


def stages(non_linear, n, nk, rng):
    """The stages of one pipeline as {name: callable}, and its parameters."""
    params = tuple(torch.from_numpy(p).to(DEVICE) for p in (
        rng.uniform(0.11, 0.13, n), rng.uniform(0.021, 0.023, n), rng.uniform(0.65, 0.70, n),
        rng.uniform(0.94, 0.98, n), rng.uniform(2.9, 3.1, n)))
    omega_cdm, omega_b, h, n_s, logA = params
    k_np = np.geomspace(1e-5, 1e2, nk)
    k, z = torch.from_numpy(k_np).to(DEVICE), torch.zeros(1, dtype=torch.float64, device=DEVICE)

    def setup():
        return Cosmology(omega_cdm=omega_cdm, omega_b=omega_b, h=h, n_s=n_s, logA=logA, engine='eisenstein_hu')

    cosmo = setup()
    pk, ba = cosmo.get_fourier().pk_interpolator(), cosmo.get_background()
    pk_t = pk(k, z).transpose(-1, -2)
    out = {'set-up (Cosmology, sections)': lambda: setup().get_fourier().pk_interpolator(),
           'linear P(k)': lambda: pk(k, z)}
    if non_linear == 'halofit':
        R = halofit._geomspace(1e-3, 1e3, 128, k.device)
        lnsig2 = torch.log(halofit.sigma_gauss2(k, pk_t, R)).movedim(-1, 0)
        out['sigma^2 matmul'] = lambda: halofit.sigma_gauss2(k, pk_t, R)
        out['Newton (spline solve, 12 steps)'] = lambda: halofit._nonlinear_scale(torch.log(R), lnsig2)
    else:
        R = halofit._geomspace(5e-4, 5e1, 64, k.device)
        omega_m = cosmo['Omega_m'] * h ** 2
        # k r_s and concentrations of the one-halo tensor's shape and range
        krs = torch.from_numpy(np.geomspace(1e-3, 1e3, 32 * 64).reshape(32, 64)
                               * rng.uniform(1.0, 2.0, (n, 1, 1, 1))).to(DEVICE)
        conc = torch.from_numpy(rng.uniform(4.0, 10.0, (n, 1, 1, 64))).to(DEVICE)
        out['sigma^2 matmul'] = lambda: hmcode.sigma_tophat2(k, pk_t, R)
        out['growth ODE (Magnus)'] = lambda: hmcode.mead_growth_ratios(z, omega_m / h ** 2)
        out['dewiggle'] = lambda: hmcode.dewiggle(k, pk_t, h, omega_m, omega_b, constants.TCMB / 2.7, n_s)
        out[f'one-halo NFW tensor ({n}, 1, 32, 64), sici twice'] = lambda: hmcode.nfw_window(krs, conc)
    out['non-linear transform, total'] = lambda: apply_non_linear(non_linear, cosmo, ba, k, pk_t, z, omega_b, h, n_s)
    p2c, pk_nl = PowerToCorrelation(k_np), out['non-linear transform, total']()
    out['FFTLog (kernel)'] = lambda: p2c(pk_nl)
    return out, params


DESI_Z = (0.295, 0.51, 0.706, 0.93, 1.317, 1.491, 2.33)


def bao_stages(n, rng):
    """The stages of the BAO-template path as {name: callable}, and the
    whole (one peakaverage filter and to_xi)."""
    from .bao_filter import CorrelationFunctionBAOFilter, PowerSpectrumBAOFilter
    from .fiducial import DESI
    params = [torch.from_numpy(p).to(DEVICE) for p in (
        rng.uniform(0.11, 0.13, n), rng.uniform(0.021, 0.023, n), rng.uniform(0.65, 0.70, n),
        rng.uniform(0.94, 0.98, n), rng.uniform(2.9, 3.1, n), rng.uniform(0.06, 0.12, n))]

    def setup():
        omega_cdm, omega_b, h, n_s, logA, m_ncdm = params
        cosmo = Cosmology(omega_cdm=omega_cdm, omega_b=omega_b, h=h, n_s=n_s, logA=logA, m_ncdm=[m_ncdm],
                          N_eff=3.044, engine='eisenstein_hu')
        cosmo.get_background().efunc(torch.zeros(1, dtype=torch.float64, device=DEVICE))   # the ncdm tables
        return cosmo

    cosmo, fid = setup(), DESI(engine='eisenstein_hu')
    pk = cosmo.get_fourier().pk_interpolator(z=DESI_Z)
    k, z = torch.from_numpy(np.geomspace(1e-7, 1e2, 1024)).to(DEVICE), torch.tensor(DESI_Z, device=DEVICE)

    def pk_filter(name):
        return lambda: PowerSpectrumBAOFilter(pk, engine=name, cosmo=cosmo, cosmo_fid=fid)

    smooth = pk_filter('peakaverage')().smooth_pk_interpolator()
    xi = pk.to_xi()
    smooth_xi = CorrelationFunctionBAOFilter(xi, engine='kirkby2013', cosmo=cosmo, cosmo_fid=fid).smooth_xi_interpolator()
    out = {'set-up (Cosmology with the ncdm tables)': setup, "P(k) table on the filters' grid": lambda: pk(k, z)}
    for name in ('peakaverage', 'bspline', 'ehpoly', 'hinton2017', 'savgol', 'ehsavgol'):
        out[f'filter {name}'] = pk_filter(name)
    out.update({'to_xi of the smooth P(k) (2D spline, FFTLog, xi table)': smooth.to_xi,
                'to_xi of the linear P(k)': pk.to_xi,
                'filter kirkby2013': lambda: CorrelationFunctionBAOFilter(xi, engine='kirkby2013', cosmo=cosmo,
                                                                          cosmo_fid=fid),
                'to_pk of the smooth xi': smooth_xi.to_pk})
    return out, lambda: pk_filter('peakaverage')().smooth_pk_interpolator().to_xi()


def stream_ms(fn):
    """Stream ms of one call of ``fn`` between CUDA events (no warm-up)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def native_profile(card, n=64, nk=256, kmax=1.0, z=(0.0, 1.0), rng=None, slice_steps=256):
    """Print the native path's stages, with CUDA graphs and eagerly."""
    from .boltzmann import compute_thermodynamics
    from .boltzmann import perturbations as P
    from .boltzmann import thermodynamics as T
    from .interpolator import kernel_tophat2
    from .ops import simpson
    params = [torch.from_numpy(p).to(DEVICE) for p in (
        rng.uniform(0.11, 0.13, n), rng.uniform(0.021, 0.023, n), rng.uniform(0.65, 0.70, n),
        rng.uniform(0.94, 0.98, n), rng.uniform(2.9, 3.1, n))]
    k_np = np.geomspace(1e-4, kmax, nk)
    k = torch.from_numpy(k_np).to(DEVICE)
    w8 = torch.from_numpy(k_np ** 3 * kernel_tophat2(torch.from_numpy(8.0 * k_np)).numpy()).to(DEVICE)
    n_steps = P.steps_for_kmax(kmax)

    def setup():
        omega_cdm, omega_b, h, n_s, logA = params
        cosmo = Cosmology(omega_cdm=omega_cdm, omega_b=omega_b, h=h, n_s=n_s, logA=logA, engine='native')
        return cosmo, cosmo.engine._perturbation_params()

    cosmo, pp = setup()
    ba = cosmo.get_background()
    kk = k * pp['h'][:, None]

    def thermo(graphs):
        return compute_thermodynamics(cosmo['omega_b'], cosmo['h'], cosmo['T_cmb'], ba.efunc, tau_reio=cosmo['tau_reio'],
                                      reionization_width=cosmo['reionization_width'], N_eff=cosmo['N_eff'],
                                      graphs=graphs)

    th = thermo(True)
    run = P._setup(pp, th, kk, list(z), n_steps)
    yA, outA = P._phase_a(run, True)
    outB = P._phase_b(run, yA, True)

    def assembly():
        pk = P._assemble(run, outA, outB)['delta_m']
        return torch.sqrt(simpson(pk[:, 0] * w8, x=torch.log(k)) / (2.0 * np.pi ** 2))

    once = {'set-up (Cosmology, solver parameters)': setup,
            'tables and grids (build_tables, time grids, initial state)': lambda: P._setup(pp, th, kk, list(z), n_steps),
            'assembly and sigma8': assembly}
    for name, fn in once.items():
        busy, _, _, launches, _ = profile_events(fn)
        print(f'stage, native B={n} nk={nk}: {name}: device {busy:.4f} ms in {launches} launches, stream '
              f'{stream_ms(fn):.3f} ms on {card}', flush=True)
    # the recombination scan (~370 launches a step) is timed whole, not profiled
    scan = T.N_GRID - 1 - T.saha_steps()
    for graphs in (True, False):
        print(f'stage, native B={n} nk={nk}: thermodynamics (recombination scan, {scan} steps), '
              f'{"graphs" if graphs else "eager"}: stream {stream_ms(lambda: thermo(graphs)):.1f} ms on {card}',
              flush=True)
    # phase A is one launch of its hand kernel on the card: profiled whole
    busy, _, _, launches, _ = profile_events(lambda: P._phase_a(run, True))
    print(f'stage, native B={n} nk={nk}: phase A ({n_steps[0]} steps, ops/rk4_kernel.py): device {busy:.1f} ms in '
          f'{launches} launches, {busy / n_steps[0]:.4f} ms a step; stream {stream_ms(lambda: P._phase_a(run, True)):.1f} '
          f'ms on {card}', flush=True)
    loops = {'phase B': (lambda r, g: P._phase_b(r, yA, g), 'eta_B', n_steps[1])}
    for name, (fn, grid, steps) in loops.items():
        # profiled eagerly on a slice (a graph is captured anew in every call,
        # and capture is kept out of the profiler); the replayed graph runs the
        # same kernels, so its busy share is their device time over its stream time
        part = {**run, grid: run[grid][:slice_steps + 1]}
        busy, _, _, launches, _ = profile_events(lambda: fn(part, False))
        busy, launches = busy / slice_steps, launches / slice_steps
        eager = stream_ms(lambda: fn(part, False)) * steps / slice_steps
        graph = stream_ms(lambda: fn(run, True))
        print(f'stage, native B={n} nk={nk}: {name} ({steps} steps): device {busy:.4f} ms and {launches:.1f} '
              f'launches a step (profiled eagerly on {slice_steps} steps); stream {graph:.1f} ms with graphs (device '
              f'busy {busy * steps / graph:.1%}), {eager:.1f} ms eagerly (the slice scaled; busy '
              f'{busy * steps / eager:.1%}) on {card}', flush=True)
    fn, _ = make_native_pk_pipeline_batched(nk=nk, kmax=kmax, z=z)
    wall = wall_ms(lambda: fn(*params), reps=1)
    print(f'native pipeline B={n} nk={nk} kmax={kmax}: wall {wall:.1f} ms with CUDA graphs on {card}', flush=True)


def harmonic_profile(card, n=8, lmax=2900, rng=None, slice_steps=256):
    """Print the native CMB path's stages at full width (ellmax_cl = 2500 and
    the default lensing margin: lmax 2900; tensors to l = 600): the emitting
    RK4 phases profiled eagerly on a slice against the same slice without
    the taps (the emitters' share of a step), the sources with graphs, the
    projection beside its bound, Limber, the tensor loop and projection, and
    the lensing."""
    from .boltzmann import harmonic as Hm, lensing, perturbations as P, tensor as T
    params = [torch.from_numpy(p).to(DEVICE) for p in (
        rng.uniform(0.11, 0.13, n), rng.uniform(0.021, 0.023, n), rng.uniform(0.65, 0.70, n),
        rng.uniform(0.94, 0.98, n), rng.uniform(2.9, 3.1, n))]
    omega_cdm, omega_b, h, n_s, logA = params
    cosmo = Cosmology(omega_cdm=omega_cdm, omega_b=omega_b, h=h, n_s=n_s, logA=logA, r=0.05, engine='native')
    pp, th = cosmo.engine._perturbation_params(), cosmo.get_thermodynamics().table
    src, src_main, ells, tables, n_quad_late = Hm._cl_inputs(pp, th, lmax)
    k_c = src['k'].contiguous()
    label = f'CMB B={n} lmax={lmax} nk={k_c.shape[-1]}'
    run = P._setup(pp, th, k_c, None, None)
    loops = {'phase A': (P.deriv_full, P._coefs_a, P._project_a, P._emit_los_a, P._psi_rates_a, run['y0'], 'eta_A'),
             'phase B': (P.deriv_rsa, P._coefs_b, P._project_b, P._emit_los_b, P._psi_rates_b,
                         P._ncdm_handoff(run['y0'], run['eta_A'][0], run['tabs'], run['lanes']), 'eta_B')}
    for name, (deriv, coefs, project, emit, rates, y0, grid) in loops.items():
        part = run[grid][:slice_steps + 1]
        res = {}
        for taps in (False, True):
            busy, _, _, launches, _ = profile_events(lambda: P._rk4_loop(
                deriv, coefs, project, y0, part, run['tabs'], run['lanes'], False, 'stage_profile',
                emit=emit if taps else None, rates=rates if taps else None))
            res[taps] = (busy / slice_steps, launches / slice_steps)
        print(f'stage, {label}: {name} step, profiled eagerly on {slice_steps} steps: with the taps '
              f'{res[True][0]:.4f} ms '
              f'of device and {res[True][1]:.1f} launches a step, without {res[False][0]:.4f} ms and '
              f'{res[False][1]:.1f} (the emitters {1 - res[False][0] / res[True][0]:.1%} of the device time) on {card}',
              flush=True)
    ms = stream_ms(lambda: P.compute_los_sources(pp, th, k_c))
    print(f'stage, {label}: sources (compute_los_sources, 10240 + 6144 steps, graphs): stream {ms:.1f} ms on {card}',
          flush=True)
    cells = n * Hm._fine_grid(src_main, Hm.cl_kmin).numel() * (Hm.N_REC + n_quad_late)
    # the bound: the four sources read once per multipole, or ~35 f64
    # operations per (row, k, tau) cell and multipole, the larger
    bound = max(32.0 * cells / 3.35e12, 35.0 * cells / 34e12) * ells.size * 1e3
    named = {'projection (project_sources)':
             lambda: Hm.project_sources(src_main, ells, tables, n_quad_late=n_quad_late),
             'Limber (limber_pp)': lambda: Hm.limber_pp(src, ells),
             'tensors (compute_tensor_cls, 8192 steps, l <= 600)': lambda: T.compute_tensor_cls(
                 dict(pp, r=torch.full_like(h, 0.05), n_t=torch.zeros_like(h), alpha_t=torch.zeros_like(h)), th,
                 lmax=600)}
    for name, fn in named.items():
        ms = stream_ms(fn)
        busy, _, _, launches, _ = profile_events(fn)
        extra = f'; bound {bound:.1f} ms (the sources read once per multipole)' if name.startswith('projection') else ''
        print(f'stage, {label}: {name}: stream {ms:.1f} ms, device {busy:.1f} ms in {launches} launches{extra} '
              f'on {card}', flush=True)
    unl = Hm.compute_cls(pp, th, lmax=lmax)

    def fn():
        return lensing.lensed_cls(unl['tt'], unl['ee'], unl['bb'], unl['te'], unl['pp'], lmax=lmax - 400)

    ms = stream_ms(fn)
    busy, _, _, launches, _ = profile_events(fn)
    print(f'stage, {label}: lensing (lensed_cls, n_r = 8192): stream {ms:.1f} ms, device {busy:.1f} ms in {launches} '
          f'launches on {card}', flush=True)


def emulated_profile(card, n=4096, rng=None):
    """Print the emulated engine's stages at chip_smoke's phase-21 size (the
    'native-base' layout of chip_smoke.native_base_emulator_state, B = 4096,
    Cls to 2500): the set-up, each section's nets and section, the
    FourierNormOperation and its BBKS primordial spectrum, the P(k)
    interpolator, sigma8_m and to_xi (the FFTLog kernel), the Cls; then the
    whole build-and-serve against its wall (the device's idle share), and
    the converted cosmopower release of phase 22. Run from the repository's
    root (it imports chip_smoke)."""
    import os
    import tempfile
    import chip_smoke
    from .emulators import EmulatedEngine, Emulator
    from .emulators.conversion import convert_cosmopower_release_to_cosmoprimo
    directory = tempfile.mkdtemp()
    fn = os.path.join(directory, 'native_base.npy')
    Emulator.from_state(chip_smoke.native_base_emulator_state()).write(fn)
    engine = EmulatedEngine.read(fn)
    values = {name: torch.from_numpy(value).to(DEVICE) for name, value in chip_smoke.emulator_params(rng, n).items()}
    z = torch.from_numpy(chip_smoke.DESI_Z).to(DEVICE)
    k, s = np.geomspace(1e-3, 1.0, 64), np.geomspace(10.0, 150.0, 32)

    def setup():
        return Cosmology(engine=engine, ellmax_cl=chip_smoke.ELLMAX_EMU, **values)

    cosmo = setup()
    eng = cosmo.engine
    predictor = eng._predictor
    entry = predictor.index['fourier']
    raw = {name: eng._emulator.engines[name].predict(predictor.x) for name in entry['static']}
    norm = eng._emulator.yoperations[0]
    fixed = {**entry['fixed'], **raw}
    fo = cosmo.get_fourier()
    pk = fo.pk_interpolator()

    def fresh(section):
        def build():
            eng._sections.pop(section, None)
            return eng.get_section(section)
        return build

    def serve():
        c = setup()
        ba, fourier, hr = c.get_background(), c.get_fourier(), c.get_harmonic()
        interp = fourier.pk_interpolator()
        return (ba.comoving_radial_distance(z), ba.growth_rate(z), c.get_thermodynamics().rs_drag, interp(k, z),
                fourier.sigma8_m, interp.to_xi()(s, z), hr.lensed_cl(), hr.unlensed_cl(), hr.lens_potential_cl())

    label = f'emulated (native-base layout) B={n}'
    named = {'set-up (Cosmology, EmulatedEngine, the inputs)': setup,
             'background (7 nets 64 x 8 and the section)': fresh('background'),
             'thermodynamics (5 nets 10 x 5)': fresh('thermodynamics'),
             'fourier nets (3 nets 64 x 5, 422 and 12 660 outputs)':
                 lambda: [eng._emulator.engines[name].predict(predictor.x) for name in entry['static']],
             'FourierNormOperation.inverse (per-row splines on (B, 30, 422))':
                 lambda: norm.inverse(dict(fixed), X=dict(predictor.cosmo_params)),
             "  of which its BBKS P(k / h) (torch.func.vmap over the rows)":
                 lambda: norm._prim(fixed['fourier.k'], fixed['fourier.z'], dict(predictor.cosmo_params)),
             'fourier section (nets, norm, tables)': fresh('fourier'),
             'pk_interpolator (2D spline build)': fo.pk_interpolator,
             'sigma8_m (TophatVariance, the FFTLog kernel)': lambda: pk.sigma_rz(8.0, 0.0),
             'to_xi (B x 30 rows, the FFTLog kernel, the xi spline build)': pk.to_xi,
             'harmonic (10 nets 64 x 6, 2501 outputs, and the section)': fresh('harmonic')}
    for name, fn in named.items():
        busy, _, _, launches, _ = profile_events(fn)
        print(f'stage, {label}: {name}: device {busy:.4f} ms in {launches} launches (torch.profiler), stream '
              f'{cuda_ms(fn):.4f} ms (CUDA events) on {card}', flush=True)
    release = os.path.join(directory, 'release')
    chip_smoke.cosmopower_release(release, rng, np.arange(2, chip_smoke.ELLMAX_EMU + 1))
    convert_cosmopower_release_to_cosmoprimo(release).write(os.path.join(directory, 'release.npy'))
    release_engine = EmulatedEngine.read(os.path.join(directory, 'release.npy'))
    release_values = {name: values[name] for name in ('logA', 'n_s', 'h', 'omega_b', 'omega_cdm', 'tau_reio')}

    def serve_release():
        c = Cosmology(engine=release_engine, ellmax_cl=chip_smoke.ELLMAX_EMU, **release_values)
        return c.get_harmonic().lensed_cl(), c.get_thermodynamics().rs_drag

    for title, fn in ((f'{label}, build and serve', serve),
                      (f'converted cosmopower v1 release (5 nets 4 x 512) B={n}, build and serve', serve_release)):
        wall = wall_ms(fn)
        busy, profiled, kinds, launches, top = profile_events(fn)
        print(f'profile, {title}: device busy {busy:.3f} ms in {launches} kernel launches ({kinds} kinds); wall '
              f'{wall:.3f} ms without the profiler (idle {1 - busy / wall:.1%}), {profiled:.3f} ms under it; on '
              f'{card}', flush=True)
        for name, ms, count in top:
            print(f'  {ms:9.3f} ms  x{count:<5d} {name}', flush=True)


def train_profile(card, rng=None):
    """Print the fits of chip_smoke's phase 23 by step, on synthetic data
    of their shapes: for each net, one Adam step at the first stage's
    batch (the recipes' first batch fraction), one validation on 10% of
    the rows, and one epoch (the steps and the validation loss read back,
    as ``MLPEmulatorEngine._fit_no_operation`` runs them) against its wall
    without the profiler: the host's gaps between the device's work."""
    from .emulators.mlp import MLP, init_mlp, make_adam, make_train_step, mse
    cases = (('fourier tables, 64 x 5 silu, 8 -> 12 660', 8, (64,) * 5, 'silu', 12660, 4096, 0.2),
             ('fourier reference spectrum, 64 x 5 silu, 8 -> 422', 8, (64,) * 5, 'silu', 422, 4096, 0.2),
             ('thermodynamics, 10 x 5 tanh, 5 -> 1', 5, (10,) * 5, 'tanh', 1, 256, 0.1))
    for label, nin, nhidden, activation, nout, n, bfrac in cases:
        X = torch.from_numpy(rng.uniform(size=(n, nin))).to(DEVICE)
        Y = torch.from_numpy(rng.normal(size=(n, nout))).to(DEVICE)
        nvalidation = int(0.1 * n + 0.5)
        ntrain = n - nvalidation
        batch = max(int(ntrain * bfrac + 0.5), 1)
        nbatch = max(ntrain // batch, 1)
        model = init_mlp(MLP(nin, nhidden + (nout,), (activation,) * len(nhidden), device=DEVICE),
                         torch.Generator().manual_seed(0))
        step = make_train_step(model, make_adam(model, 1e-3), 1e-3)
        X_val, Y_val = X[ntrain:], Y[ntrain:]

        def one_step():
            model.train()
            return step(X[:batch], Y[:batch])

        def validation():
            model.eval()
            with torch.no_grad():
                return mse(Y_val, model(X_val))

        def epoch():
            model.train()
            for ib in range(nbatch):
                step(X[ib * batch:(ib + 1) * batch], Y[ib * batch:(ib + 1) * batch])
            return float(validation())

        for name, fn in ((f'Adam step (batch {batch})', one_step), (f'validation ({nvalidation} rows)', validation)):
            busy, _, _, launches, _ = profile_events(fn)
            print(f'stage, train {label}: {name}: device {busy:.4f} ms in {launches} launches (torch.profiler), '
                  f'stream {cuda_ms(fn):.4f} ms (CUDA events) on {card}', flush=True)
        wall = wall_ms(epoch)
        busy, profiled, kinds, launches, top = profile_events(epoch)
        print(f'profile, train {label}: one epoch ({nbatch} steps of {batch} rows and the validation loss read '
              f'back): device busy {busy:.3f} ms in {launches} kernel launches ({kinds} kinds); wall {wall:.3f} ms '
              f'without the profiler (host gaps {wall - busy:.3f} ms, idle {1 - busy / wall:.1%}), {profiled:.3f} ms '
              f'under it; on {card}', flush=True)
        for name, ms, count in top:
            print(f'  {ms:9.3f} ms  x{count:<5d} {name}', flush=True)


def main(argv=()):
    names = set(argv) or {'halofit', 'HMcode', 'BAO', 'native', 'harmonic', 'emulated', 'train'}
    if not torch.cuda.is_available():
        print('stage_profile: torch.cuda is not available', file=sys.stderr)
        return 1
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f'card: {card}', flush=True)
    rng = np.random.default_rng(2)
    for label, non_linear, n, nk in SIZES:
        if label not in names:
            continue
        named, params = stages(non_linear, n, nk, rng)
        for name, fn in named.items():
            busy, _, _, launches, _ = profile_events(fn)
            print(f'stage, {label} B={n} nk={nk}: {name}: device {busy:.4f} ms in {launches} launches '
                  f'(torch.profiler), stream {cuda_ms(fn):.4f} ms (CUDA events) on {card}', flush=True)
        fn, _, _ = make_pk_to_xi_pipeline_batched(nk=nk, non_linear=non_linear)
        wall = wall_ms(lambda: fn(*params))
        busy, profiled, kinds, launches, top = profile_events(lambda: fn(*params))
        if busy == 0.0:
            print(f'profile, {label} pipeline: torch.profiler shows no device time', flush=True)
            continue
        print(f'profile, {label} pipeline B={n}: device busy {busy:.3f} ms in {launches} kernel launches '
              f'({kinds} kinds); wall {wall:.3f} ms without the profiler (idle {1 - busy / wall:.1%}), '
              f'{profiled:.3f} ms under it; on {card}', flush=True)
        for name, ms, count in top:
            print(f'  {ms:9.3f} ms  x{count:<5d} {name}', flush=True)
    if 'BAO' in names:
        n = 4096
        named, whole = bao_stages(n, rng)
        for name, fn in named.items():
            busy, _, _, launches, _ = profile_events(fn)
            print(f'stage, BAO template B={n} x {len(DESI_Z)} z: {name}: device {busy:.4f} ms in {launches} launches '
                  f'(torch.profiler), stream {cuda_ms(fn):.4f} ms (CUDA events) on {card}', flush=True)
        wall = wall_ms(whole)
        busy, profiled, kinds, launches, top = profile_events(whole)
        print(f'profile, BAO template (peakaverage and to_xi) B={n} x {len(DESI_Z)} z: device busy {busy:.3f} ms in '
              f'{launches} kernel launches ({kinds} kinds); wall {wall:.3f} ms without the profiler (idle '
              f'{1 - busy / wall:.1%}), {profiled:.3f} ms under it; on {card}', flush=True)
        for name, ms, count in top:
            print(f'  {ms:9.3f} ms  x{count:<5d} {name}', flush=True)
    if 'native' in names:
        native_profile(card, rng=rng)
    if 'harmonic' in names:
        harmonic_profile(card, rng=rng)
    if 'emulated' in names:
        emulated_profile(card, rng=rng)
    if 'train' in names:
        train_profile(card, rng=rng)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
