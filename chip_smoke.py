"""Smoke run of the PyTorch port on one CUDA card: python3 chip_smoke.py

Phases, each failing the run (non-zero exit) if its check fails:

1. card: needs torch.cuda; prints the card's name and power limit;
2. build: compiles the FFTLog core kernel (csrc/fftlog_core.cu) and the
   spline solve (csrc/spline_solve.cu) from the sources in this checkout,
   times the build, and fails if ptxas reports a spill in any of their
   template instantiations (one per padded length; the spline's factors and
   its 2 layouts x shared or per-row knots x values or given);
3. kernel against plain: the kernel against its plain torch.fft version on
   the card, forward and backward, bar max|d| / max|ref| <= 1e-12 in every
   row (the kernel packs two rows into one complex FFT, so a bar over the
   batch could hide one leaking into the other), at the TophatVariance
   (4096, 1024 -> 2048), headline PowerToCorrelation (40 000, 1024 -> 2048)
   and nparallel = 3 multipole shapes, odd row counts (4097 rows; 3 x 1001
   multipole rows), rows at a 1e8 scale ratio, a lowring=False
   PowerToCorrelation, the HMcode pipeline's PowerToCorrelation (4096,
   384 -> 1024), the sigma8 input path's TophatVariance on its 1e-7..1e2
   grid (4096, 1024 -> 2048), the BAO-template path's to_xi (PowerToCorrelation
   on 1e-7..1e2, 28 672 rows) and to_pk (CorrelationToPower on the s grid
   that to_xi returns, 4096 rows), HankelTransform (nu = 0, q = 0.5: q = 0
   is the pole of J_0's Mellin transform) and GaussianVariance on Gaussian
   rows (4096, 1024 -> 2048), and random data at every padded length
   64 ... 8192;
   then the analytic Gaussian P(k) -> xi(s) transform through the kernel;
   then forward mode (torch.func.jvp through the kernel's jvp rule against
   jvp through the plain version, per row, one launch for the primal and
   one for the tangent) at the headline, ell = (0, 2, 4), Hankel and
   Gaussian-variance shapes, and complex multipoles (ell = 0..3,
   complex=True: two launches, complex128) against the plain version, per
   row;
4. headline: the port's make_pk_to_xi_pipeline_batched at B = 40 000,
   nk = 1024, z = [0], float64 on the card; the kernel's launch count must
   grow, every output must be finite, and the first 32 rows must agree with
   the same pipeline on CPU tensors (xi per row 1e-10 of its max, chi and
   sigma8 rtol 1e-11);
5. halofit: the pipeline with non_linear='halofit' at B = 16 384,
   nk = 1024, z = [0], with the same checks as the headline and its wall
   time (median of 5 after a warm-up);
6. HMcode: non_linear='mead' at B = 4096, nk = 384, z = [0], the same
   checks and timing; and 'mead2020_feedback' at the same size, checked
   against the CPU on 32 rows;
7. sigma8 input: Cosmology(sigma8=..., omega_cdm=...) at B = 4096: its
   TophatVariance launches the kernel, sigma8_m returns the input at rtol
   1e-10, and P(k) on the first 32 rows agrees with the CPU at rtol 1e-11;
8. BAO template: B = 4096 cosmologies with one massive neutrino species
   (m_ncdm ~ U(0.06, 0.12) eV, N_eff = 3.044), EH98, nk = 1024, at the seven
   DESI DR1 effective redshifts, with the DESI fiducial: the traced
   PowerSpectrumBAOFilter's (peakaverage, bspline, ehpoly, hinton2017,
   savgol, ehsavgol), smooth_pk_interpolator().to_xi(), the kirkby2013
   CorrelationFunctionBAOFilter on the linear to_xi() and to_pk() of its
   smooth xi; the kernel's launch count must grow, every output must be
   finite, and the first 32 cosmologies must agree with the same path on
   CPU tensors (pknow rtol 1e-10, xi 1e-10 of each row's max, rs_drag and
   chi rtol 1e-11); its wall (one peakaverage filter and to_xi, median of
   5 after a warm-up); then the host filters wallish2018 and brieden2022 at
   B = 64, against the CPU at rtol 1e-10, with their walls;
9. times: the headline with fft_engine='kernel' and with 'torch', in turns,
   median of 5 each after a warm-up of each; the kernel against plain and
   against the library's FFT calls (torch.fft.rfft and irfft on the padded
   rows) at the headline, TophatVariance, to_xi and to_pk shapes, with CUDA
   events, 200 launches of each in two turns after warm-ups, beside each
   shape's bound (bytes over 3.35 TB/s against f64 operations over 34
   TFLOP/s, the larger), at the headline, TophatVariance, to_xi, to_pk,
   Hankel and Gaussian-variance shapes; the kernel's device time a launch
   from torch.profiler and the host's enqueue time a call; at the 4096-row
   shapes also with the L2 cache flushed before each launch; and the
   kernel's achieved device-memory rate at the headline shape
   (informational).

9b. the spline solve kernel at the DESI cell's shapes: shared knots over a
   (1024, 57 344) table of columns and over the filter's (57 344, 1024)
   rows through y.T, and 700 knots per row over 57 344 rows (each
   cosmology's knots shared by its 7 redshifts): one launch each, every
   system against the plain version on the card at 1e-12 of its max; the
   kernel's, the plain version's and torch.linalg.solve_ex's times (CUDA
   events, in turns) beside the bytes bound, and the kernel's device time;
   the kernels line's spline_solve entry is the case furthest from its
   bound;
10. native pipeline: make_native_pk_pipeline_batched(nk=256, kmax=1.0,
    z=(0, 1)) at B = 64 (B = 256 takes over 30 s a call: PERF.md), its
    three step loops replayed from CUDA graphs: finite outputs, the wall
    (median of 3 after the first call, which is the warm-up) and the peak
    memory;
11. native DESI: DESI(engine='native', nk_pk=128) on the card against the
    CLASS anchors (sigma8_m and sigma8_cb within 5e-3, P(k) in the BAO band
    at z = 0 and 1 within 1.2e-2, z_drag within 2.0, z_star_noreion within
    2.5, rs_drag within 1.5e-3, tau_reio within 1e-6 of its input); its
    sigma8 launches the FFTLog kernel;
12. native, card against CPU: the pipeline at kmax = 0.5 on 4 cosmologies,
    pk_m and sigma8 rtol 1e-9, the thermodynamics scalars rtol 1e-10; and
    the lane of the largest deviation, with its distance to each of the
    solver's switches and its time grids' card-against-CPU difference
    (printed only);
13. native, graphs against eager: the recombination scan and linear_pk on
    the cosmologies of 12 replayed from CUDA graphs and run eagerly on the
    card, x_e and pk_m within 1e-13; linear_pk on 256 k to 0.05 h/Mpc at
    768 + 384 steps (36 chunks of 32 steps), since the eager loops took
    ~70 s at the budget of 12;
14. the analytic engines at full width: make_pk_to_xi_pipeline_batched with
    engine='bbks' and 'eisenstein_hu_nowiggle_variants' at B = 40 000,
    nk = 1024, z = [0], one kernel launch each, checked as the headline;
15. the EH99 variants with one massive species (m_ncdm ~ U(0.06, 0.12) eV,
    N_eff = 3.044) at B = 4096, nk = 384, the seven DESI DR1 redshifts:
    pk_interpolator(non_linear='mead'), whose sigma(R) comes from the cold
    field (pk2d_cb), and 'halofit', then to_xi of each table on its default
    grid (1e-7 ... 1e2 h/Mpc) through the kernel (two launches); P(k) and xi
    against the CPU on 32 rows at 1e-10;
16. Cosmology.solve('h', 'theta_MC_100', target) at B = 4096, targets
    ~ U(1.035, 1.045): h against the CPU on 32 rows at rtol 1e-10, and
    |theta_MC_100 - target| <= |d theta / dh| xtol in every row (Ridders
    stops with the root inside a bracket narrower than xtol = 1e-6); the
    number of theta_MC_100 evaluations and the wall;
17. TabulatedDESI() and DistanceToRedshift on 10^7 redshifts ~ U(0.1, 3)
    drawn on the card: z -> chi -> z within 1e-6 (tests/test_utils.py), the
    table against DESI()'s closed-form background within 1e-4
    (tests/test_fiducial.py), and the card against the CPU on 32 entries.

18. the native CMB spectra: Cosmology(engine='native', ellmax_cl=2500,
    r=0.05) on B = 8 cosmologies, get_harmonic()'s unlensed_cl, lensed_cl
    and lens_potential_cl (lmax 2900 with the default lensing margin,
    tensors to l = 600), the first call and one more: shapes, finite, TT and
    BB > 0, the wall, the peak memory, each stage's wall (recombination,
    sources, projection, Limber, tensor sources and projection, lensing);
    then the card against the CPU on 2 cosmologies at ellmax_cl = 200,
    lensing_margin = 64 and the step budget (2048, 768, 2048), N_STEPS_T =
    2048: each spectrum within 1e-8 of its max, TE of its sqrt(TT EE);
19. DESI(engine='native').get_perturbations().table() at the default
    k_output_values (0.01, 0.1, 1.0) h/Mpc, the card against the CPU, each
    field within 1e-9 of its max;
20. the emitting loops (compute_los_sources, compute_perturbation_series,
    compute_tensor_sources) replayed from CUDA graphs against eager on the
    card, 4 cosmologies, 66 k to 0.05 /Mpc, n_steps = (768, 384, 2048) and
    N_STEPS_T = 2048: within 1e-13.

21. the emulator serving path: an emulator in the layout of the repo's
    'native-base' recipe (native_base_emulator_state: its quantity names,
    inputs, boxes, nets 64 x 8 silu with folded batch norm, 10 x 5 tanh,
    64 x 5 silu, 64 x 6 silu, the emulator-level FourierNormOperation and
    cl_norm, Cls to 2500; seeded weights), written to a temporary .npy,
    read back and served as Cosmology(engine=EmulatedEngine.read(path)) on
    B = 4096 cosmologies inside the recipe's boxes: distances and growth
    rate at the DESI DR1 redshifts, rs_drag, P(k), sigma8_m and to_xi()
    (the kernel: its launch count must grow), the lensed, unlensed and
    lens-potential Cls; finite; the first 32 rows against the CPU at 1e-10
    of each row's max; a sigma8= batch returns its input at rtol 1e-10;
    torch.func.jacfwd of lensed_cl()['tt'] in (logA, n_s, h, omega_b,
    omega_cdm, tau_reio) on 8 rows, the card against the CPU at 1e-9; the
    build-and-serve and harmonic-only walls (median of 5 after a warm-up)
    and the peak memory;
22. converted nets at their published widths: a synthetic cosmopower v1
    release (the bolliet2023 layout, TT, TE, EE, PP and derived networks of
    4 hidden layers x 512 units, its trainable activation, modes 2..2500)
    and a jaxcapse TT network, converted by the port's converters, served
    at B = 4096, the first 32 rows against the CPU at 1e-10, their walls.

23. training on the card (slice 6b), through the port's CLI
    (emulators/train/train_boltzmann.py) at the 'native-base' recipe:
    (a) ``--todo sample --section thermodynamics --stop 256`` on the native
    engine, the 256 points in one batch-first call: samples/s, and 8 of the
    points against the native engine on the CPU at 1e-10 of each value;
    (b) ``--todo fit`` with the recipe's schedule and ``--epochs 200``: the
    validation loss of every net falls; the file served through
    Cosmology(engine=EmulatedEngine.read(path)) at B = 4096, finite;
    (c) the fourier section at full width: 4096 samples through
    ``--engine eisenstein_hu_nowiggle_variants`` (the native engine at the
    recipe's k grid, to 1e2 h/Mpc, would not fit the time limit), the
    recipe's 64 x 5 silu nets on the 422-point reference spectrum and the
    422 x 30 tables behind its FourierNormOperation, ``--epochs 50``:
    steps/s, epochs/s, the wall of each stage and the peak memory; served
    at B = 4096 (P(k) and sigma8_m, the kernel), the first 32 rows against
    the CPU at 1e-10 of each row's max;
    (d) 20 Adam steps from one numpy-seeded initialization on the same
    batches, on the card and on the CPU: every parameter within 1e-9 of
    its tensor's max.

24. parallel fan-out (slice 6c): gloo worlds of 2 and of 2 x 2 ranks,
    spawned from this script (``--parallel-worker``), every rank on the one
    card (NCCL refuses two ranks on one device; gloo all-reduces and
    broadcasts CUDA tensors): the communicator's collectives and
    point-to-point; a QMC fan-out of 4096 points through a batch-first EH
    calculator on the card, equal to one process's samples; the headline
    (B = 40 000), halofit (16 384), HMcode (4096) and native (phase 12's
    4 cosmologies, kmax = 0.5) pipelines dp-sharded over 2 ranks, gathered,
    against the unsharded run on the card (xi 1e-10 of each row's max, chi
    and sigma8 1e-11; native 1e-9); the sharded MLP fit (4096 samples,
    64 x 3 silu with batch normalization) on meshes (2, 1), (1, 2) and
    (2, 2) against the unsharded fit at 1e-10 of each array's max, the same
    epochs; a rank's failure fails the run;
25. the wrapper engines (slice 6d): this script's own stub pyclass and camb
    modules (numpy tables from the port's EH engine on CPU tensors; no JAX),
    'class' (A_s and sigma8 inputs), 'axiclass', 'mochiclass', 'negnuclass',
    'dsclass', 'camb' (A_s and sigma8), 'isitgr', 'mgcamb', 'isitide' and
    'heftcamb': every section on the card (the Fourier tables' sigma(R) and
    xi through the kernel, its launches counted), held to the same engine
    on CPU tensors at 1e-12 of each output's max, no table left on the
    host;
26. the bindings: the cobaya theory (without cobaya: collectors,
    calculate, getters) and the cosmosis module (a stub datablock) through
    a cosmology on the card, numpy out, against the CPU at 1e-12.

27. the public API surface (slice 7): (a) PowerToCorrelation at the
    headline shape (40 000, 1024 -> 2048) and its inv(): the kernel against
    its plain version per row at 1e-12 on the forward and the inverted
    factors (of each row's max before the postfactor: the inverted one,
    k^-1.5, spans 21 decades of the padded grid); the round trip
    inv(fwd(P)) within 1e-4 of P for 1e-3 < k < 1 h/Mpc (the band of the
    CPU test, tests/test_torch_api_surface.py); the inverted transform,
    which ran on the card before inv(), equal to one inverted before its
    first call (inv() drops the factors made for the card) and to a fresh
    CorrelationToPower on the s grid at 1e-12 per row before the
    postfactor; (b) set_fft_engine('pallas') and 'fftw' launch the kernel,
    'numpy' runs the plain version, each against the 'torch' engine at
    1e-12 per row; (c) cosmoprimo_tpu_torch.quickstart on the card against
    the same run on the CPU, each output at its bar (quickstart.BARS: P(k),
    xi, the solved h 1e-10; distances and sigma8 1e-11); (d) loggamma and
    gamma of complex128 tensors on the card against scipy at 1e-12,
    gauss_legendre (tensor bounds on the card, and float bounds with an
    integrand that moves its nodes to the card) and odeint on the card
    against the CPU at 1e-13. Its wall is printed.

Each of phases 14-17 prints its wall (median of 5 after a warm-up). The
kernel's launches in the main-path runs of phases 4-8, 11, 14, 15, 18,
21, 23, 24 (both ranks), 25 and 27 are summed into the "kernels" line, and
the spline kernel's launches in the same runs (phase 11's with its P(k)
interpolator) into its entry there, each run's count printed; a run that
builds splines on the card fails if it launched no spline kernel (all of
them but phases 18, 24, 25 and 27's quickstart, whose counts are printed
only). Phases 10-13 and 18-21 each print how many of the streaming
phase's lanes (cosmology, k) of their native solver runs, on the card and
on the CPU, had the massive-neutrino fluid pinned on some step because the
step left its waves unresolved (perturbations._ncdm_unresolved). The last
line is {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

import contextlib
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

from cosmoprimo_tpu_torch.tracing import counters

B = 40000
NK = 1024
B_HALOFIT = 16384
B_HMCODE = 4096
NK_HMCODE = 384
B_SIGMA8 = 4096
N_COMPARE = 32
KERNEL_BAR = 1e-12
XI_BAR = 1e-10
CHI_SIGMA8_RTOL = 1e-11
SIGMA8_INPUT_RTOL = 1e-10
DEVICE = 'cuda'
HBM_TB_S = 3.35   # H100 SXM device memory, NVIDIA's data sheet
FP64_TFLOP_S = 34.0   # H100 SXM float64 outside the tensor cores, NVIDIA's data sheet
B_BAO = 4096
# the spline solve kernel's shapes in the DESI cell (8192 cosmologies x 7 z):
# the k grid, and the filter's knots per row (peaks and padding)
SPLINE_SYSTEMS = 57344
SPLINE_NK = 1024
SPLINE_ROW_KNOTS = 700
B_BAO_HOST = 64
DESI_Z = np.array([0.295, 0.51, 0.706, 0.93, 1.317, 1.491, 2.33])   # DESI DR1 effective redshifts
BAO_FILTERS = ('peakaverage', 'bspline', 'ehpoly', 'hinton2017', 'savgol', 'ehsavgol')
BAO_RTOL = 1e-10
K_FROM_XI = np.geomspace(1e-3, 1.0, 256)
# the native Boltzmann path: the full-width pipeline (B = 256 takes 31.0 s a
# call on an H100 80GB HBM3 at 700 W, above the 30 s a call allowed here, so
# 64: PERF.md), and the card against the CPU and graphs against eager on 4
B_NATIVE = 64
NK_NATIVE = 256
B_NATIVE_CHECK = 4
NATIVE_RTOL = 1e-9        # pk_m and sigma8, card against CPU
THERMO_RTOL = 1e-10       # thermodynamics scalars, card against CPU
GRAPH_RTOL = 1e-13        # graph replay against the eager loop, on the card
# its k grid and step budget: the loops stay finite there (not converged: a
# lane of P(k) moves by up to ~55% against the budget of kmax = 0.5); the
# check is of the replay
GRAPH_KMAX, GRAPH_N_STEPS = 0.05, (768, 384, 2048)
# CLASS v3.1.1 anchors of the DESI fiducial (the JAX package's
# tests/test_perturbations.py and test_thermodynamics.py): P(k) in (Mpc/h)^3
# at k in h/Mpc, the BAO band k <= 0.21
K_H = np.array([1e-3, 3e-3, 1e-2, 0.03, 0.05, 0.1, 0.15, 0.2, 0.3, 0.5])
PK_M_Z0 = np.array([3784.8365994, 10006.0275874, 21679.8515778, 19385.944493, 12126.510581,
                    5397.8832812, 3093.3731677, 1932.5470914, 870.0262655, 310.6450734])
PK_M_Z1 = np.array([1393.0124627, 3683.7396485, 7984.9843905, 7146.3873148, 4472.2818496,
                    1991.6801977, 1141.5762539, 713.2474431, 321.1272727, 114.665446])
BAO_BAND = K_H <= 0.21
SIGMA8_M_CLASS, SIGMA8_CB_CLASS = 0.807952, 0.811355
Z_DRAG_PLANCK, Z_STAR_PLANCK = 1059.94, 1089.92
RS_DRAG_CLASS = 1.470933e2 * 0.6736   # Mpc/h
# slice 4b: the analytic engines at full width, the batched solve and the
# mock-catalogue distance inversion
ANALYTIC_ENGINES = ('bbks', 'eisenstein_hu_nowiggle_variants')
B_VARIANTS = 4096
B_SOLVE = 4096
SOLVE_XTOL = 1e-6          # Cosmology.solve's default for h
SOLVE_RTOL = 1e-10         # h, card against CPU
N_MOCK = 10 ** 7
ROUND_TRIP_RTOL = 1e-6     # z -> chi -> z, tests/test_utils.py
TABULATED_RTOL = 1e-4      # TabulatedDESI against DESI()'s closed form, tests/test_fiducial.py
TIMED_LAUNCHES = 100       # per turn; two turns of each
# slice 5b: the native CMB spectra at full width (ellmax_cl = 2500 and the
# default lensing margin of 400: lmax 2900; tensors to l = 600), checked
# against the CPU at a cut size and step budget, the Perturbations table of
# the DESI fiducial, and the emitting loops replayed from graphs against eager
B_CL = 8
ELLMAX_CL = 2500
R_CL = 0.05
CL_CHECK = dict(rows=2, ellmax=200, extra={'lensing_margin': 64}, n_steps=(2048, 768, 2048), n_steps_t=2048)
CL_RTOL = 1e-8             # each spectrum's max (TE: its sqrt(TT EE) envelope), card against CPU
SERIES_RTOL = 1e-9         # each field's max, card against CPU
EMIT_GRAPH = dict(rows=4, kmax=0.05, n_steps=(768, 384, 2048), n_steps_t=2048)
# slice 6a: the emulator serving path. Phase 21 serves an emulator in the
# layout that the repo's 'native-base' recipe trains
# (cosmoprimo_tpu/emulators/train/recipes.py:230-275): its quantity names,
# inputs, boxes, widths and operation chains, the weights drawn from a seed;
# phase 22 two converted foreign nets at their published widths
B_EMU = 4096
ELLMAX_EMU = 2500
EMU_RTOL = 1e-10           # tables, Cls and sigma8 input, card against CPU
EMU_JAC_ROWS = 8
EMU_JAC_RTOL = 1e-9        # jacfwd of lensed_cl()['tt'], card against CPU
NATIVE_BASE = {'logA': (2.8, 3.3), 'n_s': (0.88, 1.06), 'h': (0.55, 0.82), 'omega_b': (0.019, 0.026),
               'omega_cdm': (0.08, 0.20)}
NATIVE_BASE_SECTIONS = {
    # (inputs and their boxes, hidden widths, activation, batch norm); the
    # background inputs after the recipe's omega_to_Omega_m
    'background': ({'h': (0.5, 0.9), 'm_ncdm': (0.0, 1.0), 'w0_fld': (-2.0, -0.3), 'wa_fld': (-2.0, 1.5),
                    'Omega_m': ((0.05 + 0.015) / 0.9 ** 2, (0.30 + 0.035) / 0.5 ** 2)}, (64,) * 8, 'silu', True),
    'thermodynamics': ({'h': (0.5, 0.9), 'omega_cdm': (0.05, 0.30), 'omega_b': (0.015, 0.035), 'm_ncdm': (0.0, 1.0),
                        'tau_reio': (0.02, 0.13)}, (10,) * 5, 'tanh', False),
    'fourier': ({**NATIVE_BASE, 'm_ncdm': (0.0, 0.6), 'w0_fld': (-1.5, -0.5), 'wa_fld': (-1.5, 1.0)}, (64,) * 5,
                'silu', False),
    'harmonic': ({**NATIVE_BASE, 'm_ncdm': (0.0, 0.6), 'tau_reio': (0.02, 0.12)}, (64,) * 6, 'silu', False),
}
# slice 6b: training on the card, phase 23
N_TRAIN_THERMO = 256
TRAIN_CHECK = 8
TRAIN_RTOL = 1e-10         # native thermodynamics samples, card against CPU
THERMO_EPOCHS = 200
N_TRAIN_FOURIER = 4096
FOURIER_EPOCHS = 50
ADAM_STEPS = 20
ADAM_RTOL = 1e-9           # parameters after ADAM_STEPS, card against CPU
CL_NORM = ("v / jnp.exp(X['logA'] - 3.) / jnp.exp(-2 * X['tau_reio'])",
           "v * jnp.exp(X['logA'] - 3.) * jnp.exp(-2 * X['tau_reio'])")
# slices 6c-6d: phase 24's gloo worlds, phase 25's wrapper engines and phase
# 26's bindings
N_QMC = 4096               # QMC points of the fan-out, one chunk a rank
N_FIT = 4096               # samples of the sharded MLP fit
FIT_SCHEDULE = dict(batch_frac=(0.1, 0.5), epochs=(20, 10), learning_rate=(1e-2, 1e-3), patience=(20, 3), seed=3)
FIT_RTOL = 1e-10           # sharded fit against the unsharded fit, each array's max
WRAPPER_RTOL = 1e-12       # wrapper engines and bindings, card against CPU
PARALLEL_TIMEOUT = 300     # s, a world's processes are killed after it
# slice 7: phase 27, the public API surface
# k in h/Mpc where inv(fwd(P)) gives P back on the headline grid, and the bar
# there (tests/test_torch_api_surface.py::test_inv_round_trip_headline_grid)
INV_BAND = (1e-3, 1.0)
INV_RTOL = 1e-4
SPECIAL_RTOL = 1e-12       # loggamma and gamma on the card against scipy
OPS_RTOL = 1e-13           # gauss_legendre and odeint, card against CPU


def _band(fiducial, rel=0.05, add=0.0):
    """Scale limits around a fiducial table (its NaN beyond the range of a
    background table filled with its last finite value): the nets' O(1)
    outputs land within a few percent of it, and a positive table stays
    positive."""
    fiducial = np.array(fiducial, dtype=np.float64)
    if fiducial.ndim:
        last = np.where(np.isfinite(fiducial), np.arange(fiducial.shape[-1]), 0)
        fiducial = np.take_along_axis(fiducial, np.maximum.accumulate(last, axis=-1), axis=-1)
    half = rel * np.abs(fiducial) + add
    return [fiducial - half, fiducial + half]


def mlp_weights(rng, sizes, activation, batch_norm):
    """Weights of a dense network of layer ``sizes`` in the layout the MLP
    engine exports (per layer 'layer_{i}' {'kernel', 'bias'}, 'batch_{i}'
    and its statistics, 'alpha_{i}' and 'beta_{i}' of 'identity-silu'):
    from ``rng``, the kernels scaled by 1/sqrt(fan_in)."""
    weights, stats = {}, {}
    for i in range(len(sizes) - 1):
        weights[f'layer_{i}'] = {'kernel': rng.standard_normal((sizes[i], sizes[i + 1])) / np.sqrt(sizes[i]),
                                 'bias': 0.1 * rng.standard_normal(sizes[i + 1])}
        if batch_norm and i > 0:
            weights[f'batch_{i}'] = {'scale': 1.0 + 0.1 * rng.standard_normal(sizes[i]),
                                     'bias': 0.1 * rng.standard_normal(sizes[i])}
            stats[f'batch_{i}'] = {'mean': 0.1 * rng.standard_normal(sizes[i]),
                                   'var': 1.0 + 0.1 * rng.random(sizes[i])}
        if activation == 'identity-silu' and i < len(sizes) - 2:
            weights[f'alpha_{i}'], weights[f'beta_{i}'] = rng.standard_normal(), rng.standard_normal()
    return weights, stats


def mlp_engine_state(rng, params, nhidden, activation, yshape, ylimits, yoperations=(), batch_norm=False):
    """The state of an MLP engine (the JAX package's schema, numpy): x and y
    Scale operations on the given boxes and limits, ``yoperations`` before
    the y Scale, and a dense network of hidden widths ``nhidden`` with
    weights from ``rng`` scaled by 1/sqrt(fan_in) (batch normalization
    folded into its affine operation)."""
    from cosmoprimo_tpu_torch.emulators.mlp import MLPEmulatorEngine
    from cosmoprimo_tpu_torch.emulators.operations import Operation, ScaleOperation
    engine = MLPEmulatorEngine(nhidden=nhidden, activation=activation,
                               yoperation=[Operation(*op) if isinstance(op, tuple) else op for op in yoperations])
    engine.params, engine.xshape, engine.yshape = list(params), (len(params),), tuple(yshape)
    xscale = ScaleOperation(limits=[np.array([box[0] for box in params.values()]),
                                    np.array([box[1] for box in params.values()])])
    xscale.initialize(np.zeros((1, len(params))))
    yscale = ScaleOperation(limits=ylimits)
    yscale.initialize(np.zeros((1,) + tuple(yshape)))
    engine.xoperations, engine.yoperations[-1] = [xscale], yscale
    weights, stats = mlp_weights(rng, [len(params)] + list(nhidden) + [int(np.prod(yshape))], activation,
                                 batch_norm)
    engine.batch_norm = batch_norm
    engine.model_operations = engine._export_operations(weights, stats)
    return engine.__getstate__()


def native_base_emulator_state(seed=0, width=1, ellmax_cl=ELLMAX_EMU):
    """An emulator state (the JAX package's schema, numpy) in the layout of
    the 'native-base' recipe: the background, thermodynamics, fourier and
    harmonic quantities that its sampler draws from the native engine (the
    emulated sections' states), each section's inputs, boxes, widths
    (divided by ``width``) and operation chains, the fourier tables behind
    the emulator-level FourierNormOperation, the Cls behind cl_norm, at
    ``ellmax_cl``. Weights from ``np.random.default_rng(seed)``; the y
    limits bracket smooth fiducial tables, so that the served quantities
    are positive where they must be (the P(k) tables)."""
    import torch
    from cosmoprimo_tpu_torch import Cosmology
    from cosmoprimo_tpu_torch.cosmology import DefaultBackground
    from cosmoprimo_tpu_torch.emulators import FourierNormOperation
    from cosmoprimo_tpu_torch.emulators.emulated import Background, get_default_k_callable, get_default_z_callable
    rng = np.random.default_rng(seed)
    fiducial = Cosmology(engine='eisenstein_hu', h=0.68, omega_cdm=0.12, omega_b=0.022, m_ncdm=0.06, w0_fld=-0.9,
                         wa_fld=0.1, device='cpu')
    engines, fixed = {}, {}

    def add(section, name, yshape, ylimits, yoperations=()):
        params, nhidden, activation, batch_norm = NATIVE_BASE_SECTIONS[section]
        engines[f'{section}.{name}'] = mlp_engine_state(rng, params, tuple(n // width for n in nhidden), activation,
                                                        yshape, ylimits, yoperations, batch_norm)

    background = Background.__getstate__(DefaultBackground(fiducial.engine))
    fixed['background.z'] = np.asarray(background.pop('z'))
    for name, table in background.items():
        add('background', name, table.shape, _band(table.numpy()))
    for name, value in {'rs_drag': 100.0, 'z_drag': 1060.0, 'rs_star': 98.0, 'z_star': 1090.0,
                        'YHe': 0.245}.items():
        add('thermodynamics', name, (), _band(value, rel=0.01))
    k, z = get_default_k_callable(), get_default_z_callable()
    fixed['fourier.k'], fixed['fourier.z'] = k, z
    growth = fiducial.get_background().growth_factor(torch.from_numpy(z)).numpy()
    log_pkz = np.broadcast_to(2 * np.log10(growth / growth[0]), (k.size, z.size))
    add('fourier', 'pk.delta_cb.delta_cb', (k.size,), _band(np.ones(k.size)))
    add('fourier', 'pk.delta_m.delta_m', (k.size, z.size), _band(np.zeros((k.size, z.size)), add=0.005), ['log10'])
    add('fourier', 'pkz', (k.size, z.size), _band(log_pkz, rel=0.0, add=0.02), ['log10'])
    ell = np.arange(ellmax_cl + 1)
    shape = np.where(ell >= 2, 2 * np.pi / np.maximum(ell * (ell + 1), 1) * 2e-10 / (1 + (ell / 1500.) ** 2), 0.0)
    cls = {'unlensed_cl.tt': shape, 'unlensed_cl.ee': 0.02 * shape, 'unlensed_cl.te': 0.1 * shape,
           'lensed_cl.tt': shape, 'lensed_cl.ee': 0.02 * shape, 'lensed_cl.bb': 1e-4 * shape,
           'lensed_cl.te': 0.1 * shape, 'lens_potential_cl.pp': 1e-7 * shape / np.maximum(ell, 1) ** 2,
           'lens_potential_cl.tp': 1e-4 * shape / np.maximum(ell, 1), 'lens_potential_cl.ep': 1e-6 * shape}
    for name, table in cls.items():
        add('harmonic', name, table.shape, _band(table), [CL_NORM])
    fixed['harmonic.unlensed_cl.bb'] = np.zeros(ellmax_cl + 1)   # r = 0: no tensor BB before lensing
    norm = FourierNormOperation()
    norm.norm_pk_names = ['fourier.pk.delta_m.delta_m']
    return {'engines': engines, 'xoperations': [], 'yoperations': [norm.__getstate__()], 'defaults': {},
            'fixed': fixed}


def check(ok, message):
    if not ok:
        raise RuntimeError(message)


# the spline kernel's launches in each main-path run, by path: summed into the
# kernels line's spline_solve entry
SPLINE_LAUNCHES = {}


@contextlib.contextmanager
def ncdm_pins(label):
    """Count, over the block, the streaming-phase lanes of the native
    solver's runs whose massive-neutrino fluid was pinned on some step
    (perturbations._ncdm_unresolved), by device, and print them. Each run's
    flags are or-ed in place into a tensor of its lanes, made at the run's
    first (eager) call, so that replays of a captured loop add theirs."""
    from cosmoprimo_tpu_torch.boltzmann import perturbations as P
    unresolved, runs = P._ncdm_unresolved, {}

    def counted(c, lanes, steps):
        flag = unresolved(c, lanes, steps)
        if steps is not None:
            if id(lanes) not in runs:
                runs[id(lanes)] = (lanes, torch.zeros(flag.shape[-2:], dtype=torch.bool, device=flag.device))
            runs[id(lanes)][1].logical_or_(flag.reshape((-1,) + flag.shape[-2:]).any(0))
        return flag

    P._ncdm_unresolved = counted
    try:
        yield
    finally:
        P._ncdm_unresolved = unresolved
    by_device = {}
    for _, pinned in runs.values():
        n = by_device.setdefault(pinned.device.type, [0, 0, 0])
        n[0] += int(pinned.sum())
        n[1] += pinned.numel()
        n[2] += 1
    print(f'phase {label}: massive-neutrino fluid pinned in ' + ('; '.join(
        f'{n[0]} of {n[1]} streaming-phase lanes ({n[2]} solver run{"s" if n[2] > 1 else ""}) on the {dev}' for dev, n in by_device.items())
        or 'no streaming-phase run'), flush=True)


def main_run_start():
    """Set both kernels' launch counters to 0 before a main-path run."""
    counters['fftlog.launches'] = counters['spline.launches'] = 0


def note_splines(label, required=True):
    """Keep the spline kernel's launches since main_run_start() as those of
    the main-path run ``label``; fail if ``required`` (the path builds
    splines of 4 knots or more on the card) and it launched none."""
    SPLINE_LAUNCHES[label] = counters['spline.launches']
    check(not required or SPLINE_LAUNCHES[label] > 0, f'{label} did not launch the spline kernel')
    return SPLINE_LAUNCHES[label]


def rel_err(got, ref):
    """max|got - ref| / max|ref| over each row, the worst row."""
    return ((got - ref).abs().amax(dim=-1) / ref.abs().amax(dim=-1)).max().item()


def pk_like(k, amplitude, tilt):
    """Smooth power-law-ish spectra, one row per (amplitude, tilt)."""
    return amplitude[:, None] * 1e4 * (k / 0.1) ** tilt[:, None] / (1 + (k / 0.1) ** 3)


def gauss_like(k, amplitude, width):
    """Gaussian rows, one per (amplitude, width): their Hankel transforms
    and Gaussian variances are of order one."""
    return amplitude[:, None] * torch.exp(-(k / width[:, None]) ** 2 / 2)


def cuda_ms(fn, reps=20):
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cold_ms(fn, reps=2 * TIMED_LAUNCHES):
    """Mean CUDA-event time of one call of ``fn`` with the L2 cache flushed
    before each (a 256 MB write outside the timed span)."""
    flush = torch.empty(32 * 2 ** 20, dtype=torch.float64, device=DEVICE)
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    fn()
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in events) / reps


def device_ms(fn, reps=2 * TIMED_LAUNCHES):
    """Device time of one call of ``fn`` from torch.profiler, the mean over
    ``reps`` back-to-back calls: the kernels' own time, without the gaps
    between launches; None if the profiler shows no device time. Also the
    host's time to enqueue one call (ms)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host = (time.perf_counter() - t0) * 1e3 / reps
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return (busy / reps if busy else None), host


def wall_ms(fn, reps=5, warmup=True):
    """Median host wall time of ``fn`` ending in a synchronize, after a
    warm-up call (``warmup=False``: the caller has just made one)."""
    if warmup:
        fn()
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls)) * 1e3


def cosmo_params(rng, n):
    """(omega_cdm, omega_b, h, n_s, logA) drawn as bench.py draws them."""
    return (rng.uniform(0.11, 0.13, n), rng.uniform(0.021, 0.023, n), rng.uniform(0.65, 0.70, n),
            rng.uniform(0.94, 0.98, n), rng.uniform(2.9, 3.1, n))


def run_pipeline(label, fn, params, nk, fftlog_kernel, card, timed=True):
    """Drive a pipeline once on the card with the kernel's launch count set
    to 0, check its outputs and its first N_COMPARE rows against the same
    pipeline on CPU tensors, and time it; returns the launches."""
    n = len(params[0])
    params_dev = [torch.from_numpy(p).to(DEVICE) for p in params]
    torch.cuda.reset_peak_memory_stats()
    main_run_start()
    xi, chi, sigma8 = fn(*params_dev)
    torch.cuda.synchronize()
    launches = counters['fftlog.launches']
    splines = note_splines(label)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f'{label}: B={n}, nk={nk}, xi {tuple(xi.shape)}, chi {tuple(chi.shape)}, sigma8 {tuple(sigma8.shape)}, '
          f'kernel launches {launches}, spline kernel launches {splines}, peak memory {peak_gb:.2f} GB', flush=True)
    check(launches > 0, f'{label} did not launch the FFTLog kernel')
    check(tuple(xi.shape) == (n, 1, nk) and tuple(chi.shape) == (n, 3) and tuple(sigma8.shape) == (n,),
          f'{label} output shapes are wrong')
    check(all(bool(torch.isfinite(t).all()) for t in (xi, chi, sigma8)), f'{label} outputs are not all finite')
    xi_cpu, chi_cpu, sigma8_cpu = fn(*[torch.from_numpy(p[:N_COMPARE]) for p in params])
    xi_dev = xi[:N_COMPARE].cpu()
    xi_err = ((xi_dev - xi_cpu).abs().amax(dim=-1) / xi_cpu.abs().amax(dim=-1)).max().item()
    chi_err = (chi[:N_COMPARE].cpu() / chi_cpu - 1).abs().max().item()
    sigma8_err = (sigma8[:N_COMPARE].cpu() / sigma8_cpu - 1).abs().max().item()
    print(f'{label}, card vs CPU, first {N_COMPARE} rows: xi {xi_err:.3e} (bar {XI_BAR:g}), chi {chi_err:.3e}, '
          f'sigma8 {sigma8_err:.3e} (bar {CHI_SIGMA8_RTOL:g}); sigma8 range [{sigma8.min().item():.4f}, '
          f'{sigma8.max().item():.4f}]', flush=True)
    check(xi_err <= XI_BAR and chi_err <= CHI_SIGMA8_RTOL and sigma8_err <= CHI_SIGMA8_RTOL,
          f'card and CPU disagree on {label}')
    if timed:
        wall = wall_ms(lambda: fn(*params_dev))
        print(f'{label} wall: {wall:.3f} ms per batch of {n} (median of 5 after a warm-up), '
              f'{n / wall * 1e3:.1f} cosmologies/s on {card}', flush=True)
    return launches


def forward_mode_and_complex(fftlog_kernel, transform_case, k, PowerToCorrelation, more_jvp_cases):
    """Phase 3, second part: jvp and complex multipoles through the kernel
    against the plain version, jvp also on ``more_jvp_cases`` (label,
    transform, rows, input profile); returns the largest absolute
    difference."""
    max_abs_err = 0.0
    lnk = torch.log(torch.from_numpy(k).to(DEVICE) / 0.1)
    cases = ((f'PowerToCorrelation ({B}, 1024 -> 2048)', PowerToCorrelation(k), B, pk_like),
             ('PowerToCorrelation ell=(0, 2, 4) (3 x 1000, 1024 -> 2048)', PowerToCorrelation(k, ell=[0, 2, 4]), 3000,
              pk_like)) + tuple(more_jvp_cases)
    for label, transform, rows, profile in cases:
        x, args = transform_case(transform, rows, profile=profile)
        tangent = x * lnk                                  # d x / d tilt: smooth
        counters['fftlog.launches'] = 0
        out, jvp = torch.func.jvp(lambda f: fftlog_kernel.fftlog_core(f, *args), (x,), (tangent,))
        torch.cuda.synchronize()
        launches = counters['fftlog.launches']
        check(launches == 2, f'jvp at {label} took {launches} launches, not one for the primal and one for the tangent')
        out_ref, jvp_ref = torch.func.jvp(lambda f: fftlog_kernel.fftlog_core_torch(f, *args), (x,), (tangent,))
        torch.cuda.synchronize()
        fwd, tan = rel_err(out, out_ref), rel_err(jvp, jvp_ref)
        max_abs_err = max(max_abs_err, (out - out_ref).abs().max().item(), (jvp - jvp_ref).abs().max().item())
        print(f'forward mode through the kernel, {label}: primal {fwd:.3e}, tangent {tan:.3e} per row '
              f'(bar {KERNEL_BAR:g}), {launches} launches', flush=True)
        check(fwd <= KERNEL_BAR and tan <= KERNEL_BAR, f'kernel jvp disagrees with plain at {label}')

    x, _ = transform_case(PowerToCorrelation(k), 4000)
    x = x.reshape(1000, 4, NK)
    ells = [0, 1, 2, 3]
    counters['fftlog.launches'] = 0
    _, got = PowerToCorrelation(k, ell=ells, complex=True)(x)
    torch.cuda.synchronize()
    launches = counters['fftlog.launches']
    _, ref = PowerToCorrelation(k, ell=ells, complex=True, engine='torch')(x)
    err = rel_err(got, ref)
    max_abs_err = max(max_abs_err, (got - ref).abs().max().item())
    print(f'complex multipoles ell=(0, 1, 2, 3) (1000 x 4, 1024 -> 2048): {got.dtype}, {launches} launches, '
          f'{err:.3e} per row against plain (bar {KERNEL_BAR:g})', flush=True)
    check(launches == 2 and got.dtype == torch.complex128, 'complex multipoles did not run the kernel twice')
    check(err <= KERNEL_BAR, 'complex multipoles disagree with plain')
    return max_abs_err


def sigma8_input(fftlog_kernel, Cosmology, rng, card):
    """Phase 7: Cosmology(sigma8=...) on the card; returns the launches."""
    s8, omega_cdm = rng.uniform(0.75, 0.85, B_SIGMA8), rng.uniform(0.11, 0.13, B_SIGMA8)
    kq, zq = np.geomspace(1e-4, 10.0, 64), np.array([0.0, 1.0])

    def run(device, rows):
        cosmo = Cosmology(sigma8=torch.from_numpy(s8[rows]).to(device),
                          omega_cdm=torch.from_numpy(omega_cdm[rows]).to(device), engine='eisenstein_hu')
        fo = cosmo.get_fourier()
        return fo.sigma8_m, fo.pk_interpolator()(torch.from_numpy(kq).to(device), torch.from_numpy(zq).to(device))

    main_run_start()
    sigma8_m, pk = run(DEVICE, slice(None))
    torch.cuda.synchronize()
    launches = counters['fftlog.launches']
    splines = note_splines('sigma8 input')
    s8_err = np.abs(sigma8_m.cpu().numpy() / s8 - 1).max()
    _, pk_cpu = run('cpu', slice(N_COMPARE))
    pk_err = (pk[:N_COMPARE].cpu() / pk_cpu - 1).abs().max().item()
    print(f'sigma8 input: B={B_SIGMA8}, kernel launches {launches}, spline kernel launches {splines}, '
          f'sigma8_m against the input {s8_err:.3e} '
          f'(bar {SIGMA8_INPUT_RTOL:g}), P(k) card vs CPU on {N_COMPARE} rows {pk_err:.3e} '
          f'(bar {CHI_SIGMA8_RTOL:g})', flush=True)
    check(launches > 0, 'the sigma8 input path did not launch the FFTLog kernel')
    check(bool(torch.isfinite(pk).all()), 'sigma8 input P(k) is not finite')
    check(s8_err <= SIGMA8_INPUT_RTOL and pk_err <= CHI_SIGMA8_RTOL, 'sigma8 input path is wrong')
    wall = wall_ms(lambda: run(DEVICE, slice(None)))
    print(f'sigma8 input wall: {wall:.3f} ms per batch of {B_SIGMA8} (Cosmology, sigma8_m and P(k); median of 5) '
          f'on {card}', flush=True)
    return launches


def bao_template(fftlog_kernel, rng, card):
    """Phase 8: the BAO-template path at full width; returns the launches."""
    from cosmoprimo_tpu_torch import Cosmology
    from cosmoprimo_tpu_torch.bao_filter import CorrelationFunctionBAOFilter, PowerSpectrumBAOFilter
    from cosmoprimo_tpu_torch.fiducial import DESI
    params = cosmo_params(rng, B_BAO) + (rng.uniform(0.06, 0.12, B_BAO),)

    def cosmology(device, rows):
        omega_cdm, omega_b, h, n_s, logA, m_ncdm = (torch.from_numpy(p[rows]).to(device) for p in params)
        cosmo = Cosmology(engine='eisenstein_hu', omega_cdm=omega_cdm, omega_b=omega_b, h=h, n_s=n_s, logA=logA,
                          m_ncdm=[m_ncdm], N_eff=3.044)
        return cosmo, DESI(engine='eisenstein_hu', device=device), cosmo.get_fourier().pk_interpolator(z=DESI_Z)

    def run(device, rows, filters=BAO_FILTERS):
        cosmo, fid, pk = cosmology(device, rows)
        out = {}
        for name in filters:
            filt = PowerSpectrumBAOFilter(pk, engine=name, cosmo=cosmo, cosmo_fid=fid)
            out[name] = filt.pknow
            if name == filters[0]:
                out['xi_smooth'] = filt.smooth_pk_interpolator().to_xi().xi
        xi_filter = CorrelationFunctionBAOFilter(pk.to_xi(), engine='kirkby2013', cosmo=cosmo, cosmo_fid=fid)
        out['xinow'] = xi_filter.xinow
        # where P(k) is more than FFTLog's ringing at the ends of the transform
        out['pk_from_xi'] = xi_filter.smooth_pk_interpolator()(torch.from_numpy(K_FROM_XI).to(device),
                                                               torch.from_numpy(DESI_Z).to(device))
        out['rs_drag'] = cosmo.rs_drag
        out['chi'] = cosmo.comoving_radial_distance(torch.from_numpy(DESI_Z).to(device))
        return out

    def compare(got, ref, label):
        errs = {}
        for name, value in ref.items():
            value_dev = got[name][:value.shape[0]].cpu()
            if name in ('xi_smooth', 'xinow', 'pk_from_xi'):   # 1e-10 of each (cosmology, z) row's max
                errs[name] = ((value_dev - value).abs().amax(dim=-2) / value.abs().amax(dim=-2)).max().item()
            else:
                errs[name] = (value_dev / value - 1).abs().max().item()
        bars = {name: CHI_SIGMA8_RTOL if name in ('rs_drag', 'chi') else BAO_RTOL for name in errs}
        print(f'{label}, card vs CPU, first {N_COMPARE} cosmologies: '
              + ', '.join(f'{name} {err:.3e}' for name, err in errs.items())
              + f' (bars: rs_drag and chi {CHI_SIGMA8_RTOL:g}, the others {BAO_RTOL:g})', flush=True)
        check(all(errs[name] <= bars[name] for name in errs), f'card and CPU disagree on {label}')

    torch.cuda.reset_peak_memory_stats()
    main_run_start()
    out = run(DEVICE, slice(None))
    torch.cuda.synchronize()
    launches = counters['fftlog.launches']
    spline_launches = note_splines('BAO template')
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f'BAO template: B={B_BAO} x {DESI_Z.size} z, nk=1024, pknow {tuple(out["ehpoly"].shape)}, '
          f'xi {tuple(out["xi_smooth"].shape)}, kernel launches {launches}, spline kernel launches {spline_launches}, '
          f'peak memory {peak_gb:.2f} GB', flush=True)
    check(launches > 0, 'the BAO-template path did not launch the FFTLog kernel')
    check(all(tuple(out[name].shape) == (B_BAO, 1024, DESI_Z.size) for name in BAO_FILTERS + ('xi_smooth', 'xinow')),
          'BAO-template output shapes are wrong')
    check(all(bool(torch.isfinite(value).all()) for value in out.values()), 'BAO-template outputs are not all finite')
    compare(out, run('cpu', slice(N_COMPARE)), 'BAO template')

    cosmo, fid, pk = cosmology(DEVICE, slice(None))
    wall = wall_ms(lambda: PowerSpectrumBAOFilter(pk, engine='peakaverage', cosmo=cosmo, cosmo_fid=fid)
                   .smooth_pk_interpolator().to_xi())
    print(f'BAO template wall: {wall:.3f} ms per batch of {B_BAO} x {DESI_Z.size} z (peakaverage filter and to_xi, '
          f'median of 5 after a warm-up) on {card}', flush=True)

    # the host filters, as in the JAX package, on a smaller batch
    host = slice(B_BAO_HOST)
    for name in ('wallish2018', 'brieden2022'):
        cosmo, fid, pk = cosmology(DEVICE, host)
        got = PowerSpectrumBAOFilter(pk, engine=name, cosmo=cosmo, cosmo_fid=fid).pknow
        check(got.device.type == DEVICE and bool(torch.isfinite(got).all()), f'{name} on the card is wrong')
        cosmo, fid, pk = cosmology('cpu', host)
        err = (got.cpu() / PowerSpectrumBAOFilter(pk, engine=name, cosmo=cosmo, cosmo_fid=fid).pknow - 1).abs().max().item()
        cosmo, fid, pk = cosmology(DEVICE, host)
        wall = wall_ms(lambda: PowerSpectrumBAOFilter(pk, engine=name, cosmo=cosmo, cosmo_fid=fid), reps=3)
        print(f'{name} (host): B={B_BAO_HOST} x {DESI_Z.size} z, card vs CPU {err:.3e} (bar {BAO_RTOL:g}), wall '
              f'{wall:.3f} ms (median of 3 after a warm-up) on {card}', flush=True)
        check(err <= BAO_RTOL, f'{name} on the card and the CPU disagree')
    return launches


def native_path(fftlog_kernel, rng, card):
    """Phases 10-13: the native Boltzmann path. Returns the FFTLog kernel's
    launches in its main-path runs (the DESI engine's sigma8)."""
    from cosmoprimo_tpu_torch import Cosmology, make_native_pk_pipeline_batched
    from cosmoprimo_tpu_torch.boltzmann import compute_thermodynamics
    from cosmoprimo_tpu_torch.boltzmann.perturbations import linear_pk
    from cosmoprimo_tpu_torch.fiducial import DESI

    # 10. the full-width pipeline
    params = cosmo_params(rng, B_NATIVE)
    params_dev = [torch.from_numpy(p).to(DEVICE) for p in params]
    fn, _ = make_native_pk_pipeline_batched(nk=NK_NATIVE, kmax=1.0, z=(0.0, 1.0))
    torch.cuda.reset_peak_memory_stats()
    counters['fftlog.launches'] = 0
    t0 = time.perf_counter()
    pk, sigma8 = fn(*params_dev)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(tuple(pk.shape) == (B_NATIVE, 2, NK_NATIVE) and tuple(sigma8.shape) == (B_NATIVE,),
          'native pipeline output shapes are wrong')
    check(bool(torch.isfinite(pk).all()) and bool(torch.isfinite(sigma8).all()), 'native pipeline outputs are not finite')
    wall = wall_ms(lambda: fn(*params_dev), reps=3, warmup=False)
    print(f'native pipeline: B={B_NATIVE}, nk={NK_NATIVE}, kmax=1.0 h/Mpc (8192 + 4096 RK4 steps), z=[0, 1]: wall '
          f'{wall:.1f} ms (median of 3 after the first call, {first * 1e3:.1f} ms), peak memory '
          f'{peak_gb:.2f} GB, sigma8 range [{sigma8.min().item():.4f}, {sigma8.max().item():.4f}] on {card}',
          flush=True)

    # 11. the DESI fiducial at full knobs against the CLASS anchors; its
    # sigma8 runs TophatVariance through the FFTLog kernel
    main_run_start()
    t0 = time.perf_counter()
    desi = DESI(engine='native', extra_params={'nk_pk': 128})
    fo, th = desi.get_fourier(), desi.get_thermodynamics()
    sigma8_m, sigma8_cb = fo.sigma8_m.item(), fo.sigma8_cb.item()
    torch.cuda.synchronize()
    build = time.perf_counter() - t0
    launches = counters['fftlog.launches']
    interp = fo.pk_interpolator()
    k_bao = torch.from_numpy(K_H[BAO_BAND]).to(DEVICE)
    pk0, pk1 = (interp(k_bao, torch.tensor([z], dtype=torch.float64, device=DEVICE))[:, 0].cpu().numpy()
                for z in (0.0, 1.0))
    splines = note_splines('native DESI engine')
    errs = {'sigma8_m': abs(sigma8_m / SIGMA8_M_CLASS - 1), 'sigma8_cb': abs(sigma8_cb / SIGMA8_CB_CLASS - 1),
            'pk(z=0)': np.max(np.abs(pk0 / PK_M_Z0[BAO_BAND] - 1)), 'pk(z=1)': np.max(np.abs(pk1 / PK_M_Z1[BAO_BAND] - 1))}
    z_drag, z_star, rs_drag = th.z_drag.item(), th.z_star_noreion.item(), th.rs_drag.item()
    tau = abs(th.tau_reio.item() - desi['tau_reio'].item())
    print(f'native DESI engine (nk_pk=128, kmax_pk=10: 10240 + 6144 steps): built in {build:.1f} s on {card}; '
          f'kernel launches {launches}, spline kernel launches {splines} (with its P(k) interpolator); against '
          f'CLASS: sigma8_m {sigma8_m:.6f} ({errs["sigma8_m"]:.2e}, bar 5e-3), '
          f'sigma8_cb {sigma8_cb:.6f} ({errs["sigma8_cb"]:.2e}, bar 5e-3), P(k) in the BAO band z=0 '
          f'{errs["pk(z=0)"]:.2e} and z=1 {errs["pk(z=1)"]:.2e} (bar 1.2e-2); z_drag {z_drag:.3f} (bar 2.0 from '
          f'{Z_DRAG_PLANCK}), z_star_noreion {z_star:.3f} (bar 2.5 from {Z_STAR_PLANCK}), rs_drag {rs_drag:.4f} Mpc/h '
          f'({abs(rs_drag / RS_DRAG_CLASS - 1):.2e}, bar 1.5e-3), tau_reio {tau:.1e} from its input (bar 1e-6)',
          flush=True)
    check(launches > 0, 'the native Fourier section did not launch the FFTLog kernel')
    check(errs['sigma8_m'] < 5e-3 and errs['sigma8_cb'] < 5e-3, 'native sigma8 is off the CLASS values')
    check(errs['pk(z=0)'] < 1.2e-2 and errs['pk(z=1)'] < 1.2e-2, 'native P(k) is off the CLASS values')
    check(abs(z_drag - Z_DRAG_PLANCK) < 2.0 and abs(z_star - Z_STAR_PLANCK) < 2.5, 'native z_drag or z_star is off')
    check(abs(rs_drag / RS_DRAG_CLASS - 1) < 1.5e-3 and tau < 1e-6, 'native rs_drag or tau_reio is off')

    # 12. card against CPU, 4 cosmologies at kmax = 0.5 (2560 + 1280 steps)
    params = cosmo_params(rng, B_NATIVE_CHECK)
    fn, _ = make_native_pk_pipeline_batched(nk=NK_NATIVE, kmax=0.5, z=(0.0, 1.0))
    scalars = ('z_drag', 'z_star', 'z_star_noreion', 'z_reio', 'rs_drag', 'rs_star')

    def run(device):
        p = [torch.from_numpy(v).to(device) for v in params]
        cosmo = Cosmology(omega_cdm=p[0], omega_b=p[1], h=p[2], n_s=p[3], logA=p[4], engine='native')
        th = cosmo.get_thermodynamics()
        return fn(*p), {name: getattr(th, name).cpu() for name in scalars}, cosmo

    (pk, sigma8), th_dev, cosmo_dev = run(DEVICE)
    (pk_cpu, sigma8_cpu), th_cpu, cosmo_cpu = run('cpu')
    pk_err = (pk.cpu() / pk_cpu - 1).abs().max().item()
    s8_err = (sigma8.cpu() / sigma8_cpu - 1).abs().max().item()
    th_err = max((th_dev[name] / th_cpu[name] - 1).abs().max().item() for name in scalars)
    print(f'native, card vs CPU, {B_NATIVE_CHECK} cosmologies, kmax=0.5: pk_m {pk_err:.3e}, sigma8 {s8_err:.3e} '
          f'(bar {NATIVE_RTOL:g}), thermodynamics scalars {th_err:.3e} (bar {THERMO_RTOL:g})', flush=True)
    check(pk_err <= NATIVE_RTOL and s8_err <= NATIVE_RTOL and th_err <= THERMO_RTOL, 'native card and CPU disagree')
    native_worst_lane(pk.cpu(), pk_cpu, {DEVICE: cosmo_dev, 'cpu': cosmo_cpu}, np.geomspace(1e-4, 0.5, NK_NATIVE),
                      (0.0, 1.0))

    # 13. graph replay against the eager loop, on the card, on the inputs of 12
    p = [torch.from_numpy(v).to(DEVICE) for v in params]
    cosmo = Cosmology(omega_cdm=p[0], omega_b=p[1], h=p[2], n_s=p[3], logA=p[4], engine='native')
    ba, pp = cosmo.get_background(), cosmo.engine._perturbation_params()
    k = torch.from_numpy(np.geomspace(1e-4, GRAPH_KMAX, NK_NATIVE)).to(DEVICE)
    out = {}
    for graphs in (True, False):
        t0 = time.perf_counter()
        thermo = compute_thermodynamics(cosmo['omega_b'], cosmo['h'], cosmo['T_cmb'], ba.efunc,
                                        tau_reio=cosmo['tau_reio'], reionization_width=cosmo['reionization_width'],
                                        N_eff=cosmo['N_eff'], graphs=graphs)
        out[graphs] = (thermo.x_e, linear_pk(pp, thermo, k, [0.0, 1.0], n_steps=GRAPH_N_STEPS,
                                             graphs=graphs)['pk_m'])
        torch.cuda.synchronize()
        out[graphs] += (time.perf_counter() - t0,)
    x_err = ((out[True][0] - out[False][0]).abs() / out[False][0].abs()).max().item()
    pk_err = ((out[True][1] - out[False][1]).abs() / out[False][1].abs()).max().item()
    print(f'native, CUDA graphs vs eager on the card, {B_NATIVE_CHECK} cosmologies, kmax={GRAPH_KMAX}, n_steps='
          f'{GRAPH_N_STEPS}: x_e {x_err:.3e}, pk_m '
          f'{pk_err:.3e} (bar {GRAPH_RTOL:g}); wall {out[True][2]:.2f} s with graphs, {out[False][2]:.2f} s eagerly '
          f'on {card}', flush=True)
    check(bool(torch.isfinite(out[False][1]).all()), 'the eager loop at GRAPH_N_STEPS is not finite')
    check(x_err <= GRAPH_RTOL and pk_err <= GRAPH_RTOL, 'the graph replay disagrees with the eager loop')
    return launches


def native_worst_lane(pk, pk_cpu, cosmos, k_hmpc, z):
    """Phase 12, diagnosis: the (cosmology, k, z) entry of the largest
    card-against-CPU deviation of pk_m, and how near its lane comes to each
    of the solver's switches, on the CPU's tables: the tight-coupling
    triggers kappa' > 120 aH and kappa' > 50 k and the Poisson pin k >
    2.5 aH at every RK4 point of phase A and on the master grid of the step
    density; also how far the lane's time grids (phase A, phase B) differ
    between the card and the CPU. Prints only; phase 12's bar decides."""
    from cosmoprimo_tpu_torch.boltzmann.perturbations import (POISSON_KAH, TCA_TRIGGER_AH, TCA_TRIGGER_K, _fetch,
                                                              _setup, steps_for_kmax)
    dev = (pk / pk_cpu - 1).abs()                                   # (B, nz, nk)
    b, iz, j = np.unravel_index(int(dev.argmax()), tuple(dev.shape))
    runs = {}
    for device, cosmo in cosmos.items():
        pp = cosmo.engine._perturbation_params()
        k = torch.from_numpy(k_hmpc).to(device) * pp['h'][:, None]
        runs[device] = _setup(pp, cosmo.get_thermodynamics().table, k, list(z), steps_for_kmax(float(k_hmpc[-1])))
    cpu = runs['cpu']
    grid_diff = max(((runs[DEVICE][name][:, b, j].cpu() - cpu[name][:, b, j]).abs() / cpu[name][:, b, j]).max().item()
                    for name in ('eta_A', 'eta_B'))
    k = cpu['k'][b, j]
    eta = cpu['eta_A'][:, b, j]
    eta = torch.cat([eta, 0.5 * (eta[1:] + eta[:-1])])              # the RK4 nodes and midpoints
    c = _fetch(cpu['tabs'], eta[:, None, None].expand(-1, cpu['k'].shape[0], 1))
    kp, Hc = c['kp'][:, b, 0], c['Hc'][:, b, 0]
    kpm, Hcm = cpu['tabs']['kp'][b], cpu['tabs']['Hc'][b]

    def margin(x):
        return (x - 1).abs().min().item()

    margins = {'tca kappa\'/(120 aH)': margin(kp / (TCA_TRIGGER_AH * Hc)), 'tca kappa\'/(50 k)': margin(kp / (TCA_TRIGGER_K * k)),
               'pin k/(2.5 aH)': margin(k / (POISSON_KAH * Hc)),
               'grid tca kappa\'/(120 aH)': margin(kpm / (TCA_TRIGGER_AH * Hcm)),
               'grid tca kappa\'/(50 k)': margin(kpm / (TCA_TRIGGER_K * k))}
    low_k = dev[..., k_hmpc >= 1e-3].max().item()
    on = [name for name, value in margins.items() if value < 1e-10]
    print(f'native, card vs CPU, worst lane: cosmology {b}, k = {k_hmpc[j]:.6g} h/Mpc (index {j} of {k_hmpc.size}), '
          f'z = {z[iz]}: {dev[b, iz, j].item():.3e}; median over all lanes {dev.median().item():.3e}; worst at '
          f'k >= 1e-3 h/Mpc {low_k:.3e}; its time grids, card against CPU, {grid_diff:.3e}; nearest approach to each '
          f'switch (|ratio - 1|): ' + ', '.join(f'{name} {value:.3e}' for name, value in margins.items())
          + f'; on a threshold (< 1e-10): {on or "none"}', flush=True)


def analytic_engines(fftlog_kernel, rng, card):
    """Phases 14 and 15: the BBKS and EH99-variants engines through the
    pk -> xi pipeline at full width, then the variants with one massive
    species through HMcode (its cold field for sigma(R)) and halofit, and
    to_xi of each table. Returns the kernel's launches."""
    from cosmoprimo_tpu_torch import Cosmology, make_pk_to_xi_pipeline_batched
    launches = 0
    # 14. full width, one FFTLog launch each
    for engine in ANALYTIC_ENGINES:
        fn, _, _ = make_pk_to_xi_pipeline_batched(nk=NK, z=[0.0], engine=engine)
        n = run_pipeline(f'{engine} pipeline', fn, cosmo_params(rng, B), NK, fftlog_kernel, card)
        check(n == 1, f'the {engine} pipeline took {n} kernel launches, not one')
        launches += n

    # 15. one massive species, the seven DESI redshifts
    params = cosmo_params(rng, B_VARIANTS) + (rng.uniform(0.06, 0.12, B_VARIANTS),)
    k_np = np.geomspace(1e-5, 1e2, NK_HMCODE)

    def run(device, rows):
        omega_cdm, omega_b, h, n_s, logA, m_ncdm = (torch.from_numpy(p[rows]).to(device) for p in params)
        fo = Cosmology(engine='eisenstein_hu_nowiggle_variants', omega_cdm=omega_cdm, omega_b=omega_b, h=h, n_s=n_s,
                       logA=logA, m_ncdm=[m_ncdm], N_eff=3.044).get_fourier()
        out = {}
        for non_linear in ('mead', 'halofit'):
            interp = fo.pk_interpolator(non_linear=non_linear, k=k_np, z=DESI_Z)
            out[f'pk {non_linear}'] = interp.pk                                          # (B, nk, nz)
            # to_xi on its default grid, 1e-7 ... 1e2 h/Mpc: the table's last
            # cell below 1e2 and its padding beyond; one launch
            out[f'xi {non_linear}'] = interp.to_xi()._xi                                # (B, ns, nz)
        return out

    torch.cuda.reset_peak_memory_stats()
    main_run_start()
    out = run(DEVICE, slice(None))
    torch.cuda.synchronize()
    n = counters['fftlog.launches']
    splines = note_splines('variants with one massive species')
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f'variants with one massive species: B={B_VARIANTS} x {DESI_Z.size} z, nk={NK_HMCODE}, mead (cold field '
          f'for sigma(R)) and halofit, P(k) and xi {tuple(out["pk mead"].shape)}, kernel '
          f'launches {n}, spline kernel launches {splines}, peak memory {peak_gb:.2f} GB', flush=True)
    check(n == 2, 'the variants phase did not launch the FFTLog kernel once for each table')
    check(all(bool(torch.isfinite(value).all()) for value in out.values()), 'variants outputs are not all finite')
    ref = run('cpu', slice(N_COMPARE))
    errs = {}
    for name, value in ref.items():
        got = out[name][:N_COMPARE].cpu()
        if name.startswith('xi'):   # 1e-10 of each (cosmology, z) row's max
            errs[name] = ((got - value).abs().amax(dim=-2) / value.abs().amax(dim=-2)).max().item()
        else:
            errs[name] = (got / value - 1).abs().max().item()
    print(f'variants, card vs CPU, first {N_COMPARE} cosmologies: ' + ', '.join(f'{name} {err:.3e}' for name, err in
                                                                              errs.items()) + f' (bar {BAO_RTOL:g})',
          flush=True)
    check(all(err <= BAO_RTOL for err in errs.values()), 'card and CPU disagree on the variants phase')
    wall = wall_ms(lambda: run(DEVICE, slice(None)))
    print(f'variants wall: {wall:.3f} ms per batch of {B_VARIANTS} x {DESI_Z.size} z (mead, halofit, two transforms; median '
          f'of 5 after a warm-up) on {card}', flush=True)
    return launches + n


def batched_solve(rng, card):
    """Phase 16: solve('h', 'theta_MC_100', target) for a batch, one target
    per row, against the same solve on CPU tensors."""
    from cosmoprimo_tpu_torch import Cosmology, cosmology
    omega_cdm, omega_b, _, n_s, logA = cosmo_params(rng, B_SOLVE)
    target = rng.uniform(1.035, 1.045, B_SOLVE)
    evaluations = [0]
    rs_cosmomc = cosmology._compute_rs_cosmomc

    def counted(*args):   # one per evaluation of theta_MC_100
        evaluations[0] += 1
        return rs_cosmomc(*args)

    def solve(device, rows):
        cosmo = Cosmology(engine='eisenstein_hu', **{name: torch.from_numpy(value[rows]).to(device) for name, value in
                                                     (('omega_cdm', omega_cdm), ('omega_b', omega_b), ('n_s', n_s),
                                                      ('logA', logA))})
        return cosmo.solve('h', 'theta_MC_100', target=torch.from_numpy(target[rows]).to(device))

    cosmology._compute_rs_cosmomc = counted
    try:
        sol = solve(DEVICE, slice(None))
        h = sol['h']
        torch.cuda.synchronize()
        n_eval = evaluations[0]
        ref = solve('cpu', slice(N_COMPARE))['h']
        wall = wall_ms(lambda: solve(DEVICE, slice(None))['h'])
    finally:
        cosmology._compute_rs_cosmomc = rs_cosmomc
    theta = sol['theta_MC_100']
    # Ridders stops once the bracket is narrower than xtol, so |h - h*| < xtol
    # and |theta(h) - target| <= |d theta / dh| xtol, the slope from a central
    # difference at the solution
    slope = (sol.clone(h=h + 1e-4)['theta_MC_100'] - sol.clone(h=h - 1e-4)['theta_MC_100']) / 2e-4
    theta_err = ((theta - torch.from_numpy(target).to(DEVICE)).abs() / (slope.abs() * SOLVE_XTOL)).max().item()
    h_err = (h[:N_COMPARE].cpu() / ref - 1).abs().max().item()
    print(f'batched solve h <- theta_MC_100: B={B_SOLVE}, {n_eval} evaluations of theta_MC_100 (each the whole batch), '
          f'h in [{h.min().item():.4f}, {h.max().item():.4f}]; h card vs CPU on {N_COMPARE} rows {h_err:.3e} (bar '
          f'{SOLVE_RTOL:g}); |theta - target| / (|d theta / dh| xtol) at most {theta_err:.3e} (bar 1, xtol '
          f'{SOLVE_XTOL:g}); wall {wall:.3f} ms (median of 5 after a warm-up) on {card}', flush=True)
    check(bool(torch.isfinite(h).all()), 'the batched solve left a row without a root')
    check(h_err <= SOLVE_RTOL and theta_err <= 1.0, 'the batched solve is wrong')


def mock_redshifts(card):
    """Phase 17: TabulatedDESI and DistanceToRedshift on a mock catalogue's
    comoving distances, drawn on the card."""
    from cosmoprimo_tpu_torch.fiducial import DESI, TabulatedDESI
    from cosmoprimo_tpu_torch.utils import DistanceToRedshift
    generator = torch.Generator(device=DEVICE).manual_seed(17)
    # DESI's tracers span 0.1 (BGS) to ~3 (the Lyman-alpha quasars); below 0.1
    # the closed-form background's own distance table departs from CLASS's
    # by more than the bar (2e-3 at z = 0.001)
    z = 0.1 + 2.9 * torch.rand(N_MOCK, dtype=torch.float64, device=DEVICE, generator=generator)

    def run(zz):
        tab = TabulatedDESI(device=zz.device)
        chi = tab.comoving_radial_distance(zz)
        return chi, DistanceToRedshift(tab.comoving_radial_distance)(chi), tab.efunc(zz)

    chi, z_back, efunc = run(z)
    round_trip = (z_back / z - 1).abs().max().item()
    fid = DESI(engine='eisenstein_hu', device=DEVICE)
    closed = max((chi / fid.comoving_radial_distance(z) - 1).abs().max().item(),
                 (efunc / fid.efunc(z) - 1).abs().max().item())
    ref = run(z[:N_COMPARE].cpu())
    cpu = max((got[:N_COMPARE].cpu() / value - 1).abs().max().item() for got, value in zip((chi, z_back, efunc), ref))
    wall = wall_ms(lambda: run(z))
    print(f'mock redshifts: {N_MOCK} z ~ U(0.1, 3) drawn on the card; TabulatedDESI chi and efunc against DESI()\'s '
          f'closed form {closed:.3e} (bar {TABULATED_RTOL:g}); z -> chi -> z {round_trip:.3e} (bar {ROUND_TRIP_RTOL:g}); '
          f'card vs CPU on {N_COMPARE} {cpu:.3e} (bar {CHI_SIGMA8_RTOL:g}); wall {wall:.3f} ms (TabulatedDESI, chi, the '
          f'inversion and efunc; median of 5 after a warm-up) on {card}', flush=True)
    check(bool(torch.isfinite(z_back).all()), 'the inversion left NaN redshifts')
    check(closed <= TABULATED_RTOL and round_trip <= ROUND_TRIP_RTOL and cpu <= CHI_SIGMA8_RTOL,
          'the mock redshifts are wrong')


def _patched(pairs):
    """Set each (module, name, value) and return the old values, to restore."""
    old = [(module, name, getattr(module, name)) for module, name, _ in pairs]
    for module, name, value in pairs:
        setattr(module, name, value)
    return old


def cmb_spectra(fftlog_kernel, rng, card):
    """Phase 18: the native CMB spectra of B_CL cosmologies through
    Cosmology(engine='native').get_harmonic() at full width, twice (the
    first call and one more, each a new Cosmology), with each stage's wall;
    then the card against the CPU on CL_CHECK['rows'] cosmologies at a cut
    size and step budget. Returns the FFTLog kernel's launches in the main
    path's run (the path reaches no FFTLog)."""
    from cosmoprimo_tpu_torch import Cosmology
    from cosmoprimo_tpu_torch.boltzmann import harmonic, perturbations, tensor
    from cosmoprimo_tpu_torch.models import native
    params = cosmo_params(rng, B_CL)

    def spectra(device, rows, ellmax, extra=None):
        p = [torch.from_numpy(v[rows]).to(device) for v in params]
        cosmo = Cosmology(omega_cdm=p[0], omega_b=p[1], h=p[2], n_s=p[3], logA=p[4], r=R_CL, engine='native',
                          ellmax_cl=ellmax, extra_params=extra or {})
        hs = cosmo.get_harmonic()
        return {'unlensed': hs.unlensed_cl(), 'lensed': hs.lensed_cl(), 'potential': hs.lens_potential_cl()}

    stages = {}

    def timed(label, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            stages[label] = stages.get(label, 0.0) + time.perf_counter() - t0
            return out
        return run

    wrapped = [(native, 'compute_thermodynamics', 'recombination'), (harmonic, 'compute_los_sources', 'sources'),
               (harmonic, 'project_sources', 'projection'), (harmonic, 'limber_pp', 'Limber'),
               (tensor, 'compute_tensor_sources', 'tensor sources'),
               (tensor, 'project_tensor_sources', 'tensor projection'), (native, 'lensed_cls', 'lensing')]
    old = _patched([(module, name, timed(label, getattr(module, name))) for module, name, label in wrapped])
    try:
        walls, launches = [], None
        for call in range(2):
            stages.clear()
            torch.cuda.reset_peak_memory_stats()
            main_run_start()
            t0 = time.perf_counter()
            out = spectra(DEVICE, slice(None), ELLMAX_CL)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if launches is None:
                launches = counters['fftlog.launches']
                note_splines('CMB spectra', required=False)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            split = ', '.join(f'{label} {stages.get(label, 0.0):.3f} s' for _, _, label in wrapped)
            split += f', the rest (set-up, Bessel tables, splines) {walls[-1] - sum(stages.values()):.3f} s'
            print(f'CMB spectra, call {call + 1}: B={B_CL}, ellmax_cl={ELLMAX_CL} (lmax {ELLMAX_CL + 400}), r={R_CL} '
                  f'(tensors to l = 600): wall {walls[-1]:.3f} s, peak memory {peak_gb:.2f} GB; stages: {split}; '
                  f'FFTLog kernel launches {counters["fftlog.launches"]}, spline kernel launches '
                  f'{counters["spline.launches"]} on {card}', flush=True)
    finally:
        _patched(old)
    for kind, table in out.items():
        for name, value in table.items():
            if name == 'ell':
                continue
            check(tuple(value.shape) == (B_CL, ELLMAX_CL + 1), f'CMB {kind} {name} has the wrong shape')
            check(bool(torch.isfinite(value).all()), f'CMB {kind} {name} is not finite')
    # the unlensed BB is the tensors', to l = 600; lensing adds the E-mode's at every l
    for kind, lmax_bb in (('unlensed', 600), ('lensed', ELLMAX_CL)):
        check(bool((out[kind]['tt'][:, 2:] > 0).all()) and bool((out[kind]['bb'][:, 2:lmax_bb + 1] > 0).all()),
              f'CMB {kind} TT or BB is not positive')
    tt = out['lensed']['tt'][0].cpu().numpy()
    ells = [l for l in (2, 220, 1000, 2500) if l <= ELLMAX_CL]
    print(f'CMB spectra: lensed D_l^TT of cosmology 0 at l = {ells}: '
          + ', '.join(f'{l * (l + 1) * tt[l] / (2 * np.pi) * (2.7255e6) ** 2:.2f} muK^2' for l in ells),
          flush=True)

    # the card against the CPU at a cut size and budget
    cut = CL_CHECK
    old = _patched([(perturbations, 'N_STEPS_A', cut['n_steps'][0]), (perturbations, 'N_STEPS_B', cut['n_steps'][1]),
                    (perturbations, 'M_TAB', cut['n_steps'][2]), (tensor, 'N_STEPS_T', cut['n_steps_t'])])
    try:
        t0 = time.perf_counter()
        got = spectra(DEVICE, slice(cut['rows']), cut['ellmax'], cut['extra'])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ref = spectra('cpu', slice(cut['rows']), cut['ellmax'], cut['extra'])
        t2 = time.perf_counter()
    finally:
        _patched(old)
    errs = {}
    for kind, table in ref.items():
        for name, value in table.items():
            if name == 'ell':
                continue
            d = (got[kind][name].cpu() - value).abs()[:, 2:]
            if name == 'te':
                scale = torch.sqrt(table['tt'] * table['ee'])[:, 2:]
                errs[f'{kind} te'] = (d / scale).max().item()
            else:
                errs[f'{kind} {name}'] = (d.amax(dim=-1) / value[:, 2:].abs().amax(dim=-1)).max().item()
    print(f'CMB spectra, card vs CPU, {cut["rows"]} cosmologies at ellmax_cl={cut["ellmax"]}, lensing_margin='
          f'{cut["extra"]["lensing_margin"]}, n_steps={cut["n_steps"]}, N_STEPS_T={cut["n_steps_t"]}: '
          + ', '.join(f'{name} {err:.3e}' for name, err in errs.items())
          + f' (bar {CL_RTOL:g}; TE against sqrt(TT EE)); card {t1 - t0:.1f} s, CPU {t2 - t1:.1f} s', flush=True)
    check(all(err <= CL_RTOL for err in errs.values()), 'the CMB spectra on the card and the CPU disagree')
    return launches


def perturbation_table(card):
    """Phase 19: DESI(engine='native').get_perturbations().table() at the
    default k_output_values, on the card against the CPU."""
    from cosmoprimo_tpu_torch.fiducial import DESI
    out = {}
    for device in (DEVICE, 'cpu'):
        t0 = time.perf_counter()
        out[device] = DESI(engine='native', device=device).get_perturbations().table()
        out[device + ' s'] = time.perf_counter() - t0
    errs = {}
    for got, ref in zip(out[DEVICE], out['cpu']):
        check(got.dtype.names == ref.dtype.names and got.shape == ref.shape, 'the Perturbations tables differ in layout')
        for name in ref.dtype.names:
            check(bool(np.isfinite(got[name]).all()), f'the Perturbations table has non-finite {name}')
            err = np.max(np.abs(got[name] - ref[name])) / max(np.max(np.abs(ref[name])), 1e-300)
            errs[name] = max(errs.get(name, 0.0), err)
    worst = max(errs, key=errs.get)
    print(f'Perturbations table, DESI, k = (0.01, 0.1, 1.0) h/Mpc (8192 + 4096 steps), {len(ref)} tau nodes: card vs '
          f'CPU worst field {worst} {errs[worst]:.3e}, every field <= {max(errs.values()):.3e} (bar {SERIES_RTOL:g}); '
          f'card {out[DEVICE + " s"]:.1f} s, CPU {out["cpu s"]:.1f} s on {card}', flush=True)
    check(max(errs.values()) <= SERIES_RTOL, 'the Perturbations tables on the card and the CPU disagree')


def emitting_graphs(rng, card):
    """Phase 20: the emitting loops (the line-of-sight taps, the
    perturbation series, the tensor loop) replayed from CUDA graphs against
    the same loops run eagerly on the card, at a cut step budget."""
    from cosmoprimo_tpu_torch import Cosmology
    from cosmoprimo_tpu_torch.boltzmann import harmonic, perturbations as P, tensor
    cut = EMIT_GRAPH
    p = [torch.from_numpy(v).to(DEVICE) for v in cosmo_params(rng, cut['rows'])]
    cosmo = Cosmology(omega_cdm=p[0], omega_b=p[1], h=p[2], n_s=p[3], logA=p[4], engine='native')
    pp, th = cosmo.engine._perturbation_params(), cosmo.get_thermodynamics().table
    k = torch.from_numpy(harmonic.coarse_k_grid(cut['kmax'])).to(DEVICE).expand(cut['rows'], -1).contiguous()
    old = _patched([(tensor, 'N_STEPS_T', cut['n_steps_t'])])
    out, walls = {}, {}
    try:
        for graphs in (True, False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[graphs] = (P.compute_los_sources(pp, th, k, n_steps=cut['n_steps'], graphs=graphs)['src'],
                           P.compute_perturbation_series(pp, th, k, n_steps=cut['n_steps'], graphs=graphs)['series'],
                           tensor.compute_tensor_sources(pp, th, k, graphs=graphs)['src'])
            torch.cuda.synchronize()
            walls[graphs] = time.perf_counter() - t0
    finally:
        _patched(old)
    errs = [((g - e).abs().amax(dim=-1) / e.abs().amax(dim=-1).clamp(min=1e-300)).max().item()
            for g, e in zip(out[True], out[False])]
    print(f'emitting loops, CUDA graphs vs eager on the card, {cut["rows"]} cosmologies, {k.shape[-1]} k to '
          f'{cut["kmax"]} /Mpc, n_steps={cut["n_steps"]}, N_STEPS_T={cut["n_steps_t"]}: line-of-sight sources '
          f'{errs[0]:.3e}, perturbation series {errs[1]:.3e}, tensor sources {errs[2]:.3e} (bar {GRAPH_RTOL:g}); '
          f'wall {walls[True]:.2f} s with graphs, {walls[False]:.2f} s eagerly on {card}', flush=True)
    check(all(bool(torch.isfinite(t).all()) for t in out[False]), 'the eager emitting loops are not finite')
    check(all(err <= GRAPH_RTOL for err in errs), 'the emitting loops replayed from graphs disagree with eager')


def emulator_params(rng, n, names=('logA', 'n_s', 'h', 'omega_b', 'omega_cdm', 'm_ncdm', 'w0_fld', 'wa_fld',
                                   'tau_reio')):
    """Cosmologies inside every box of the 'native-base' recipe (w0 + wa
    < 0, so that early radiation domination holds)."""
    boxes = {'logA': (2.8, 3.3), 'n_s': (0.88, 1.06), 'h': (0.55, 0.82), 'omega_b': (0.019, 0.026),
             'omega_cdm': (0.08, 0.20), 'm_ncdm': (0.0, 0.6), 'w0_fld': (-1.5, -0.5), 'wa_fld': (-1.5, 0.0),
             'tau_reio': (0.02, 0.12), 'sigma8': (0.7, 0.9)}
    return {name: rng.uniform(*boxes[name], n) for name in names}


def rows_err(got, ref):
    """:func:`rel_err` of the card's rows against the CPU's, each row
    flattened."""
    return rel_err(got.cpu().reshape(len(ref), -1), ref.reshape(len(ref), -1))


def emulator_serving(fftlog_kernel, rng, card):
    """Phase 21: the 'native-base' emulator at full width (the nets 64 wide,
    Cls to 2500), written to a temporary .npy, read back and served as
    Cosmology(engine=EmulatedEngine.read(path)) on B_EMU cosmologies: the
    background at the DESI redshifts, rs_drag, P(k) and sigma8_m (the
    kernel), xi (the kernel), the Cls; the card against the CPU on
    N_COMPARE rows, a sigma8 input, jacfwd of lensed TT against the CPU;
    walls and peak memory. Returns the kernel's launches in the main run."""
    import os
    import shutil
    import tempfile
    from cosmoprimo_tpu_torch import Cosmology
    from cosmoprimo_tpu_torch.emulators import EmulatedEngine, Emulator
    directory = tempfile.mkdtemp()
    try:
        t0 = time.perf_counter()
        state = native_base_emulator_state()
        fn = os.path.join(directory, 'native_base.npy')
        Emulator.from_state(state).write(fn)
        check(set(Emulator.read(fn).engines) == set(state['engines']), 'the emulator file does not round-trip')
        build_s = time.perf_counter() - t0
        engine = EmulatedEngine.read(fn)
        params = emulator_params(rng, B_EMU)
        k = np.geomspace(1e-3, 1.0, 64)
        s = np.geomspace(10.0, 150.0, 32)

        def serve(values, device, harmonic_only=False):
            cosmo = Cosmology(engine=engine, ellmax_cl=ELLMAX_EMU, device=device,
                              **{name: torch.from_numpy(value).to(device) for name, value in values.items()})
            hr = cosmo.get_harmonic()
            out = {f'{kind}.{key}': value for kind, table in (('lensed', hr.lensed_cl()), ('unlensed', hr.unlensed_cl()),
                                                               ('potential', hr.lens_potential_cl()))
                   for key, value in table.items() if key != 'ell'}
            if harmonic_only:
                return out
            ba, fo = cosmo.get_background(), cosmo.get_fourier()
            z = torch.from_numpy(DESI_Z).to(device)
            pk = fo.pk_interpolator()
            out.update({'chi': ba.comoving_radial_distance(z), 'growth_rate': ba.growth_rate(z),
                        'rs_drag': cosmo.get_thermodynamics().rs_drag[..., None], 'pk': pk(k, z),
                        'sigma8': fo.sigma8_m[..., None], 'xi': pk.to_xi()(s, z)})
            return out

        torch.cuda.reset_peak_memory_stats()
        main_run_start()
        out = serve(params, DEVICE)
        torch.cuda.synchronize()
        launches = counters['fftlog.launches']
        splines = note_splines('emulated serving')
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        print(f'emulated (native-base layout, {len(state["engines"])} nets): B={B_EMU}, {len(out)} outputs, '
              f'kernel launches {launches}, spline kernel launches {splines}, peak memory {peak_gb:.2f} GB; state '
              f'built and written in '
              f'{build_s:.2f} s', flush=True)
        check(launches > 0, 'the emulated Fourier section did not launch the FFTLog kernel')
        check(all(bool(torch.isfinite(value).all()) for value in out.values()), 'emulated outputs are not all finite')
        ref = serve({name: value[:N_COMPARE] for name, value in params.items()}, 'cpu')
        errs = {name: rows_err(out[name][:N_COMPARE], value) for name, value in ref.items()}
        worst = max(errs, key=errs.get)
        print(f'emulated, card vs CPU, first {N_COMPARE} rows: worst {worst} {errs[worst]:.3e} of its row max '
              f'(bar {EMU_RTOL:g}); chi {errs["chi"]:.3e}, pk {errs["pk"]:.3e}, sigma8 {errs["sigma8"]:.3e}, '
              f'xi {errs["xi"]:.3e}, lensed tt {errs["lensed.tt"]:.3e}', flush=True)
        check(errs[worst] <= EMU_RTOL, 'the emulated engine disagrees between the card and the CPU')

        # the rescaling direction: sigma8 in, the nets' logA from the A_s guess
        sigma8 = emulator_params(rng, B_EMU, names=[name for name in params if name != 'logA'] + ['sigma8'])
        cosmo = Cosmology(engine=engine, ellmax_cl=ELLMAX_EMU,
                          **{name: torch.from_numpy(value).to(DEVICE) for name, value in sigma8.items()})
        got = cosmo.get_fourier().sigma8_m.cpu().numpy()
        sigma8_err = float(np.max(np.abs(got / sigma8['sigma8'] - 1)))
        print(f'emulated, sigma8 input at B={B_EMU}: sigma8_m against the input {sigma8_err:.3e} '
              f'(bar {EMU_RTOL:g})', flush=True)
        check(sigma8_err <= EMU_RTOL, 'the emulated sigma8 rescaling does not return its input')

        # forward mode: jacfwd of lensed TT in six parameters, card against CPU
        names = ('logA', 'n_s', 'h', 'omega_b', 'omega_cdm', 'tau_reio')
        fixed = {name: value[:EMU_JAC_ROWS] for name, value in params.items() if name not in names}

        def jacobian(device):
            def tt(*args):
                values = {**{name: torch.from_numpy(value).to(device) for name, value in fixed.items()},
                          **dict(zip(names, args))}
                return Cosmology(engine=engine, ellmax_cl=ELLMAX_EMU, **values).get_harmonic().lensed_cl()['tt']
            args = [torch.from_numpy(params[name][:EMU_JAC_ROWS]).to(device) for name in names]
            jac = torch.func.jacfwd(tt, argnums=tuple(range(len(names))))(*args)
            return torch.stack([torch.stack([j[i, :, i] for i in range(EMU_JAC_ROWS)]) for j in jac], dim=-1)

        jac_err = rows_err(jacobian(DEVICE), jacobian('cpu'))
        print(f'emulated, jacfwd of lensed_cl()["tt"] in {names} on {EMU_JAC_ROWS} rows, card vs CPU: '
              f'{jac_err:.3e} of each row\'s max (bar {EMU_JAC_RTOL:g})', flush=True)
        check(jac_err <= EMU_JAC_RTOL, 'the emulated jacfwd disagrees between the card and the CPU')

        wall = wall_ms(lambda: serve(params, DEVICE))
        wall_cl = wall_ms(lambda: serve(params, DEVICE, harmonic_only=True))
        print(f'emulated wall: build and serve {wall:.3f} ms per batch of {B_EMU} ({B_EMU / wall * 1e3:.1f} '
              f'cosmologies/s), harmonic only {wall_cl:.3f} ms (median of 5 after a warm-up); peak memory '
              f'{peak_gb:.2f} GB on {card}', flush=True)
        return launches
    finally:
        shutil.rmtree(directory, ignore_errors=True)


def cosmopower_release(directory, rng, ells, nhidden=512, nlayers=5):
    """A synthetic cosmopower v1 release (the bolliet2023 layout: TTTEEE,
    PP and derived-parameters folders, arr_0-wrapped dicts) with TT, TE,
    EE, PP and derived networks of nlayers - 1 hidden layers x nhidden
    units and cosmopower's trainable activation, modes ``ells``; seeded
    weights scaled by 1/sqrt(fan_in)."""
    import os
    params = np.array(['omega_b', 'omega_cdm', 'h', 'tau_reio', 'n_s', 'ln10^{10}A_s'])
    mean, std = np.array([0.0224, 0.12, 0.68, 0.06, 0.965, 3.04]), np.array([0.001, 0.01, 0.05, 0.02, 0.02, 0.1])
    nets = {('TTTEEE', 'TT_v1'): (ells.size, -10.0), ('TTTEEE', 'TE_v1'): (ells.size, 1e-12),
            ('TTTEEE', 'EE_v1'): (ells.size, -12.0), ('PP', 'PP_v1'): (ells.size, -8.0),
            ('derived-parameters', 'DER_v1'): (14, 1.0)}
    for (folder, name), (n_out, level) in nets.items():
        sizes = [params.size] + [nhidden] * (nlayers - 1) + [n_out]
        arrays = {'n_layers': nlayers, 'parameters': params, 'param_train_mean': mean, 'param_train_std': std,
                  'feature_train_mean': np.full(n_out, level), 'feature_train_std': np.full(n_out, 0.05 * abs(level)),
                  'modes': ells}
        for i in range(nlayers):
            arrays[f'W_{i}'] = rng.standard_normal((sizes[i], sizes[i + 1])) / np.sqrt(sizes[i])
            arrays[f'b_{i}'] = 0.1 * rng.standard_normal(sizes[i + 1])
        for i in range(nlayers - 1):
            arrays[f'alphas_{i}'], arrays[f'betas_{i}'] = rng.standard_normal(nhidden), rng.random(nhidden)
        os.makedirs(os.path.join(directory, folder), exist_ok=True)
        np.savez(os.path.join(directory, folder, f'{name}.npz'), arr_0=np.array(arrays, dtype=object))


def jaxcapse_directory(directory, rng, n_out):
    """A synthetic jaxcapse TT network in the layout of
    tests/test_emulators.py::_make_synthetic_capse (one hidden layer of 16
    silu units), with ``n_out`` outputs."""
    import os
    sizes = [6, 16, n_out]
    weights = []
    for i in range(len(sizes) - 1):
        weights += [(rng.standard_normal((sizes[i + 1], sizes[i])) / np.sqrt(sizes[i])).ravel(order='F'),
                    0.01 * rng.standard_normal(sizes[i + 1]) + (1.0 if i == len(sizes) - 2 else 0.0)]
    folder = os.path.join(directory, 'TT')
    os.makedirs(folder)
    np.save(os.path.join(folder, 'weights.npy'), np.concatenate(weights))
    np.save(os.path.join(folder, 'nminmax.npy'), np.stack([np.array([2.5, 0.9, 60, 0.02, 0.1, 0.01]),
                                                           np.array([3.5, 1.0, 75, 0.024, 0.14, 0.10])], axis=-1))
    np.save(os.path.join(folder, 'outminmax.npy'), np.stack([np.full(n_out, 1e3), np.full(n_out, 6e3)], axis=-1))
    with open(os.path.join(folder, 'nn_setup.json'), 'w') as f:
        json.dump({'n_input_features': 6, 'n_output_features': n_out,
                   'layers': {'layer_1': {'n_neurons': 16, 'activation_function': 'silu'}}}, f)


def converted_nets(rng, card):
    """Phase 22: a cosmopower v1 release (4 x 512, modes 2..2500) and a
    jaxcapse TT network written into a temporary directory, converted by the
    port's converters and served through Cosmology at B_EMU: the Cls and
    the unpacked derived parameters, the card against the CPU on
    N_COMPARE rows, and the walls."""
    import os
    import shutil
    import tempfile
    from cosmoprimo_tpu_torch import Cosmology
    from cosmoprimo_tpu_torch.emulators import EmulatedEngine
    from cosmoprimo_tpu_torch.emulators.conversion import (convert_cosmopower_release_to_cosmoprimo,
                                                           convert_jaxcapse_to_cosmoprimo)
    directory = tempfile.mkdtemp()
    try:
        ells = np.arange(2, ELLMAX_EMU + 1)
        release = os.path.join(directory, 'cosmopower_bolliet2023_base')
        cosmopower_release(release, rng, ells)
        capse = os.path.join(directory, 'capse')
        jaxcapse_directory(capse, rng, ells.size)
        engines = {}
        for label, emulator in (('cosmopower v1 release, 4 x 512', convert_cosmopower_release_to_cosmoprimo(release)),
                                ('jaxcapse', convert_jaxcapse_to_cosmoprimo(capse))):
            fn = os.path.join(directory, f'{len(engines)}.npy')
            emulator.write(fn)
            engines[label] = EmulatedEngine.read(fn)
        params = emulator_params(rng, B_EMU, names=('logA', 'n_s', 'h', 'omega_b', 'omega_cdm', 'tau_reio'))

        def serve(engine, values, device, release):
            cosmo = Cosmology(engine=engine, ellmax_cl=ELLMAX_EMU, device=device,
                              **{name: torch.from_numpy(value).to(device) for name, value in values.items()})
            hr = cosmo.get_harmonic()
            out = {key: value for key, value in hr.lensed_cl().items() if key != 'ell'}
            if release:   # its lensing potential, and its packed derived parameters unpacked
                out['pp'] = hr.lens_potential_cl()['pp']
                th = cosmo.get_thermodynamics()
                out.update({name: getattr(th, name)[..., None] for name in ('rs_drag', 'z_drag', 'rs_star', 'z_star')})
            return out

        for label, engine in engines.items():
            release = label.startswith('cosmopower')
            out = serve(engine, params, DEVICE, release)
            check(all(bool(torch.isfinite(value).all()) for value in out.values()), f'{label}: outputs not finite')
            ref = serve(engine, {name: value[:N_COMPARE] for name, value in params.items()}, 'cpu', release)
            errs = {name: rows_err(out[name][:N_COMPARE], value) for name, value in ref.items()}
            worst = max(errs, key=errs.get)
            wall = wall_ms(lambda: serve(engine, params, DEVICE, release))
            print(f'converted {label}: {sorted(out)}, B={B_EMU}; card vs CPU, first {N_COMPARE} rows, worst '
                  f'{worst} {errs[worst]:.3e} (bar {EMU_RTOL:g}); wall {wall:.3f} ms per batch (median of 5 after a '
                  f'warm-up) on {card}', flush=True)
            check(errs[worst] <= EMU_RTOL, f'{label}: the card and the CPU disagree')
    finally:
        shutil.rmtree(directory, ignore_errors=True)


def fit_summary(emulator):
    """(steps, epochs, wall s of each stage summed over the nets, the nets
    whose validation loss did not fall) of a fitted emulator's MLP
    engines."""
    steps = epochs = 0
    stages, flat = [], []
    for name, engine in emulator.engines.items():
        history = engine.history
        steps += sum(h['steps'] for h in history)
        epochs += sum(h['epochs'] for h in history)
        for i, h in enumerate(history):
            stages += [0.0] * (i + 1 - len(stages))
            stages[i] += h['seconds']
        losses = [loss for h in history for loss in h['losses']]
        if not np.isfinite(losses).all() or min(losses) >= losses[0]:
            flat.append(name)
    return steps, epochs, stages, flat


def adam_card_vs_cpu(device, steps=ADAM_STEPS, seed=0, nin=8, nhidden=(64,) * 5, nout=422, batch=256):
    """``steps`` Adam steps of a 64 x 5 silu net (the recipe's fourier
    width) from one numpy-seeded initialization, on the same contiguous
    batches, on ``device`` and on the CPU: the worst parameter's max|d| /
    max|CPU| over its tensor."""
    from cosmoprimo_tpu_torch.emulators.mlp import MLP, flax_variables, load_flax_variables, make_adam, make_train_step
    rng = np.random.default_rng(seed)
    weights, stats = mlp_weights(rng, [nin, *nhidden, nout], 'silu', False)
    X, Y = rng.uniform(size=(4 * batch, nin)), rng.normal(size=(4 * batch, nout))
    out = {}
    for dev in (device, 'cpu'):
        model = load_flax_variables(MLP(nin, nhidden + (nout,), ('silu',) * len(nhidden), device=dev), weights, stats)
        step = make_train_step(model, make_adam(model, 1e-3), 1e-3)
        x, y = torch.from_numpy(X).to(dev), torch.from_numpy(Y).to(dev)
        model.train()
        for i in range(steps):
            sl = slice(batch * (i % 4), batch * (i % 4 + 1))
            step(x[sl], y[sl])
        out[str(dev)] = flax_variables(model)[0]
    got, ref = out[str(device)], out['cpu']
    return max(float(np.max(np.abs(got[layer][leaf] - ref[layer][leaf])) / np.max(np.abs(ref[layer][leaf])))
               for layer in ref for leaf in ref[layer])


def training(fftlog_kernel, rng, card):
    """Phase 23: sample, fit and serve the 'native-base' recipe through the
    port's CLI on the card (see the module docstring). Returns the kernel's
    launches in the fourier serve."""
    import os
    import shutil
    import tempfile
    from cosmoprimo_tpu_torch import Cosmology
    from cosmoprimo_tpu_torch.emulators import EmulatedEngine, get_calculator
    from cosmoprimo_tpu_torch.emulators.samples import CHUNK_SIZE
    from cosmoprimo_tpu_torch.emulators.train import train_boltzmann
    from cosmoprimo_tpu_torch.fiducial import DESI
    directory = tempfile.mkdtemp()
    try:
        # (a) sample the thermodynamics on the native engine, batch-first
        thermo = ['--recipe', 'native-base', '--section', 'thermodynamics', '--outdir', directory]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        samples = train_boltzmann.main(['--todo', 'sample', '--stop', str(N_TRAIN_THERMO)] + thermo)
        sample_s = time.perf_counter() - t0
        names = samples.columns('Y.*')
        check(samples.size == N_TRAIN_THERMO and bool(samples.isfinite().all()),
              'the native thermodynamics samples are not all finite')
        print(f'train (a): native-base thermodynamics on the native engine: {samples.size} samples of '
              f'{len(names)} quantities in {sample_s:.2f} s ({samples.size / sample_s:.1f} samples/s; chunks of '
              f'{CHUNK_SIZE}) on {card}', flush=True)
        points = {name[2:]: torch.from_numpy(samples[name][:TRAIN_CHECK]) for name in samples.columns('X.*')}
        ref = get_calculator(DESI(engine='native', device='cpu'), section=['thermodynamics'])(**points)
        errs = {name: float(np.max(np.abs(samples[name][:TRAIN_CHECK] - ref[name[2:]].numpy())
                                   / np.abs(ref[name[2:]].numpy()))) for name in names}
        worst = max(errs, key=errs.get)
        print(f'train (a): {TRAIN_CHECK} samples, card vs CPU: worst {worst} {errs[worst]:.3e} (bar {TRAIN_RTOL:g})',
              flush=True)
        check(errs[worst] <= TRAIN_RTOL, 'the native thermodynamics samples disagree between the card and the CPU')

        # (b) fit with the recipe's schedule, serve the file
        t0 = time.perf_counter()
        emulator = train_boltzmann.main(['--todo', 'fit', '--epochs', str(THERMO_EPOCHS)] + thermo)
        fit_s = time.perf_counter() - t0
        steps, epochs, stages, flat = fit_summary(emulator)
        print(f'train (b): {len(emulator.engines)} nets 10 x 5 tanh, {steps} Adam steps and {epochs} epochs in '
              f'{fit_s:.2f} s ({steps / fit_s:.1f} steps/s, {epochs / fit_s:.1f} epochs/s); stages '
              f'{", ".join(f"{s:.2f}" for s in stages)} s; best validation loss '
              f'{max(min(h["best_loss"] for h in e.history) for e in emulator.engines.values()):.3e} (worst net) on '
              f'{card}', flush=True)
        check(not flat, f'the validation loss did not fall for {flat}')
        box = NATIVE_BASE_SECTIONS['thermodynamics'][0]
        served = Cosmology(engine=EmulatedEngine.read(os.path.join(directory, 'native-base_thermodynamics',
                                                                    'emulator.npy')),
                           **{name: torch.from_numpy(rng.uniform(*limits, B_EMU)).to(DEVICE)
                              for name, limits in box.items()}).get_thermodynamics()
        rs_drag = served.rs_drag
        check(rs_drag.shape == (B_EMU,) and bool(torch.isfinite(rs_drag).all()),
              'the trained thermodynamics emulator does not serve finite values')
        print(f'train (b): served at B={B_EMU}: rs_drag {float(rs_drag.min()):.3f} ... {float(rs_drag.max()):.3f} '
              f'Mpc/h', flush=True)

        # (c) the fourier section at full width
        fourier = ['--recipe', 'native-base', '--section', 'fourier', '--engine', 'eisenstein_hu_nowiggle_variants',
                   '--outdir', directory, '--chunk-size', str(N_TRAIN_FOURIER)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        samples = train_boltzmann.main(['--todo', 'sample', '--stop', str(N_TRAIN_FOURIER)] + fourier)
        sample_s = time.perf_counter() - t0
        gbytes = sum(value.nbytes for value in samples.values()) / 1e9
        print(f'train (c): native-base fourier on eisenstein_hu_nowiggle_variants: {samples.size} samples '
              f'({gbytes:.2f} GB) in {sample_s:.2f} s ({samples.size / sample_s:.1f} samples/s, one call) on {card}',
              flush=True)
        del samples
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        emulator = train_boltzmann.main(['--todo', 'fit', '--epochs', str(FOURIER_EPOCHS)] + fourier)
        fit_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        steps, epochs, stages, flat = fit_summary(emulator)
        widths = sorted({int(np.prod(e.yshape)) for e in emulator.engines.values()})
        train_s = sum(stages)
        print(f'train (c): {len(emulator.engines)} nets 64 x 5 silu (outputs {widths}), {steps} Adam steps and '
              f'{epochs} epochs: fit {fit_s:.2f} s in all (file, operations, nets), the nets {train_s:.2f} s '
              f'({steps / train_s:.1f} steps/s, {epochs / train_s:.1f} epochs/s); stages '
              f'{", ".join(f"{s:.2f}" for s in stages)} s; peak memory {peak_gb:.2f} GB on {card}', flush=True)
        check(not flat, f'the validation loss did not fall for {flat}')
        engine = EmulatedEngine.read(os.path.join(directory, 'native-base_fourier', 'emulator.npy'))
        params = emulator_params(rng, B_EMU, names=list(NATIVE_BASE_SECTIONS['fourier'][0]))
        k = np.geomspace(1e-3, 1.0, 64)

        def serve(values, device):
            cosmo = Cosmology(engine=engine, device=device,
                              **{name: torch.from_numpy(value).to(device) for name, value in values.items()})
            fo = cosmo.get_fourier()
            return {'pk': fo.pk_interpolator()(k, torch.from_numpy(DESI_Z).to(device)), 'sigma8': fo.sigma8_m[..., None]}

        main_run_start()
        out = serve(params, DEVICE)
        torch.cuda.synchronize()
        launches = counters['fftlog.launches']
        note_splines('trained fourier emulator')
        check(launches > 0, 'the trained fourier emulator did not launch the FFTLog kernel')
        check(all(bool(torch.isfinite(value).all()) for value in out.values()),
              'the trained fourier emulator does not serve finite values')
        ref = serve({name: value[:N_COMPARE] for name, value in params.items()}, 'cpu')
        errs = {name: rows_err(out[name][:N_COMPARE], value) for name, value in ref.items()}
        wall = wall_ms(lambda: serve(params, DEVICE))
        print(f'train (c): served at B={B_EMU} in {wall:.3f} ms (median of 5 after a warm-up), kernel launches '
              f'{launches}; card vs CPU, first {N_COMPARE} rows: pk {errs["pk"]:.3e}, sigma8 {errs["sigma8"]:.3e} '
              f'(bar {EMU_RTOL:g})', flush=True)
        check(max(errs.values()) <= EMU_RTOL, 'the trained fourier emulator disagrees between the card and the CPU')

        # (d) Adam steps, card against CPU
        err = adam_card_vs_cpu(DEVICE)
        print(f'train (d): {ADAM_STEPS} Adam steps of a 64 x 5 silu net (8 -> 422) from one init, card vs CPU: '
              f'{err:.3e} of each tensor\'s max (bar {ADAM_RTOL:g})', flush=True)
        check(err <= ADAM_RTOL, 'Adam steps disagree between the card and the CPU')
        return launches
    finally:
        shutil.rmtree(directory, ignore_errors=True)


# ----------------------------------------------------------------------------
# 24-26: slice 6c-6d, parallel fan-out, the wrapper engines and the bindings
# ----------------------------------------------------------------------------

def qmc_calculator(omega_cdm, h):
    """A batch-first calculator on the card: EH distances and sigma8 (the
    FFTLog kernel) of a (omega_cdm, h) chunk."""
    from cosmoprimo_tpu_torch import Cosmology
    cosmo = Cosmology(omega_cdm=omega_cdm, h=h, engine='eisenstein_hu')
    z = torch.tensor(DESI_Z, dtype=torch.float64, device=omega_cdm.device)
    return {'chi': cosmo.get_background().comoving_radial_distance(z), 'sigma8': cosmo.get_fourier().sigma8_m}


def qmc_sampler(comm, device):
    from cosmoprimo_tpu_torch.emulators.samples import QMCSampler
    return QMCSampler(qmc_calculator, {'omega_cdm': (0.10, 0.14), 'h': (0.6, 0.75)}, comm=comm, device=device,
                      chunk_size=N_QMC // 2)


def sharded_fit(mesh, device, nhidden=(64, 64, 64)):
    """The MLP fit of seeded samples (N_FIT x 6 -> 50), with batch
    normalization, on ``mesh`` (None: unsharded on ``device``): its
    exported arrays and epochs."""
    from cosmoprimo_tpu_torch.emulators.mlp import MLPEmulatorEngine
    rng = np.random.default_rng(7)
    X = rng.uniform(size=(N_FIT, 6))
    Y = np.sin(X @ rng.normal(size=(6, 50))) + X[:, :1] ** 2
    engine = MLPEmulatorEngine(nhidden=nhidden, activation='silu')
    engine.initialize([f'x{i}' for i in range(6)], device=device)
    engine._fit_no_operation(X, Y, {}, batch_norm=True, mesh=mesh, **FIT_SCHEDULE)
    return ([value for op in engine.model_operations for value in op._locals.values()],
            [h['epochs'] for h in engine.history])


def parallel_worker(port, nproc, rank, outdir):
    """One rank of phase 24's gloo worlds (python3 chip_smoke.py
    --parallel-worker PORT NPROC RANK OUTDIR): every rank on the one card
    (cuda:(rank mod 1)). Writes its report, the FFTLog launches of its main
    path and, on rank 0, the comparisons, to OUTDIR/rank{RANK}.json."""
    import os
    import torch.distributed as dist
    from cosmoprimo_tpu_torch import make_native_pk_pipeline_batched, make_pk_to_xi_pipeline_batched
    from cosmoprimo_tpu_torch.ops import fftlog_kernel
    from cosmoprimo_tpu_torch.parallel import (FakeComm, TorchDistributedComm, gather_array, get_comm, make_mesh,
                                               rank_device, shard_array)
    nproc, rank = int(nproc), int(rank)
    dist.init_process_group('gloo', init_method=f'tcp://localhost:{port}', world_size=nproc, rank=rank)
    report = {'rank': rank, 'errors': {}, 'walls': {}}
    try:
        device = rank_device()
        check(device == torch.device('cuda', 0), f'rank {rank} is not on the one card: {device}')
        # the communicator's collectives and point-to-point
        comm = get_comm()
        check(isinstance(comm, TorchDistributedComm) and comm.Get_size() == nproc, 'get_comm is not the torch one')
        got = comm.bcast({'a': np.arange(5.0)} if rank == 0 else None, root=0)
        check(np.array_equal(got['a'], np.arange(5.0)), 'bcast')
        check(comm.allgather(rank) == list(range(nproc)), 'allgather')
        check(comm.scatter([r * 2 for r in range(nproc)] if rank == 1 else None, root=1) == 2 * rank, 'scatter')
        check(comm.gather(rank, root=0) == (list(range(nproc)) if rank == 0 else None), 'gather')
        check(comm.allreduce_sum(rank + 1) == nproc * (nproc + 1) // 2, 'allreduce_sum')
        if rank == 1:
            comm.send('x', dest=0, tag=3)
        else:
            check(comm.recv(source=1, tag=3) == ('x' if rank == 0 else None), 'send/recv')
        comm.barrier()
        t0 = time.perf_counter()
        main_run_start()
        if nproc == 2:
            mesh = make_mesh()
            rng = np.random.default_rng(24)
            params = {'headline': cosmo_params(rng, B), 'halofit': cosmo_params(rng, B_HALOFIT),
                      'mead': cosmo_params(rng, B_HMCODE), 'native': cosmo_params(rng, B_NATIVE_CHECK)}
            fns = {'headline': make_pk_to_xi_pipeline_batched(nk=NK, z=[0.0])[0],
                   'halofit': make_pk_to_xi_pipeline_batched(nk=NK, z=[0.0], non_linear='halofit')[0],
                   'mead': make_pk_to_xi_pipeline_batched(nk=NK_HMCODE, z=[0.0], non_linear='mead')[0],
                   'native': make_native_pk_pipeline_batched(nk=NK_NATIVE, kmax=0.5, z=(0.0, 1.0))[0]}
            samples = qmc_sampler(comm, device).run(niterations=N_QMC)
            gathered = {}
            for name, fn in fns.items():
                t1 = time.perf_counter()
                gathered[name] = [gather_array(out, mesh) for out in fn(*[shard_array(p, mesh) for p in params[name]])]
                torch.cuda.synchronize()
                report['walls'][name] = time.perf_counter() - t1
            fits = {shape: sharded_fit(make_mesh(shape=shape), device) for shape in ((2, 1), (1, 2))}
        else:
            fits = {(2, 2): sharded_fit(make_mesh(shape=(2, 2)), device)}
        torch.cuda.synchronize()
        report['launches'] = counters['fftlog.launches']
        report['spline_launches'] = counters['spline.launches']
        report['walls']['main path'] = time.perf_counter() - t0
        for shape, (arrays, epochs) in fits.items():
            report[f'fit {shape} epochs'] = epochs
        if rank == 0:   # the unsharded references, on the same card
            arrays_ref, epochs_ref = sharded_fit(None, device)
            for shape, (arrays, epochs) in fits.items():
                check(epochs == epochs_ref, f'the fit on mesh {shape} stopped at {epochs}, unsharded {epochs_ref}')
                report['errors'][f'fit {shape}'] = max(float(np.max(np.abs(a - r)) / np.max(np.abs(r)))
                                                       for a, r in zip(arrays, arrays_ref))
            report['fit epochs'] = epochs_ref
            if nproc == 2:
                ref = qmc_sampler(FakeComm(), device).run(niterations=N_QMC)
                check(set(ref) == set(samples), 'the fan-out gathered other columns')
                report['errors']['qmc'] = max(float(np.max(np.abs(samples[name] - ref[name]))) for name in ref)
                for name, fn in fns.items():
                    outputs = fn(*[torch.from_numpy(p).to(device) for p in params[name]])
                    report['errors'][name] = [rel_err(got.reshape(len(got), -1), out.reshape(len(out), -1))
                                              for got, out in zip(gathered[name], outputs)]
    finally:
        dist.destroy_process_group()
    with open(os.path.join(outdir, f'rank{rank}.json'), 'w') as f:
        json.dump(report, f)
    return 0


def run_world(nproc, timeout):
    """Phase 24: ``nproc`` ranks of this script's parallel worker; raises
    with the output of any rank that fails. Returns the ranks' reports."""
    import os
    import socket
    import tempfile
    with socket.socket() as s:
        s.bind(('localhost', 0))
        port = s.getsockname()[1]
    outdir = tempfile.mkdtemp()
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, 'PYTHONPATH': here + os.pathsep + os.environ.get('PYTHONPATH', '')}
    logs = [open(os.path.join(outdir, f'rank{rank}.log'), 'w') for rank in range(nproc)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), '--parallel-worker', str(port), str(nproc),
                               str(rank), outdir], stdout=log, stderr=subprocess.STDOUT, env=env)
             for rank, log in enumerate(logs)]
    deadline = time.perf_counter() + timeout
    try:
        while time.perf_counter() < deadline and any(p.poll() is None for p in procs):
            time.sleep(0.2)
            if any(p.poll() not in (None, 0) for p in procs):
                break   # a rank failed: the others may wait for it
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    outputs = []
    for rank in range(nproc):
        with open(os.path.join(outdir, f'rank{rank}.log')) as f:
            outputs.append(f.read())
    for rank, (p, out) in enumerate(zip(procs, outputs)):
        check(p.returncode == 0, f'rank {rank} of {nproc} failed (exit {p.returncode}; killed after {timeout} s or '
                                 f'when a rank failed):\n{out[-3000:]}')
    reports = []
    for rank in range(nproc):
        with open(os.path.join(outdir, f'rank{rank}.json')) as f:
            reports.append(json.load(f))
    return reports


def parallel(card):
    """Phase 24: gloo worlds of 2 and 2 x 2 ranks on the one card. Returns
    the FFTLog launches of the ranks' main paths."""
    t0 = time.perf_counter()
    reports = run_world(2, timeout=PARALLEL_TIMEOUT)
    wall2 = time.perf_counter() - t0
    errors = reports[0]['errors']
    launches = sum(r['launches'] for r in reports)
    SPLINE_LAUNCHES['parallel, 2 ranks'] = sum(r['spline_launches'] for r in reports)
    print(f'parallel (2 ranks, gloo; both on the one card: NCCL refuses two ranks on one device): the '
          f'collectives and point-to-point ok; QMC fan-out of {N_QMC} points against one process, max |d| '
          f'{errors["qmc"]:.3e} (bar 0: the same chunks); world wall {wall2:.1f} s, rank walls '
          f'{", ".join(f"{name} {w:.2f} s" for name, w in reports[0]["walls"].items())} on {card}', flush=True)
    check(errors['qmc'] == 0.0, 'the QMC fan-out differs from one process')
    bars = {'headline': (XI_BAR, CHI_SIGMA8_RTOL, CHI_SIGMA8_RTOL), 'halofit': (XI_BAR, CHI_SIGMA8_RTOL, CHI_SIGMA8_RTOL),
            'mead': (XI_BAR, CHI_SIGMA8_RTOL, CHI_SIGMA8_RTOL), 'native': (NATIVE_RTOL, NATIVE_RTOL)}
    for name, bar in bars.items():
        print(f'parallel: dp-sharded {name} ({", ".join(f"{e:.3e}" for e in errors[name])} of each row\'s max against '
              f'the unsharded run on the card; bars {", ".join(f"{b:g}" for b in bar)})', flush=True)
        check(all(e <= b for e, b in zip(errors[name], bar)), f'the dp-sharded {name} disagrees with the unsharded run')
    t0 = time.perf_counter()
    reports4 = run_world(4, timeout=PARALLEL_TIMEOUT)
    wall4 = time.perf_counter() - t0
    errors.update(reports4[0]['errors'])
    for shape in ('(2, 1)', '(1, 2)', '(2, 2)'):
        print(f'parallel: MLP fit on mesh {shape} (dp, tp), {N_FIT} samples, 64 x 3 silu with batch '
              f'normalization: {errors[f"fit {shape}"]:.3e} of each array\'s max against the unsharded fit on the card '
              f'(bar {FIT_RTOL:g}), epochs {reports[0]["fit epochs"] if shape != "(2, 2)" else reports4[0]["fit epochs"]}',
              flush=True)
        check(errors[f'fit {shape}'] <= FIT_RTOL, f'the sharded fit on mesh {shape} disagrees')
    print(f'parallel: 2 x 2 world (4 ranks on the one card) wall {wall4:.1f} s; kernel launches of the 2-rank '
          f'main path {launches}', flush=True)
    return launches


def stub_host_modules():
    """Phase 25's own stub ``pyclass`` and ``camb`` modules (with the
    variants' names): numpy tables made by the port's EH engine on CPU
    tensors, so that the wrapper engines run without the host codes and
    without JAX. Returns {module name: module}."""
    import types
    from cosmoprimo_tpu_torch import Cosmology, constants

    def truth(h, omega_cdm, omega_b, A_s=None, sigma8=None, n_s=0.96):
        amplitude = {'A_s': A_s} if A_s is not None else {'sigma8': 0.8 if sigma8 is None else sigma8}
        return Cosmology(h=h, omega_cdm=omega_cdm, omega_b=omega_b, n_s=n_s, engine='eisenstein_hu', device='cpu',
                         **amplitude)

    def npy(value):
        return value.numpy() if isinstance(value, torch.Tensor) else np.asarray(value, dtype=np.float64)

    k_h, z_pk = np.geomspace(1e-4, 10.0, 200), np.array([0.0, 0.5, 1.0, 2.0])
    scale = {'delta_tot': 1.0, 'delta_m': 1.0, 'delta_nonu': 1.05, 'delta_cb': 1.05, 'v_newtonian_cdm': 0.8,
             'v_newtonian_baryon': 0.6, 'Weyl': 3.0}

    def pk_table(cosmo, non_linear=False):
        pk = npy(cosmo.get_fourier().pk_interpolator()(k_h, z_pk))
        return pk * (1.0 + 0.1 * k_h[:, None] / (1.0 + k_h[:, None])) if non_linear else pk

    def cl_array(ellmax, names, amp=1e-10):
        ell = np.arange(ellmax + 1)
        out = np.empty(ellmax + 1, dtype=[('ell', np.int64)] + [(n, np.float64) for n in names])
        out['ell'] = ell
        for i, n in enumerate(names):
            out[n] = amp * (i + 1) / (ell * (ell + 1.0) + 1.0)
        return out

    def structured(**columns):
        out = np.empty(len(next(iter(columns.values()))), dtype=[(name, np.float64) for name in columns])
        for name, value in columns.items():
            out[name] = value
        return out

    class ClassInputError(Exception):
        pass

    class ClassComputationError(Exception):
        pass

    class ClassEngine(object):
        def __init__(self, params=None):
            self.params = dict(params or {})
            h = float(self.params['h'])
            self.h = h
            self.cosmo = truth(h, float(self.params['Omega_cdm']) * h ** 2, float(self.params['Omega_b']) * h ** 2,
                               A_s=self.params.get('A_s'), sigma8=self.params.get('sigma8'),
                               n_s=float(self.params.get('n_s', 0.96)))
            self.ba = self.cosmo.get_background()

        def compute(self, tasks):
            pass

        def get_background(self):
            ba = self.ba

            def table():
                z = np.geomspace(1e-3, 100.0, 64)[::-1].copy()
                H = npy(ba.hubble_function(z)) / (constants.c / 1e3)
                fb = float(self.cosmo['Omega_b'] / self.cosmo['Omega_m'])
                rho_m, rho_de = H ** 2 * npy(ba.Omega_m(z)), H ** 2 * npy(ba.Omega_de(z))
                return structured(**{'z': z, 'H [1/Mpc]': H, '(.)rho_b': rho_m * fb, '(.)rho_cdm': rho_m * (1 - fb),
                                     '(.)rho_fld': rho_de})

            return types.SimpleNamespace(
                efunc=lambda z: npy(ba.efunc(z)), comoving_radial_distance=lambda z: npy(ba.comoving_radial_distance(z)),
                time=lambda z: npy(ba.time(z)), growth_factor=lambda z: npy(ba.growth_factor(z)),
                growth_rate=lambda z: npy(ba.growth_rate(z)),
                comoving_sound_horizon=lambda z: 100.0 * np.sqrt(1090.0 / np.maximum(np.asarray(z, dtype=float), 1.0)),
                table=table)

        def get_thermodynamics(self):
            th = self.cosmo.get_thermodynamics()
            tau = float(self.params.get('tau_reio', 0.06))

            def table():
                z = np.linspace(0.0, 2000.0, 512)
                return structured(**{'z': z, 'exp(-kappa)': np.exp(-(tau * (z < 50.0) + (z / 1100.0) ** 8))})

            return types.SimpleNamespace(rs_drag=float(th.rs_drag) / self.h, z_drag=float(th.z_drag),
                                         rs_star=0.98 * float(th.rs_drag) / self.h, z_star=1100.0, tau_reio=tau,
                                         z_reio=7.7, YHe=0.245, table=table)

        def get_primordial(self):
            return types.SimpleNamespace(A_s=float(self.params.get('A_s', 2.1e-9)))

        def get_perturbations(self):
            k = np.geomspace(1e-3, 1.0, 16)
            return types.SimpleNamespace(table=lambda: structured(k=k, delta_cdm=-k ** 0.5))

        def get_transfer(self):
            k = np.geomspace(1e-4, 10.0, 32)
            tk = npy(self.cosmo.get_transfer().transfer_k(torch.from_numpy(k)))
            return types.SimpleNamespace(table=lambda z=0.0: structured(k=k, d_cdm=tk / (1 + z), d_b=0.9 * tk / (1 + z)))

        def get_harmonic(self):
            names = ['tt', 'ee', 'bb', 'te']
            return types.SimpleNamespace(
                unlensed_cl=lambda ellmax=-1: cl_array(ellmax, names),
                lensed_cl=lambda ellmax=-1: cl_array(ellmax, names, amp=1.1e-10),
                lens_potential_cl=lambda ellmax=-1: cl_array(ellmax, ['pp', 'tp', 'ep'], amp=1e-12),
                unlensed_table=lambda ellmax=-1, of=None: cl_array(ellmax, list(of) if of else names),
                lensed_table=lambda ellmax=-1, of=None: cl_array(ellmax, list(of) if of else names, amp=1.1e-10))

        def get_fourier(self):
            sigma8 = float(self.cosmo.get_fourier().sigma8_m)

            def table(non_linear='', of='delta_m'):
                of = (of, of) if isinstance(of, str) else of
                return k_h, z_pk, pk_table(self.cosmo, bool(non_linear)) * scale[of[0]] * scale[of[1]]

            return types.SimpleNamespace(table=table, sigma8_m=sigma8, sigma8_cb=1.005 * sigma8)

    pyclass = types.ModuleType('pyclass')
    modules = {'pyclass': pyclass}
    for name in ('', 'axiclass', 'mochiclass', 'negnuclass', 'dsclass'):
        module = types.ModuleType(f'pyclass.{name}') if name else pyclass
        module.ClassEngine, module.ClassInputError, module.ClassComputationError = (ClassEngine, ClassInputError,
                                                                                   ClassComputationError)
        if name:
            setattr(pyclass, name, module)
            modules[f'pyclass.{name}'] = module

    class CAMBError(Exception):
        pass

    transfer_names = ['k/h', 'delta_cdm', 'delta_baryon', 'delta_tot', 'delta_nonu', 'Weyl', 'v_newtonian_cdm',
                      'v_newtonian_baryon']

    class CAMBparams(object):
        def __init__(self):
            self.InitPower = types.SimpleNamespace(As=2.1e-9, ns=0.96, nrun=0.0, nrunrun=0.0, pivot_scalar=0.05,
                                                   pivot_tensor=0.05, r=0.0, nt=0.0, ntrun=0.0)
            self.Reion = types.SimpleNamespace(optical_depth=0.06, delta_redshift=0.5)
            self.NonLinear, self.NonLinearModel, self.DoLensing, self.Want_CMB_lensing = 0, None, False, False
            self.H0, self.ombh2, self.omch2, self.YHe, self.zrei = 70.0, 0.022, 0.12, 0.245, 7.7
            self.redshifts, self.EFTCAMB, self.extra = np.array([0.0]), object(), {}

        def get_zrei(self):
            return self.zrei

        def primordial_power(self, k, index):
            ip = self.InitPower
            if index != 0:
                return np.zeros_like(np.asarray(k))
            lnk = np.log(np.asarray(k) / ip.pivot_scalar)
            return ip.As * np.exp((ip.ns - 1.0 + 0.5 * ip.nrun * lnk + ip.nrunrun * lnk ** 2 / 6.0) * lnk)

    def set_params(pars, **kwargs):
        for name, value in kwargs.items():
            if name in vars(pars.InitPower):
                setattr(pars.InitPower, name, value)
            elif name == 'tau':
                pars.Reion.optical_depth = value
            elif hasattr(pars, name) and not (name == 'YHe' and value is None):
                setattr(pars, name, value)
            elif name != 'YHe':
                pars.extra[name] = value
        return pars

    class CAMBdata(object):
        def __init__(self, pars=None, no_thermo=True):
            if pars is not None:
                self.calc_power_spectra(pars)

        def calc_power_spectra(self, pars=None):
            self.Params, self.h = pars, pars.H0 / 100.0
            self.cosmo = truth(self.h, pars.omch2, pars.ombh2, A_s=pars.InitPower.As, n_s=pars.InitPower.ns)
            self.ba = self.cosmo.get_background()
            self.transfer_redshifts = np.sort(np.asarray(pars.redshifts))

        _names = {'K': 'k', 'cdm': 'cdm', 'baryon': 'b', 'photon': 'g', 'neutrino': 'ur', 'nu': 'ncdm_tot', 'de': 'de'}

        def get_Omega(self, var, z=0.0):
            return npy(getattr(self.ba, 'Omega_' + self._names[var])(np.asarray(z, dtype=float)))

        def get_background_densities(self, a, vars=()):
            z = 1.0 / np.asarray(a, dtype=float) - 1.0
            RH0 = constants.rho_crit_over_Msunph_per_Mpcph3 * constants.c ** 2 / (self.Params.H0 * 1e3) ** 2 / 3.0
            return {var: npy(getattr(self.ba, 'rho_' + self._names[var])(z)) / RH0 / (1.0 + z) for var in vars}

        def hubble_parameter(self, z):
            return npy(self.ba.hubble_function(np.asarray(z, dtype=float)))

        def physical_time(self, z):
            return float(self.ba.time(float(z)))

        def comoving_radial_distance(self, z):
            return npy(self.ba.comoving_radial_distance(np.asarray(z, dtype=float))) / self.h

        def angular_diameter_distance(self, z):
            return npy(self.ba.angular_diameter_distance(np.asarray(z, dtype=float))) / self.h

        def luminosity_distance(self, z):
            return npy(self.ba.luminosity_distance(np.asarray(z, dtype=float))) / self.h

        def get_derived_params(self):
            th = self.cosmo.get_thermodynamics()
            return {'rdrag': float(th.rs_drag) / self.h, 'zdrag': float(th.z_drag), 'zstar': 1089.0, 'age': 13.8}

        def sound_horizon(self, z):
            return 100.0 * np.sqrt(1090.0 / np.maximum(np.asarray(z, dtype=float), 1.0)) / self.h / 0.7

        def cosmomc_theta(self):
            return 0.0104

        def get_background_redshift_evolution(self, z, vars=()):
            z = np.asarray(z, dtype=float)
            dtau_dz = 8.0 / 1100.0 * (np.maximum(z, 1e-10) / 1100.0) ** 7.0
            return {'opacity': dtau_dz / np.maximum(np.gradient(self.comoving_radial_distance(z), z), 1e-30)}

        def get_matter_transfer_data(self):
            k = np.geomspace(1e-4, 10.0, 32)
            tk = npy(self.cosmo.get_transfer().transfer_k(torch.from_numpy(k)))
            z = self.transfer_redshifts
            data = np.stack([k[:, None] * np.ones_like(z)] + [tk[:, None] * (1.0 + 0.01 * i) / (1.0 + z)
                                                              for i in range(1, len(transfer_names))])
            return types.SimpleNamespace(transfer_data=data)

        def get_linear_matter_power_spectrum(self, var1='delta_tot', var2='delta_tot', hubble_units=True,
                                             k_hunit=True, have_power_spectra=True, nonlinear=False):
            k, pk = k_h * self.h, pk_table(self.cosmo, nonlinear) / self.h ** 3
            factor = 1.0
            for var in (var1, var2):
                factor = factor * (scale[var] * k[:, None] ** 2 / 2.0 if var == 'Weyl' else scale[var])
            pk = pk * factor
            return (k / self.h if k_hunit else k), z_pk, (pk * self.h ** 3 if hubble_units else pk).T

        def get_sigma8(self):
            s8 = float(self.cosmo.get_fourier().sigma8_m)
            return np.array([s8 * (1.0 + 0.01 * i) for i in range(len(self.transfer_redshifts))])[::-1]

        def get_unlensed_total_cls(self, lmax=None, CMB_unit=None, raw_cl=True):
            ell = np.arange(lmax + 1)
            return np.stack([1e-10 * (i + 1) / (ell * (ell + 1.0) + 1.0) for i in range(4)], axis=-1)

        def get_total_cls(self, lmax=None, CMB_unit=None, raw_cl=True):
            return 1.1 * self.get_unlensed_total_cls(lmax=lmax)

        def get_lens_potential_cls(self, lmax=None, CMB_unit=None, raw_cl=True):
            ell = np.arange(lmax + 1)
            return np.stack([1e-12 * (i + 1) / (ell * (ell + 1.0) + 1.0) ** 2 for i in range(3)], axis=-1)

        def get_fQ_growth_rate(self, z=0.0):
            return 1.01 * npy(self.ba.growth_rate(np.asarray(z, dtype=float)))

        def get_growth_factor(self, z=0.0):
            return npy(self.ba.growth_factor(np.asarray(z, dtype=float)))

    camb = types.ModuleType('camb')
    camb.CAMBparams, camb.CAMBdata, camb.set_params, camb.CAMBError = CAMBparams, CAMBdata, set_params, CAMBError
    camb.get_background = lambda pars, no_thermo=True: CAMBdata(pars)
    camb.get_transfer_functions = lambda pars: CAMBdata(pars)
    camb.baseconfig = types.SimpleNamespace(CAMBError=CAMBError, CAMBParamRangeError=CAMBError,
                                            CAMBValueError=CAMBError, CAMBUnknownArgumentError=CAMBError)
    camb.model = types.SimpleNamespace(NonLinear_none=0, NonLinear_both=2, transfer_names=transfer_names)
    camb.nonlinear = types.SimpleNamespace(Halofit=lambda: types.SimpleNamespace(set_params=lambda **kw: None))
    camb.dark_energy = types.SimpleNamespace(DarkEnergyPPF=object, DarkEnergyFluid=object)
    modules.update({name: camb for name in ('camb', 'isitgr', 'mgcamb', 'isitide', 'heftcamb')})
    return modules


def section_outputs(cosmo, camb):
    """Every section's outputs of a wrapper-engine cosmology (tensors, or
    host floats and tables)."""
    z, k, zq = DESI_Z, np.geomspace(1e-3, 5.0, 64), np.array([0.0, 0.5, 1.0])
    ba, th, pm = cosmo.get_background(), cosmo.get_thermodynamics(), cosmo.get_primordial()
    fo, hr, tr = cosmo.get_fourier(), cosmo.get_harmonic(), cosmo.get_transfer()
    out = {name: getattr(ba, name)(z) for name in ('efunc', 'hubble_function', 'comoving_radial_distance', 'time',
                                                   'growth_factor', 'growth_rate', 'angular_diameter_distance',
                                                   'luminosity_distance', 'Omega_m', 'Omega_de', 'rho_cdm')}
    out.update({'growth_factor cb': ba.growth_factor(z, mass='cb'), 'age': ba.age})
    out.update({name: getattr(th, name) for name in ('rs_drag', 'z_drag', 'z_star', 'rs_star', 'theta_star',
                                                     'z_star_noreion', 'rs_star_noreion', 'theta_cosmomc')})
    out.update({'A_s': pm.A_s, 'pk_k': pm.pk_k(k)})
    of = ('delta_m', 'delta_cb', 'theta_cb', 'phi_plus_psi') if camb else ('delta_m', 'delta_cb')
    out.update({f'pk {name}': fo.pk_interpolator(of=name)(k, zq) for name in of})
    out.update({'sigma8_m': fo.sigma8_m, 'sigma_rz': fo.sigma_rz(np.array([8.0, 12.0]), zq),
                'xi': fo.pk_interpolator().to_xi()(np.geomspace(10.0, 150.0, 32), zq)})
    if cosmo['lensing']:
        out.update({f'cl {key}': value for key, value in hr.lensed_cl(ellmax=500).items() if key != 'ell'})
    out.update({f'unlensed {key}': value for key, value in hr.unlensed_cl(ellmax=500).items() if key != 'ell'})
    table = tr.table() if camb else tr.table(0.0)
    out.update({f'transfer {name}': table[name] for name in table.dtype.names})
    if not camb:
        out['perturbations'] = cosmo.get_perturbations().table()['delta_cdm']
    return out


def wrapper_engines(fftlog_kernel, card):
    """Phase 25: every section of the CLASS and CAMB wrapper engines and
    their variants on the card, against the same engine on CPU tensors,
    through phase 25's stub host modules. Returns the FFTLog launches of
    the card's runs."""
    t0 = time.perf_counter()
    modules = stub_host_modules()
    saved = {name: sys.modules.get(name) for name in modules}
    sys.modules.update(modules)
    from cosmoprimo_tpu_torch import Cosmology
    base = dict(omega_cdm=0.12, omega_b=0.02237, h=0.6736, n_s=0.9649)
    cases = [('class', dict(A_s=2.083e-9)), ('class', dict(sigma8=0.78, lensing=True)),
             ('axiclass', dict(A_s=2.083e-9, extra_params={'scf_parameters__1': 2.7, 'scf_parameters__2': 0.0})),
             ('mochiclass', dict(A_s=2.083e-9)), ('negnuclass', dict(A_s=2.083e-9)),
             ('dsclass', dict(A_s=2.083e-9, xi_ds=0.5)),
             ('camb', dict(A_s=2.083e-9, lensing=True, z_pk=[0.0, 0.5, 1.0, 2.0])),
             ('camb', dict(sigma8=0.78, z_pk=[0.0, 0.5, 1.0, 2.0])), ('isitgr', dict(A_s=2.083e-9, mu0=0.1)),
             ('mgcamb', dict(A_s=2.083e-9, B1=1.5)), ('isitide', dict(A_s=2.083e-9, z_pk=[0.0, 1.0])),
             ('heftcamb', dict(A_s=2.083e-9, extra_params={'RPH_braiding0': 0.2}))]
    launches, worst, host = 0, (0.0, ''), []
    try:
        for name, kwargs in cases:
            camb = name not in ('class', 'axiclass', 'mochiclass', 'negnuclass', 'dsclass')
            main_run_start()
            out = section_outputs(Cosmology(engine=name, device=DEVICE, **base, **kwargs), camb)
            torch.cuda.synchronize()
            check(counters['fftlog.launches'] > 0, f'engine {name!r} did not launch the FFTLog kernel')
            launches += counters['fftlog.launches']
            SPLINE_LAUNCHES['wrapper engines'] = SPLINE_LAUNCHES.get('wrapper engines', 0) + counters['spline.launches']
            ref = section_outputs(Cosmology(engine=name, device='cpu', **base, **kwargs), camb)
            for key, value in ref.items():
                got = out[key]
                if isinstance(got, torch.Tensor):
                    check(got.device.type == 'cuda', f'{name} {key} is not on the card')
                    got = got.cpu()
                elif isinstance(value, torch.Tensor) or key.startswith(('pk ', 'xi', 'sigma_rz', 'cl ')):
                    host.append(f'{name} {key}')
                got, value = np.asarray(got, dtype=np.float64), np.asarray(value, dtype=np.float64)
                err = float(np.max(np.abs(got - value)) / max(np.max(np.abs(value)), 1e-300))
                check(got.shape == value.shape and np.isfinite(got).all(), f'{name} {key}: shape or finite')
                worst = max(worst, (err, f'{name} {key}'))
        check(not host, f'tables served from the host instead of the card: {host}')
    finally:
        for name, module in saved.items():
            if module is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = module
    print(f'wrapper engines: {len(cases)} cases of class, camb and their variants, every section on the card against '
          f'the same engine on CPU tensors: worst {worst[1]} {worst[0]:.3e} (bar {WRAPPER_RTOL:g}); kernel launches '
          f'{launches}; wall {time.perf_counter() - t0:.1f} s on {card}', flush=True)
    check(worst[0] <= WRAPPER_RTOL, 'a wrapper engine disagrees between the card and the CPU')
    return launches


def bindings(card):
    """Phase 26: the cobaya theory (without cobaya) and the cosmosis module
    (a stub datablock) through a cosmology on the card, against the CPU;
    the frameworks get numpy."""
    import types
    from cosmoprimo_tpu_torch import Cosmology
    from cosmoprimo_tpu_torch.bindings.cobaya.cosmoprimo_tpu_torch import CosmoprimoTPUTorch
    from cosmoprimo_tpu_torch.bindings.cosmosis import cosmoprimo_tpu_torch_interface as iface
    t0 = time.perf_counter()
    z = np.array([0.3, 0.8, 1.4])
    states = []
    for device in (DEVICE, 'cpu'):
        theory = CosmoprimoTPUTorch.__new__(CosmoprimoTPUTorch)
        theory._base_cosmo = Cosmology(engine='eisenstein_hu', device=device, omega_cdm=0.12, omega_b=0.02237,
                                       h=0.6736, A_s=2.083e-9, n_s=0.9649)
        theory.output_params, theory.log = ['omegam', 'rdrag'], None
        theory.must_provide({('Pk_grid', False, 'delta_tot', 'delta_tot'): {'k_max': 2.0, 'z': z, 'nonlinear': False},
                             ('sigma_R', 'delta_tot', 'delta_tot'): {'k_max': 2.0, 'z': z, 'R': np.array([8.0, 12.0])}},
                            Hubble={'z': z}, angular_diameter_distance={'z': z}, sigma8_z={'z': z},
                            fsigma8={'z': z})
        state = {}
        check(theory.calculate(state, want_derived=True, omega_cdm=0.121) is True, 'cobaya calculate')
        theory.current_state = state
        state = {key: value for key, value in state.items() if key != 'cosmo'}
        state['getters'] = (theory.get_Hubble(z), theory.get_comoving_radial_distance(z), theory.get_sigma8_z(z),
                            theory.get_fsigma8(z), theory.get_rs_drag())
        cosmosis = types.ModuleType('cosmosis')
        cosmosis.datablock = types.ModuleType('cosmosis.datablock')
        cosmosis.datablock.names = types.SimpleNamespace(cosmological_parameters='cosmological_parameters',
                                                         distances='distances', growth_parameters='growth',
                                                         cmb_cl='cmb_cl')
        cosmosis.datablock.option_section = 'module_options'
        saved = {name: sys.modules.get(name) for name in ('cosmosis', 'cosmosis.datablock')}
        sys.modules.update({'cosmosis': cosmosis, 'cosmosis.datablock': cosmosis.datablock})
        try:
            options = {'fourier': True, 'nz': 20, 'device': '' if device == DEVICE else 'cpu'}
            getter = types.SimpleNamespace(**{f'get_{kind}': (lambda s, n, default=None: options.get(n, default))
                                              for kind in ('string', 'double', 'int', 'bool')})
            config = iface.setup(getter)
            check(config['base'].device.type == torch.device(device).type, 'cosmosis setup ignored the device')

            class Block(dict):
                def has_value(self, section, name):
                    return (section, name) in self

                def put_grid(self, section, zname, zz, kname, k, pname, p):
                    self.update({(section, zname): zz, (section, kname): k, (section, pname): p})

            block = Block({('cosmological_parameters', name): value for name, value in
                           dict(h0=0.6736, omega_b=0.0493, omega_c=0.2645, n_s=0.9649, a_s=2.083e-9).items()})
            check(iface.execute(block, config) == 0 and iface.cleanup(config) == 0, 'cosmosis execute')
            state['cosmosis'] = dict(block)
        finally:
            for name, module in saved.items():
                if module is None:
                    sys.modules.pop(name, None)
                else:
                    sys.modules[name] = module
        states.append(state)

    def leaves(tree, prefix=''):
        if isinstance(tree, dict):
            for key, value in tree.items():
                yield from leaves(value, f'{prefix} {key}')
        elif isinstance(tree, (tuple, list)):
            for i, value in enumerate(tree):
                yield from leaves(value, f'{prefix}[{i}]')
        else:
            yield prefix, tree

    got, ref = dict(leaves(states[0])), dict(leaves(states[1]))
    check(set(got) == set(ref), 'the bindings gave other products on the card')
    worst = (0.0, '')
    for key, value in ref.items():
        check(not isinstance(got[key], torch.Tensor), f'binding product {key} is a tensor, not numpy')
        g, r = np.asarray(got[key], dtype=np.float64), np.asarray(value, dtype=np.float64)
        finite = np.isfinite(r)
        check(g.shape == r.shape and np.array_equal(np.isfinite(g), finite), f'binding product {key}')
        if finite.any():
            worst = max(worst, (float(np.max(np.abs(g[finite] - r[finite])) / max(np.max(np.abs(r[finite])), 1e-300)),
                                key))
    print(f'bindings: cobaya theory (collectors, calculate, getters) and cosmosis execute through a cosmology on the '
          f'card, {len(ref)} products, numpy, against the CPU: worst{worst[1]} {worst[0]:.3e} (bar {WRAPPER_RTOL:g}); '
          f'wall {time.perf_counter() - t0:.1f} s on {card}', flush=True)
    check(worst[0] <= WRAPPER_RTOL, 'the bindings disagree between the card and the CPU')


def api_surface(fftlog_kernel, rng, card):
    """Phase 27: the public API surface on the card. Returns the kernel's
    launches in its main-path runs: the forward and inverted transforms, the
    engine names and the quickstart on the card."""
    from cosmoprimo_tpu_torch import CorrelationToPower, PowerToCorrelation, quickstart
    from cosmoprimo_tpu_torch.ops import gamma, gauss_legendre, loggamma, odeint
    from scipy import special
    t0 = time.perf_counter()
    dev = torch.device(DEVICE)
    # (a) PowerToCorrelation at the headline shape, then inv()
    k = np.geomspace(1e-5, 1e2, NK)
    k_dev = torch.from_numpy(k).to(dev)
    pk = pk_like(k_dev, torch.from_numpy(rng.uniform(0.5, 2.0, B)).to(dev),
                 torch.from_numpy(rng.uniform(0.9, 1.0, B)).to(dev)).contiguous()
    fft = PowerToCorrelation(k)
    fresh = PowerToCorrelation(k)
    fresh.inv()
    errs = {}

    def against_plain(name, transform, x):
        """The kernel against plain per row, of each row's max before the
        postfactor (the bar) and after it. The inverted postfactor k^-1.5
        spans 21 decades of the padded grid and scales each column's rounding
        by as much: two CPU FFT libraries differ by 3.2e-10 of a row's max
        after it, by 6.4e-16 before it."""
        arrays = transform._arrays(dev)
        args = (arrays['padded_u'], arrays['padded_prefactor'], arrays['padded_postfactor'],
                transform.padded_size_in_left, transform.padded_size_out_left)
        got, ref = fftlog_kernel.fftlog_core(x, *args), fftlog_kernel.fftlog_core_torch(x, *args)
        left = transform.padded_size_out_left
        post = arrays['padded_postfactor'][:, left:left + x.shape[-1]]
        errs[name] = (rel_err(got / post, ref / post), rel_err(got, ref))

    counters['fftlog.launches'] = 0
    s, xi = fft(pk)
    fft.inv()
    k_back, pk_back = fft(xi)
    fresh_k, fresh_pk = fresh(xi)
    # the transform back is the Hankel pair's other half: CorrelationToPower
    # on the s grid has the same u and the same pre x post, so it agrees to
    # rounding (8.2e-16 before the postfactor on the CPU)
    c2p_k, c2p_pk = CorrelationToPower(s.cpu().numpy())(xi)
    launches = counters['fftlog.launches']
    torch.cuda.synchronize()
    check(launches == 4, f'the forward and inverted transforms took {launches} launches, not 4')
    against_plain('inverted', fft, xi.contiguous())
    fft.inv()
    against_plain('forward', fft, pk)
    band = (k > INV_BAND[0]) & (k < INV_BAND[1])
    round_trip = ((pk_back - pk).abs() / pk.abs())[:, torch.from_numpy(band).to(dev)].max().item()
    cache = (pk_back - fresh_pk).abs().max().item()
    post = torch.from_numpy(fft.padded_postfactor[0, fft.padded_size_out_left:fft.padded_size_out_left + NK]).to(dev)
    c2p = rel_err(pk_back / post, c2p_pk / post)
    print(f'api (a): PowerToCorrelation ({B}, {NK} -> 2048) and inv(): the kernel against plain per row, before '
          f'the postfactor, forward {errs["forward"][0]:.3e}, inverted {errs["inverted"][0]:.3e} (bar '
          f'{KERNEL_BAR:g}; after it {errs["forward"][1]:.3e}, {errs["inverted"][1]:.3e}); the round trip in '
          f'{INV_BAND[0]:g} < k < {INV_BAND[1]:g} {round_trip:.3e} (bar {INV_RTOL:g}); the grid back '
          f'{np.max(np.abs(k_back.cpu().numpy() / k - 1)):.3e}; a transform called before inv() against one '
          f'inverted before its first call: {cache:.3e}, against a fresh CorrelationToPower on the s grid '
          f'{c2p:.3e} per row before the postfactor (bar {KERNEL_BAR:g})', flush=True)
    check(max(err[0] for err in errs.values()) <= KERNEL_BAR and errs['forward'][1] <= KERNEL_BAR,
          'the kernel disagrees with plain on the forward or the inverted transform')
    check(round_trip <= INV_RTOL, 'the inverted transform does not give P(k) back')
    check(cache == 0.0 and torch.equal(k_back, fresh_k), 'inv() kept the factors made before it for the card')
    check(c2p <= KERNEL_BAR and rel_err(c2p_k[None], k_back[None]) <= KERNEL_BAR,
          'the inverted transform disagrees with CorrelationToPower')
    # (b) the reference engine names: 'pallas' and 'fftw' launch the kernel, 'numpy' runs the plain version
    plain = PowerToCorrelation(k, engine='torch')(pk[:N_COMPARE])[1]
    for name, want in (('pallas', 1), ('fftw', 1), ('numpy', 0)):
        fft.set_fft_engine(name)
        counters['fftlog.launches'] = 0
        got = fft(pk[:N_COMPARE])[1]
        n = counters['fftlog.launches']
        launches += n
        err = rel_err(got, plain)
        print(f"api (b): set_fft_engine('{name}') -> '{fft.engine}', {n} kernel launches, against the 'torch' "
              f'engine {err:.3e} per row', flush=True)
        check(n == want, f"set_fft_engine('{name}') took {n} kernel launches, not {want}")
        check(err <= KERNEL_BAR, f"set_fft_engine('{name}') disagrees with the 'torch' engine")
    # (c) the quickstart on the card against the CPU
    t1 = time.perf_counter()
    main_run_start()
    on_card = quickstart.main(['--device', 'cuda'])
    n = counters['fftlog.launches']
    note_splines('quickstart', required=False)
    launches += n
    wall_card = time.perf_counter() - t1
    t1 = time.perf_counter()
    on_cpu = quickstart.main(['--device', 'cpu'])
    wall_cpu = time.perf_counter() - t1
    check(n > 0, 'the quickstart on the card did not launch the FFTLog kernel')
    worst = (-1.0, '')
    for name, bar in quickstart.BARS.items():
        got, ref = on_card[name], on_cpu[name]
        check(got.shape == ref.shape and np.isfinite(got).all(), f'quickstart output {name}')
        err = float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))
        check(err <= bar, f'quickstart output {name} on the card is {err:.3e} from the CPU (bar {bar:g})')
        worst = max(worst, (err / bar, name), key=lambda item: item[0])
    print(f'api (c): the quickstart on the card {wall_card:.1f} s, {n} kernel launches; on the CPU {wall_cpu:.1f} s; '
          f'{len(quickstart.BARS)} outputs against the CPU, the worst {worst[1]} at {worst[0]:.3e} of its bar',
          flush=True)
    # (d) loggamma and gamma against scipy, gauss_legendre and odeint against the CPU
    z = np.concatenate([rng.uniform(-8, 8, 200) + 1j * rng.uniform(-400, 400, 200),
                        rng.uniform(-8, 8, 200) + 1j * rng.uniform(-3, 3, 200),
                        rng.uniform(0.5, 5, 100) + 1j * rng.uniform(-50, 50, 100)])
    zc = rng.uniform(-4.5, 4.5, 200) + 1j * rng.uniform(-3, 3, 200)
    lg = loggamma(torch.from_numpy(z).to(dev)).cpu().numpy()
    ref = special.loggamma(z)
    lg_err = float(np.max(np.abs(lg - ref) / np.maximum(np.abs(ref), 1e-10)))
    g_err = float(np.max(np.abs(gamma(torch.from_numpy(zc).to(dev)).cpu().numpy() / special.gamma(zc) - 1)))
    a, b = torch.from_numpy(rng.uniform(0.0, 1.0, 64)), torch.from_numpy(rng.uniform(2.0, 3.0, 64))
    t = torch.linspace(0.0, 2.0, 201, dtype=torch.float64)
    y0 = torch.from_numpy(rng.uniform(0.5, 1.5, 16))

    def quad(device):
        return gauss_legendre(lambda x: torch.exp(-x) * torch.cos(3 * x), a.to(device), b.to(device))

    def ode(device):
        return odeint(lambda y, tt: -0.5 * y * tt + torch.sin(tt), y0.to(device), t.to(device))

    w = torch.from_numpy(rng.uniform(0.5, 2.0, 8))

    def quad_floats(device):   # float bounds: the nodes on the CPU, the integrand's values on ``device``
        return gauss_legendre(lambda x: torch.sin(x.to(device)[:, None] * w.to(device)), 0.1, 2.0)

    on_card = quad_floats(dev)
    check(on_card.device.type == dev.type, 'gauss_legendre with float bounds left the integrand\'s device')
    quad_err = max(rel_err(quad(dev).cpu()[None], quad('cpu')[None]),
                   rel_err(on_card.cpu()[None], quad_floats('cpu')[None]))
    ode_err = rel_err(ode(dev).cpu().T, ode('cpu').T)
    print(f'api (d): loggamma on {z.size} complex128 points against scipy {lg_err:.3e}, gamma {g_err:.3e} (bar '
          f'{SPECIAL_RTOL:g}); gauss_legendre on 64 intervals {quad_err:.3e}, odeint rk4 on 16 lanes x 201 steps '
          f'{ode_err:.3e}, the card against the CPU (bar {OPS_RTOL:g})', flush=True)
    check(lg_err <= SPECIAL_RTOL and g_err <= SPECIAL_RTOL, 'loggamma or gamma disagrees with scipy on the card')
    check(quad_err <= OPS_RTOL and ode_err <= OPS_RTOL, 'gauss_legendre or odeint disagrees with the CPU')
    print(f'phase 27: {time.perf_counter() - t0:.1f} s, kernel launches {launches} on {card}', flush=True)
    return launches


def kernel_bound_ms(x, args):
    """The least time the card could take for one call of the core on ``x``
    (rows, size) with ``args``: each input read once and the output written
    once over the device-memory rate, against the f64 operations (a real
    FFT pair per row, 5 n log2 n, the spectrum product and the pre- and
    postfactors) over the f64 rate; the larger, and which one."""
    u, pre, post = args[:3]
    rows, size = x.shape
    n = pre.shape[-1]
    nbytes = 8 * (2 * rows * size + pre.numel() + post.numel()) + 16 * u.numel()
    ops = rows * (5 * n * np.log2(n) + 6 * (n // 2 + 1) + 2 * n)
    bytes_ms, ops_ms = nbytes / (HBM_TB_S * 1e12) * 1e3, ops / (FP64_TFLOP_S * 1e12) * 1e3
    return (bytes_ms, 'bytes') if bytes_ms >= ops_ms else (ops_ms, 'operations')


def spline_solve(card):
    """Phase 9b: the spline solve kernel at the DESI cell's shapes, against
    its plain version on the card (every system, per system at
    KERNEL_BAR), then CUDA-event times of the kernel, the plain version and
    torch.linalg.solve_ex on the dense matrix (the yardstick; no library
    call solves knots per row), in turns, beside the bytes bound. Returns
    the kernels line's entry: the case furthest from its bound (its label
    under 'case'), with the largest difference from plain of all three."""
    from cosmoprimo_tpu_torch.ops import spline
    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(0)

    def values(knots, rows):
        amp = torch.rand(rows, 1, generator=g, device=dev, dtype=torch.float64)
        wiggle = torch.rand(rows, knots.shape[-1], generator=g, device=dev, dtype=torch.float64)
        return (1.0 + amp) * torch.sin(3.0 * knots) + 0.1 * wiggle

    x = torch.log10(torch.from_numpy(np.geomspace(1e-5, 1e2, SPLINE_NK))).to(dev)
    rows = values(x, SPLINE_SYSTEMS)
    columns = rows.T.contiguous()
    # knots per cosmology (the filter's peaks, rescaled), shared by its 7 redshifts
    xr = torch.from_numpy(np.cumsum(10 ** np.random.default_rng(0).uniform(-3.0, -1.0, (SPLINE_SYSTEMS // 7, 1,
                                                                                        SPLINE_ROW_KNOTS)), axis=-1))
    xr = xr.to(dev).expand(-1, 7, -1).reshape(SPLINE_SYSTEMS, SPLINE_ROW_KNOTS)
    fr = values(xr, SPLINE_SYSTEMS)
    h = torch.diff(x)
    T = torch.diag((h[:-1] + h[1:]) / 3.0) + torch.diag(h[1:-1] / 6.0, 1) + torch.diag(h[1:-1] / 6.0, -1)
    rhs = torch.diff(torch.diff(columns, dim=0) / h[:, None], dim=0)
    mb = 8 * rows.numel() / 1e6
    cases = {   # label: kernel, plain, library yardstick, bytes (each input read and the output written once)
        f'shared knots, columns ({SPLINE_NK}, {SPLINE_SYSTEMS})':
            (lambda: spline.natural_cubic_coeffs(x, columns), lambda: spline._coeffs_plain(x, columns),
             lambda: torch.linalg.solve_ex(T, rhs), 2 * mb),
        f'shared knots, rows y.T ({SPLINE_SYSTEMS}, {SPLINE_NK})':
            (lambda: spline.natural_cubic_coeffs(x, rows.T).T, lambda: spline._coeffs_plain(x, rows.T).T,
             lambda: torch.linalg.solve_ex(T, rhs), 2 * mb),
        f'knots per row ({SPLINE_SYSTEMS}, {SPLINE_ROW_KNOTS})':
            (lambda: spline.natural_cubic_coeffs_rows(xr, fr), lambda: spline._coeffs_rows_plain(xr, fr), None,
             3 * 8 * fr.numel() / 1e6),
    }
    lines = []
    for label, (kernel, plain, library, mbytes) in cases.items():
        launches = counters['spline.launches']
        got = kernel()
        ref = plain()
        torch.cuda.synchronize()
        check(counters['spline.launches'] == launches + 1, f'the spline kernel at {label} is not one launch')
        axis = 0 if label.startswith('shared knots, columns') else -1
        err = ((got - ref).abs().amax(dim=axis) / ref.abs().amax(dim=axis)).max().item()
        max_abs = (got - ref).abs().max().item()
        del got, ref
        kernel_ms = plain_ms = 0.0
        for order in (('plain', 'kernel'), ('kernel', 'plain')):
            for name in order:
                if name == 'kernel':
                    kernel_ms += cuda_ms(kernel, reps=TIMED_LAUNCHES) / 2
                else:
                    plain_ms += cuda_ms(plain, reps=10) / 2
        library_ms = cuda_ms(library, reps=10) if library is not None else None
        bound_ms = mbytes * 1e6 / (HBM_TB_S * 1e12) * 1e3
        device, host = device_ms(kernel, reps=TIMED_LAUNCHES)
        device = 'not measured (the profiler shows no device time)' if device is None else f'{device:.4f} ms'
        library = 'none (no library call solves knots per row)' if library_ms is None else f'{library_ms:.4f} ms'
        print(f'spline kernel vs plain on the card, {label}: {err:.3e} per system (bar {KERNEL_BAR:g}); time: '
              f'kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, torch.linalg.solve_ex {library}, bound '
              f'{bound_ms:.4f} ms (bytes, {mbytes:.0f} MB; the kernel at {bound_ms / kernel_ms:.1%} of it), device '
              f'(torch.profiler) {device}, the host\'s enqueue {host:.4f} ms; in turns, on {card}', flush=True)
        check(err <= KERNEL_BAR, f'the spline kernel disagrees with plain at {label}')
        lines.append({'name': 'spline_solve', 'route': 'cuda', 'source': 'cosmoprimo_tpu_torch/csrc/spline_solve.cu',
                      'replaces': None, 'case': label, 'max_abs_err': max_abs, 'ms': kernel_ms, 'plain_ms': plain_ms,
                      'bound_ms': bound_ms, 'bound_by': 'bytes', 'library_ms': library_ms})
    line = min(lines, key=lambda entry: entry['bound_ms'] / entry['ms'])
    return dict(line, max_abs_err=max(entry['max_abs_err'] for entry in lines))


def library_fft_ms(x, args):
    """CUDA-event time of the library's FFT calls on the same rows: the
    padded, prefactored rows through torch.fft.rfft, the product with u and
    torch.fft.irfft (the pad, the conjugate, the postfactor and the crop
    left out)."""
    u, pre, post, in_left, _ = args
    n = pre.shape[-1]
    f = x.new_zeros((x.shape[0], n))
    f[:, in_left:in_left + x.shape[1]] = x
    f = (f.reshape(-1, pre.shape[0], n) * pre).reshape(-1, n)
    uu = u.repeat(x.shape[0] // u.shape[0], 1)
    return cuda_ms(lambda: torch.fft.irfft(torch.fft.rfft(f, dim=-1) * uu, n=n, dim=-1))


def main():
    # 1. card
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda is not available', file=sys.stderr)
        return 1
    from cosmoprimo_tpu_torch import (Cosmology, CorrelationToPower, GaussianVariance, HankelTransform,
                                      PowerToCorrelation, TophatVariance, make_pk_to_xi_pipeline_batched)
    from cosmoprimo_tpu_torch.interpolator import _tophat_variance
    from cosmoprimo_tpu_torch.ops import fftlog_kernel
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f'card: {card}', flush=True)
    dev = torch.device(DEVICE)
    print(f'torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}', flush=True)
    # 2. build
    t0 = time.perf_counter()
    lib_path, log = fftlog_kernel.build()
    print(f'build: {time.perf_counter() - t0:.2f} s ({"compiled" if log is not None else "cached"}) {lib_path}')
    if log:
        print(log.strip())
        entries = re.findall(r"Compiling entry function '([^']+)'", log)
        spills = [int(v) for v in re.findall(r'(\d+) bytes spill (?:stores|loads)', log)]
        print(f'ptxas: {len(entries)} entry functions, spill bytes {sum(spills)}', flush=True)
        check(sum('fftlog_pair_kernel' in e for e in entries) == fftlog_kernel.MAX_LOG2N - fftlog_kernel.MIN_LOG2N + 1,
              'the build does not hold one FFTLog kernel per padded length')
        # the spline solve: its factors, and 2 layouts x shared or per-row knots x values or given
        check(sum('spline_' in e for e in entries) == 9, 'the build does not hold the spline kernels')
        check(not any(spills), 'ptxas reports register spills')

    # 3. kernel against plain, on the setup arrays of the real transforms
    rng = np.random.default_rng(0)
    k = np.geomspace(1e-5, 1e2, NK)
    k_dev = torch.from_numpy(k).to(dev)
    # the grids of the HMcode pipeline's PowerToCorrelation and of the
    # sigma8 input path's TophatVariance (integrate_sigma_r2)
    k_hmcode = np.geomspace(1e-5, 1e2, NK_HMCODE)
    tophat_sigma8, k_sigma8 = _tophat_variance(1e-7, 1e2, 1024, dev)
    # and the BAO-template path's to_xi (the 1e-7..1e2 grid) and to_pk (the s grid that to_xi returns)
    to_xi = PowerToCorrelation(np.geomspace(1e-7, 1e2, NK))
    to_pk = CorrelationToPower(np.geomspace(to_xi.y[0, 0], to_xi.y[0, -1], NK))

    def transform_case(transform, rows, ratio=1.0, k_in=k_dev, profile=pk_like):
        arrays = transform._arrays(dev)
        args = (arrays['padded_u'], arrays['padded_prefactor'], arrays['padded_postfactor'],
                transform.padded_size_in_left, transform.padded_size_out_left)
        amplitude = rng.uniform(0.5, 2.0, rows)
        amplitude[1::2] *= ratio
        tilt = torch.from_numpy(rng.uniform(0.9, 1.0, rows)).to(dev)
        return profile(k_in, torch.from_numpy(amplitude).to(dev), tilt).contiguous(), args

    def random_case(log2n, rows):
        n = 2 ** log2n
        size = n // 2
        u = rng.normal(size=(1, n // 2 + 1)) + 1j * rng.normal(size=(1, n // 2 + 1))
        x, u, pre, post = [torch.from_numpy(a).to(dev) for a in
                           (rng.normal(size=(rows, size)), u, rng.normal(size=(1, n)), rng.normal(size=(1, n)))]
        return x, (u, pre, post, n // 4, n // 4 + 3)

    cases = {
        'TophatVariance (4096, 1024 -> 2048)': transform_case(TophatVariance(k), 4096),
        f'PowerToCorrelation ({B}, 1024 -> 2048)': transform_case(PowerToCorrelation(k), B),
        'PowerToCorrelation ell=(0, 2, 4) (3 x 1000, 1024 -> 2048)':
            transform_case(PowerToCorrelation(k, ell=[0, 2, 4]), 3000),
        'PowerToCorrelation (4097, 1024 -> 2048)': transform_case(PowerToCorrelation(k), 4097),
        'PowerToCorrelation ell=(0, 2, 4) (3 x 1001, 1024 -> 2048)':
            transform_case(PowerToCorrelation(k, ell=[0, 2, 4]), 3003),
        'PowerToCorrelation, rows at a 1e8 scale ratio (64, 1024 -> 2048)':
            transform_case(PowerToCorrelation(k), 64, ratio=1e-8),
        'PowerToCorrelation lowring=False (4096, 1024 -> 2048)':
            transform_case(PowerToCorrelation(k, lowring=False), 4096),
        f'PowerToCorrelation, HMcode grid ({B_HMCODE}, {NK_HMCODE} -> 1024)':
            transform_case(PowerToCorrelation(k_hmcode), B_HMCODE, k_in=torch.from_numpy(k_hmcode).to(dev)),
        f'TophatVariance, sigma8 input grid 1e-7..1e2 ({B_SIGMA8}, 1024 -> 2048)':
            transform_case(tophat_sigma8, B_SIGMA8, k_in=k_sigma8),
        f'PowerToCorrelation, to_xi grid 1e-7..1e2 ({B_BAO * DESI_Z.size}, 1024 -> 2048)':
            transform_case(to_xi, B_BAO * DESI_Z.size, k_in=torch.from_numpy(to_xi.x[0]).to(dev)),
        f'CorrelationToPower, to_pk on the s grid of to_xi ({B_BAO}, 1024 -> 2048)':
            transform_case(to_pk, B_BAO, k_in=torch.from_numpy(1.0 / to_pk.x[0]).to(dev)),
        # q = 0 sits on the pole of J_0's Mellin transform
        'HankelTransform nu=0, q=0.5 (4096, 1024 -> 2048)':
            transform_case(HankelTransform(k, nu=0, q=0.5), 4096, profile=gauss_like),
        'GaussianVariance (4096, 1024 -> 2048)': transform_case(GaussianVariance(k), 4096, profile=gauss_like),
    }
    for log2n in range(fftlog_kernel.MIN_LOG2N, fftlog_kernel.MAX_LOG2N + 1):
        cases[f'random (257, {2 ** (log2n - 1)} -> {2 ** log2n})'] = random_case(log2n, 257)
    timed = {}
    max_abs_err = 0.0
    for label, (x, args) in cases.items():
        counters['fftlog.launches'] = 0
        got = fftlog_kernel.fftlog_core(x, *args)
        check(counters['fftlog.launches'] == 1, f'one forward call at {label} is not one launch')
        ref = fftlog_kernel.fftlog_core_torch(x, *args)
        grad_out = torch.from_numpy(rng.normal(size=tuple(x.shape))).to(dev)
        xk = x.clone().requires_grad_(True)
        xp = x.clone().requires_grad_(True)
        grad_kernel, = torch.autograd.grad(fftlog_kernel.fftlog_core(xk, *args), xk, grad_out)
        grad_plain, = torch.autograd.grad(fftlog_kernel.fftlog_core_torch(xp, *args), xp, grad_out)
        torch.cuda.synchronize()
        fwd, bwd = rel_err(got, ref), rel_err(grad_kernel, grad_plain)
        max_abs_err = max(max_abs_err, (got - ref).abs().max().item(), (grad_kernel - grad_plain).abs().max().item())
        print(f'kernel vs plain, {label}: forward {fwd:.3e}, backward {bwd:.3e} per row (bar {KERNEL_BAR:g})',
              flush=True)
        check(fwd <= KERNEL_BAR and bwd <= KERNEL_BAR, f'kernel disagrees with plain at {label}')
        if label.startswith(('TophatVariance (4096', f'PowerToCorrelation ({B}', 'PowerToCorrelation, to_xi',
                             'CorrelationToPower', 'HankelTransform', 'GaussianVariance')):
            timed[label] = (x, args)

    # analytic: xi(s) = sqrt(pi/2) / (2 pi^2) exp(-s^2/2) for P(k) = exp(-k^2/2)
    kg = np.geomspace(1e-4, 1e2, NK)
    s, xi = PowerToCorrelation(kg, engine='kernel')(torch.from_numpy(np.exp(-kg ** 2 / 2)).to(dev))
    s, xi = s.cpu().numpy(), xi.cpu().numpy()
    expected = np.sqrt(np.pi / 2) / (2 * np.pi ** 2) * np.exp(-s ** 2 / 2)
    mask = (s > 1e-2) & (s < 3.0)
    gauss_err = np.max(np.abs(xi[mask] - expected[mask]) / (1e-7 + 1e-4 * np.abs(expected[mask])))
    print(f'Gaussian P(k) -> xi(s) through the kernel: max |d| / (1e-7 + 1e-4 |xi|) = {gauss_err:.3e} (bar 1)')
    check(gauss_err <= 1.0, 'analytic Gaussian transform fails')

    more_jvp_cases = (('HankelTransform nu=0, q=0.5 (4096, 1024 -> 2048)', HankelTransform(k, nu=0, q=0.5), 4096,
                       gauss_like),
                      ('GaussianVariance (4096, 1024 -> 2048)', GaussianVariance(k), 4096, gauss_like))
    max_abs_err = max(max_abs_err, forward_mode_and_complex(fftlog_kernel, transform_case, k, PowerToCorrelation,
                                                            more_jvp_cases))

    # 4. headline
    params = cosmo_params(rng, B)
    params_dev = [torch.from_numpy(p).to(dev) for p in params]
    fn, _, _ = make_pk_to_xi_pipeline_batched(nk=NK, z=[0.0])
    launches = run_pipeline('headline', fn, params, NK, fftlog_kernel, card, timed=False)

    # 5. halofit
    fn_halofit, _, _ = make_pk_to_xi_pipeline_batched(nk=NK, z=[0.0], non_linear='halofit')
    launches += run_pipeline('halofit', fn_halofit, cosmo_params(rng, B_HALOFIT), NK, fftlog_kernel, card)

    # 6. HMcode
    for non_linear in ('mead', 'mead2020_feedback'):
        fn_hmcode, _, _ = make_pk_to_xi_pipeline_batched(nk=NK_HMCODE, z=[0.0], non_linear=non_linear)
        launches += run_pipeline(f'HMcode ({non_linear})', fn_hmcode, cosmo_params(rng, B_HMCODE), NK_HMCODE,
                                 fftlog_kernel, card, timed=non_linear == 'mead')

    # 7. sigma8 input
    launches += sigma8_input(fftlog_kernel, Cosmology, rng, card)

    # 8. BAO template
    launches += bao_template(fftlog_kernel, rng, card)

    # 9. times
    engines = {engine: make_pk_to_xi_pipeline_batched(nk=NK, z=[0.0], fft_engine=engine)[0]
               for engine in ('kernel', 'torch')}
    walls = {name: [] for name in engines}
    for fun in engines.values():
        fun(*params_dev)
    for _ in range(5):
        for name, fun in engines.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fun(*params_dev)
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
    wall = {name: float(np.median(w)) for name, w in walls.items()}
    print(f'headline rate: {B / wall["kernel"]:.1f} cosmologies/s (median of 5 runs, {wall["kernel"] * 1e3:.3f} ms '
          f'per batch of {B}) on {card}', flush=True)
    print(f"headline A/B, median of 5 in turns: fft_engine='kernel' {wall['kernel'] * 1e3:.3f} ms, "
          f"fft_engine='torch' {wall['torch'] * 1e3:.3f} ms per batch of {B} on {card}", flush=True)
    clocks = subprocess.run(['nvidia-smi', '--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu',
                             '--format=csv,noheader'], capture_output=True, text=True).stdout.strip()
    print(f'card before the kernel times (SM clock, its maximum, power draw, temperature): {clocks}', flush=True)
    times = {}
    for label, (x, args) in timed.items():
        kernel_ms = plain_ms = 0.0
        for order in (('plain', 'kernel'), ('kernel', 'plain')):
            for name in order:
                fun = fftlog_kernel.fftlog_core if name == 'kernel' else fftlog_kernel.fftlog_core_torch
                ms = cuda_ms(lambda: fun(x, *args), reps=TIMED_LAUNCHES) / 2
                if name == 'kernel':
                    kernel_ms += ms
                else:
                    plain_ms += ms
        bound_ms, bound_by = kernel_bound_ms(x, args)
        library_ms = library_fft_ms(x, args)
        times[label] = (kernel_ms, plain_ms, bound_ms, bound_by, library_ms)
        print(f'time, {label}: kernel {kernel_ms:.4f} ms, plain torch.fft {plain_ms:.4f} ms, library FFT calls '
              f'{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; the kernel at {bound_ms / kernel_ms:.1%} '
              f'of it); {2 * TIMED_LAUNCHES} launches of each in turns, on {card}', flush=True)
        device, host = device_ms(lambda: fftlog_kernel.fftlog_core(x, *args))
        device = 'not measured (the profiler shows no device time)' if device is None else f'{device:.4f} ms'
        print(f'time, {label}: the kernel\'s device time (torch.profiler) {device} a launch, the host\'s enqueue '
              f'{host:.4f} ms a call ({2 * TIMED_LAUNCHES} calls)', flush=True)
        if x.shape[0] <= 4096:   # inputs and output (~67 MB) near the 50 MB L2: time it cold too
            cold = {name: cold_ms(lambda: fun(x, *args)) for name, fun in
                    (('kernel', fftlog_kernel.fftlog_core), ('plain', fftlog_kernel.fftlog_core_torch))}
            print(f'time, {label}, L2 flushed before each launch: kernel {cold["kernel"]:.4f} ms, plain '
                  f'{cold["plain"]:.4f} ms ({2 * TIMED_LAUNCHES} launches each) on {card}', flush=True)

    kernel_ms, plain_ms, bound_ms, bound_by, library_ms = times[f'PowerToCorrelation ({B}, 1024 -> 2048)']
    gbytes = 2 * B * NK * 8 / 1e9
    print(f'informational: the kernel moves {gbytes:.4f} GB at the headline shape, {gbytes / kernel_ms:.3f} TB/s, '
          f'{gbytes / kernel_ms / HBM_TB_S:.1%} of {HBM_TB_S} TB/s', flush=True)

    # 9b. the spline solve kernel at the DESI cell's shapes
    spline_line = spline_solve(card)

    # 10-13. the native Boltzmann path
    with ncdm_pins('10-13'):
        launches += native_path(fftlog_kernel, rng, card)

    # 14-17. the analytic engines, the batched solve and the mock redshifts
    launches += analytic_engines(fftlog_kernel, rng, card)
    batched_solve(rng, card)
    mock_redshifts(card)

    # 18-20. the native CMB spectra, the Perturbations table, the emitting loops
    with ncdm_pins('18'):
        launches += cmb_spectra(fftlog_kernel, rng, card)
    with ncdm_pins('19'):
        perturbation_table(card)
    with ncdm_pins('20'):
        emitting_graphs(rng, card)

    # 21-22. the emulator serving path
    t0 = time.perf_counter()
    with ncdm_pins('21'):
        launches += emulator_serving(fftlog_kernel, rng, card)
    converted_nets(rng, card)
    print(f'phases 21-22: {time.perf_counter() - t0:.1f} s', flush=True)

    # 23. training on the card
    t0 = time.perf_counter()
    launches += training(fftlog_kernel, rng, card)
    print(f'phase 23: {time.perf_counter() - t0:.1f} s', flush=True)

    # 24-26. parallel fan-out, the wrapper engines and the bindings
    torch.cuda.empty_cache()   # the ranks of phase 24 share the card with this process
    t0 = time.perf_counter()
    launches += parallel(card)
    launches += wrapper_engines(fftlog_kernel, card)
    bindings(card)
    print(f'phases 24-26: {time.perf_counter() - t0:.1f} s', flush=True)

    # 27. the public API surface
    launches += api_surface(fftlog_kernel, rng, card)

    spline_line['launches'] = sum(SPLINE_LAUNCHES.values())
    print('spline kernel launches in the main-path runs: '
          + ', '.join(f'{label} {n}' for label, n in SPLINE_LAUNCHES.items()), flush=True)
    print(json.dumps({'kernels': [{
        'name': 'fftlog_core', 'route': 'cuda', 'source': 'cosmoprimo_tpu_torch/csrc/fftlog_core.cu',
        'replaces': 'cosmoprimo_tpu/ops/pallas_fft.py:244', 'launches': launches,
        'max_abs_err': max_abs_err, 'ms': kernel_ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
        'bound_by': bound_by, 'library_ms': library_ms}, spline_line]}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    if sys.argv[1:2] == ['--parallel-worker']:
        sys.exit(parallel_worker(*sys.argv[2:]))
    sys.exit(main())
