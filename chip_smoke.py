"""Smoke run of the PyTorch port on one CUDA card: python3 chip_smoke.py

Phases, each failing the run (non-zero exit) if its check fails:

1. card: needs torch.cuda; prints the card's name and power limit;
2. build: compiles the FFTLog core kernel (csrc/fftlog_core.cu) from the
   sources in this checkout, times the build, and fails if ptxas reports a
   spill in any of its template instantiations (one per padded length);
3. kernel against plain: the kernel against its plain torch.fft version on
   the card, forward and backward, bar max|d| / max|ref| <= 1e-12 in every
   row (the kernel packs two rows into one complex FFT, so a bar over the
   batch could hide one leaking into the other), at the TophatVariance
   (4096, 1024 -> 2048), headline PowerToCorrelation (40 000, 1024 -> 2048)
   and nparallel = 3 multipole shapes, odd row counts (4097 rows; 3 x 1001
   multipole rows), rows at a 1e8 scale ratio, a lowring=False
   PowerToCorrelation, and random data at every padded length 64 ... 8192;
   then the analytic Gaussian P(k) -> xi(s) transform through the kernel;
4. headline: the port's make_pk_to_xi_pipeline_batched at B = 40 000,
   nk = 1024, z = [0], float64 on the card; the kernel's launch count must
   grow, every output must be finite, and the first 32 rows must agree with
   the same pipeline on CPU tensors (xi per row 1e-10 of its max, chi and
   sigma8 rtol 1e-11);
5. times: the headline with fft_engine='kernel' and with 'torch', in turns,
   median of 5 each after a warm-up of each; the kernel against plain at
   both kernel shapes, with CUDA events after a warm-up; and the kernel's
   achieved device-memory rate at the headline shape (informational).

The last line is {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

B = 40000
NK = 1024
N_COMPARE = 32
KERNEL_BAR = 1e-12
XI_BAR = 1e-10
CHI_SIGMA8_RTOL = 1e-11
HBM_TB_S = 3.35   # H100 SXM device memory, NVIDIA's data sheet


def check(ok, message):
    if not ok:
        raise RuntimeError(message)


def rel_err(got, ref):
    """max|got - ref| / max|ref| over each row, the worst row."""
    return ((got - ref).abs().amax(dim=-1) / ref.abs().amax(dim=-1)).max().item()


def pk_like(k, amplitude, tilt):
    """Smooth power-law-ish spectra, one row per (amplitude, tilt)."""
    return amplitude[:, None] * 1e4 * (k / 0.1) ** tilt[:, None] / (1 + (k / 0.1) ** 3)


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


def main():
    # 1. card
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda is not available', file=sys.stderr)
        return 1
    from cosmoprimo_tpu_torch import PowerToCorrelation, TophatVariance, make_pk_to_xi_pipeline_batched
    from cosmoprimo_tpu_torch.ops import fftlog_kernel
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f'card: {card}', flush=True)
    dev = torch.device('cuda')
    print(f'torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}', flush=True)

    # 2. build
    t0 = time.perf_counter()
    lib_path, log = fftlog_kernel.build()
    print(f'build: {time.perf_counter() - t0:.2f} s ({"compiled" if log is not None else "cached"}) {lib_path}')
    if log:
        print(log.strip())
        entries = log.count('Compiling entry function')
        spills = [int(v) for v in re.findall(r'(\d+) bytes spill (?:stores|loads)', log)]
        print(f'ptxas: {entries} entry functions, spill bytes {sum(spills)}', flush=True)
        check(entries == fftlog_kernel.MAX_LOG2N - fftlog_kernel.MIN_LOG2N + 1,
              'the build does not hold one kernel per padded length')
        check(not any(spills), 'ptxas reports register spills')

    # 3. kernel against plain, on the setup arrays of the real transforms
    rng = np.random.default_rng(0)
    k = np.geomspace(1e-5, 1e2, NK)
    k_dev = torch.from_numpy(k).to(dev)

    def transform_case(transform, rows, ratio=1.0):
        arrays = transform._arrays(dev)
        args = (arrays['padded_u'], arrays['padded_prefactor'], arrays['padded_postfactor'],
                transform.padded_size_in_left, transform.padded_size_out_left)
        amplitude = rng.uniform(0.5, 2.0, rows)
        amplitude[1::2] *= ratio
        tilt = torch.from_numpy(rng.uniform(0.9, 1.0, rows)).to(dev)
        return pk_like(k_dev, torch.from_numpy(amplitude).to(dev), tilt).contiguous(), args

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
    }
    for log2n in range(fftlog_kernel.MIN_LOG2N, fftlog_kernel.MAX_LOG2N + 1):
        cases[f'random (257, {2 ** (log2n - 1)} -> {2 ** log2n})'] = random_case(log2n, 257)
    timed = {}
    max_abs_err = 0.0
    for label, (x, args) in cases.items():
        fftlog_kernel.launches = 0
        got = fftlog_kernel.fftlog_core(x, *args)
        check(fftlog_kernel.launches == 1, f'one forward call at {label} is not one launch')
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
        if label.startswith(('TophatVariance (4096', f'PowerToCorrelation ({B}')):
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

    # 4. headline
    params = (rng.uniform(0.11, 0.13, B), rng.uniform(0.021, 0.023, B), rng.uniform(0.65, 0.70, B),
              rng.uniform(0.94, 0.98, B), rng.uniform(2.9, 3.1, B))
    params_dev = [torch.from_numpy(p).to(dev) for p in params]
    fn, _, s_grid = make_pk_to_xi_pipeline_batched(nk=NK, z=[0.0])
    torch.cuda.reset_peak_memory_stats()
    fftlog_kernel.launches = 0
    xi, chi, sigma8 = fn(*params_dev)
    torch.cuda.synchronize()
    launches = fftlog_kernel.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f'headline: B={B}, nk={NK}, xi {tuple(xi.shape)}, chi {tuple(chi.shape)}, sigma8 {tuple(sigma8.shape)}, '
          f'kernel launches {launches}, peak memory {peak_gb:.2f} GB', flush=True)
    check(launches > 0, 'the headline did not launch the FFTLog kernel')
    check(tuple(xi.shape) == (B, 1, NK) and tuple(chi.shape) == (B, 3) and tuple(sigma8.shape) == (B,),
          'headline output shapes are wrong')
    check(all(bool(torch.isfinite(t).all()) for t in (xi, chi, sigma8)), 'headline outputs are not all finite')
    xi_cpu, chi_cpu, sigma8_cpu = fn(*[torch.from_numpy(p[:N_COMPARE]) for p in params])
    xi_dev = xi[:N_COMPARE].cpu()
    xi_err = ((xi_dev - xi_cpu).abs().amax(dim=-1) / xi_cpu.abs().amax(dim=-1)).max().item()
    chi_err = (chi[:N_COMPARE].cpu() / chi_cpu - 1).abs().max().item()
    sigma8_err = (sigma8[:N_COMPARE].cpu() / sigma8_cpu - 1).abs().max().item()
    print(f'card vs CPU, first {N_COMPARE} rows: xi {xi_err:.3e} (bar {XI_BAR:g}), chi {chi_err:.3e}, '
          f'sigma8 {sigma8_err:.3e} (bar {CHI_SIGMA8_RTOL:g}); sigma8 range [{sigma8.min().item():.4f}, '
          f'{sigma8.max().item():.4f}]', flush=True)
    check(xi_err <= XI_BAR and chi_err <= CHI_SIGMA8_RTOL and sigma8_err <= CHI_SIGMA8_RTOL,
          'card and CPU disagree on the headline')

    # 5. times
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
    times = {}
    for label, (x, args) in timed.items():
        kernel_ms = plain_ms = 0.0
        for order in (('plain', 'kernel'), ('kernel', 'plain')):
            for name in order:
                fun = fftlog_kernel.fftlog_core if name == 'kernel' else fftlog_kernel.fftlog_core_torch
                ms = cuda_ms(lambda: fun(x, *args)) / 2
                if name == 'kernel':
                    kernel_ms += ms
                else:
                    plain_ms += ms
        times[label] = (kernel_ms, plain_ms)
        print(f'time, {label}: kernel {kernel_ms:.4f} ms, plain torch.fft {plain_ms:.4f} ms on {card}', flush=True)

    kernel_ms, plain_ms = times[f'PowerToCorrelation ({B}, 1024 -> 2048)']
    gbytes = 2 * B * NK * 8 / 1e9
    print(f'informational: the kernel moves {gbytes:.4f} GB at the headline shape, {gbytes / kernel_ms:.3f} TB/s, '
          f'{gbytes / kernel_ms / HBM_TB_S:.1%} of {HBM_TB_S} TB/s', flush=True)
    print(json.dumps({'kernels': [{
        'name': 'fftlog_core', 'route': 'cuda', 'source': 'cosmoprimo_tpu_torch/csrc/fftlog_core.cu',
        'replaces': 'cosmoprimo_tpu/ops/pallas_fft.py:244', 'launches': launches,
        'max_abs_err': max_abs_err, 'ms': kernel_ms, 'plain_ms': plain_ms}]}))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
