"""The port's CUDA kernels on the card, against their plain PyTorch versions:
the FFTLog core and the spline solve.

Every test here needs a CUDA device and nvcc, and skips without them. They
need no JAX; tests/conftest.py imports it, so on a machine without JAX run
them without the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m cuda

Bar: max|kernel - plain| / max|plain| <= 1e-12 in every row, forward,
backward and forward mode (jvp, vmap), complex multipoles and the Hankel
and Gaussian-variance transforms included; both are float64 FFTs of the
same data in another order of operations. The bar
is per row because the kernel transforms two rows in one complex FFT: a bar
over the whole batch would hide one row leaking into its partner.
"""

import functools

import numpy as np
import pytest
import torch

from cosmoprimo_tpu_torch import CorrelationToPower, GaussianVariance, HankelTransform, PowerToCorrelation, TophatVariance
from cosmoprimo_tpu_torch.ops import fftlog_kernel, spline
from cosmoprimo_tpu_torch import tracing
from cosmoprimo_tpu_torch.tracing import counters

BAR = 1e-12


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device and nvcc: the FFTLog core kernel runs only there')
    return torch.device('cuda')


def norm_err(got, ref):
    """max|got - ref| / max|ref| over each row, the worst row."""
    return ((got - ref).abs().amax(dim=-1) / ref.abs().amax(dim=-1)).max().item()


def random_core_args(rng, rows, size, n, nparallel, device):
    u = rng.normal(size=(nparallel, n // 2 + 1)) + 1j * rng.normal(size=(nparallel, n // 2 + 1))
    arrays = (rng.normal(size=(rows, size)), u, rng.normal(size=(nparallel, n)), rng.normal(size=(nparallel, n)))
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize('rows,size,n,nparallel,in_left,out_left',
                         [(40000, 1024, 2048, 1, 512, 512), (30, 512, 2048, 3, 0, 0), (64, 4000, 4096, 1, 48, 48),
                          (16, 8192, 8192, 2, 0, 0), (8, 40, 64, 1, 12, 12),
                          # odd row counts: the last block of each p has one row
                          (4097, 1024, 2048, 1, 512, 512), (3003, 1024, 2048, 3, 512, 512),
                          # the other padded lengths, one template instantiation each
                          (33, 100, 128, 1, 10, 18), (31, 200, 256, 1, 0, 56), (6, 300, 512, 2, 100, 112),
                          (101, 1000, 1024, 1, 24, 0)])
def test_fftlog_core_against_plain(cuda_device, rows, size, n, nparallel, in_left, out_left):
    rng = np.random.default_rng(rows)
    x, u, pre, post = random_core_args(rng, rows, size, n, nparallel, cuda_device)
    launches = counters['fftlog.launches']
    got = fftlog_kernel.fftlog_core(x, u, pre, post, in_left, out_left)
    ref = fftlog_kernel.fftlog_core_torch(x, u, pre, post, in_left, out_left)
    torch.cuda.synchronize()
    assert counters['fftlog.launches'] == launches + 1
    assert norm_err(got, ref) <= BAR
    grad_out = torch.from_numpy(rng.normal(size=(rows, size))).to(cuda_device)
    xk, xp = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    gk, = torch.autograd.grad(fftlog_kernel.fftlog_core(xk, u, pre, post, in_left, out_left), xk, grad_out)
    gp, = torch.autograd.grad(fftlog_kernel.fftlog_core_torch(xp, u, pre, post, in_left, out_left), xp, grad_out)
    assert counters['fftlog.launches'] == launches + 3  # one forward above, then forward and backward
    assert norm_err(gk, gp) <= BAR


@pytest.mark.cuda
@pytest.mark.parametrize('ratio', [1e-8, 1e8])
def test_fftlog_core_pair_scale_ratio(cuda_device, ratio):
    """Two rows of one complex FFT at a 1e8 scale ratio: the small one must
    not pick up the large one's round-off."""
    rng = np.random.default_rng(11)
    x, u, pre, post = random_core_args(rng, 64, 1024, 2048, 1, cuda_device)
    x[1::2] *= ratio
    got = fftlog_kernel.fftlog_core(x, u, pre, post, 512, 512)
    assert norm_err(got, fftlog_kernel.fftlog_core_torch(x, u, pre, post, 512, 512)) <= BAR
    grad_out = torch.from_numpy(rng.normal(size=(64, 1024))).to(cuda_device)
    grad_out[::2] *= ratio
    xk, xp = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    gk, = torch.autograd.grad(fftlog_kernel.fftlog_core(xk, u, pre, post, 512, 512), xk, grad_out)
    gp, = torch.autograd.grad(fftlog_kernel.fftlog_core_torch(xp, u, pre, post, 512, 512), xp, grad_out)
    assert norm_err(gk, gp) <= BAR


@pytest.mark.cuda
def test_fftlog_core_nan_row_keeps_partner(cuda_device):
    """A row with a NaN gives a NaN row, as in the plain version, and the
    row it shares a complex FFT with stays right."""
    rng = np.random.default_rng(12)
    x, u, pre, post = random_core_args(rng, 8, 1024, 2048, 1, cuda_device)
    x[3, 100] = float('nan')
    got = fftlog_kernel.fftlog_core(x, u, pre, post, 512, 512)
    ref = fftlog_kernel.fftlog_core_torch(x, u, pre, post, 512, 512)
    assert bool(torch.isnan(got[3]).all()) and bool(torch.isnan(ref[3]).all())
    keep = [0, 1, 2, 4, 5, 6, 7]
    assert norm_err(got[keep], ref[keep]) <= BAR


@pytest.mark.cuda
@pytest.mark.parametrize('transform', [PowerToCorrelation, TophatVariance,
                                       functools.partial(PowerToCorrelation, lowring=False)])
def test_transform_on_cuda_against_cpu(cuda_device, transform):
    """The 'auto' engine takes the kernel on the card and torch.fft on the
    CPU (which the JAX package holds to 1e-12 in test_torch_fftlog.py)."""
    k = np.geomspace(1e-5, 1e2, 1024)
    fun = torch.from_numpy(1e4 * (k / 0.1) ** 0.96 / (1 + (k / 0.1) ** 3) * np.random.default_rng(8).uniform(0.5, 2.0, (4, 1)))
    tr = transform(k)
    launches = counters['fftlog.launches']
    y, got = tr(fun.to(cuda_device))
    assert counters['fftlog.launches'] == launches + 1
    _, ref = tr(fun)
    assert norm_err(got.cpu(), ref) <= BAR


@pytest.mark.cuda
def test_fftlog_core_rejects(cuda_device):
    rng = np.random.default_rng(9)
    x, u, pre, post = random_core_args(rng, 4, 16, 32, 1, cuda_device)
    with pytest.raises(ValueError):
        fftlog_kernel.fftlog_core(x, u, pre, post, 0, 0)   # n = 32 is below the kernel's range
    x, u, pre, post = random_core_args(rng, 4, 100, 256, 1, cuda_device)
    with pytest.raises(ValueError):
        fftlog_kernel.fftlog_core(x, u, pre.cpu(), post, 0, 0)
    with pytest.raises(NotImplementedError):
        fftlog_kernel.fftlog_core(x, u, pre, post.to(torch.complex128), 0, 0)


def smooth_rows(k, rows, seed):
    rng = np.random.default_rng(seed)
    pk = 1e4 * (k / 0.1) ** 0.96 / (1 + (k / 0.1) ** 3) * rng.uniform(0.5, 2.0, (rows, 1))
    return torch.from_numpy(pk), torch.from_numpy(pk * np.log(k / 0.1) * rng.uniform(0.5, 2.0, (rows, 1)))


@pytest.mark.cuda
@pytest.mark.parametrize('ell,rows', [(0, 4096), ((0, 2, 4), 3 * 1000)])
def test_forward_mode_on_cuda(cuda_device, ell, rows):
    """jvp through the kernel (its jvp rule: one more launch for the
    tangent) and jacfwd-style vmapped tangents (its vmap rule: one launch
    for all of them) against the plain version, per row."""
    k = np.geomspace(1e-5, 1e2, 1024)
    transform = PowerToCorrelation(k, ell=ell, engine='kernel')
    plain = PowerToCorrelation(k, ell=ell, engine='torch')
    shape = (rows // 3, 3, 1024) if np.ndim(ell) else (rows, 1024)
    pk, tangent = (a.reshape(shape).to(cuda_device) for a in smooth_rows(k, rows, rows))
    launches = counters['fftlog.launches']
    out, jvp = torch.func.jvp(lambda f: transform(f)[1], (pk,), (tangent,))
    assert counters['fftlog.launches'] == launches + 2
    out_ref, jvp_ref = torch.func.jvp(lambda f: plain(f)[1], (pk,), (tangent,))
    assert norm_err(out, out_ref) <= BAR and norm_err(jvp, jvp_ref) <= BAR
    tangents = torch.stack([tangent, 2.0 * tangent, pk])
    launches = counters['fftlog.launches']
    vmapped = torch.func.vmap(lambda t: torch.func.jvp(lambda f: transform(f)[1], (pk,), (t,))[1])(tangents)
    assert counters['fftlog.launches'] == launches + 2
    assert norm_err(vmapped, torch.stack([jvp_ref, 2.0 * jvp_ref, out_ref])) <= BAR


@pytest.mark.cuda
def test_forward_mode_on_cuda_in_a_profiled_session(cuda_device):
    """jvp and vmapped tangents through the kernel inside the program's
    profiled session, where the kernel's own span is on: the answers of the
    plain version, one launch each for the primal and the tangent and one
    for the vmapped tangents, each inside the kernel's span."""
    k = np.geomspace(1e-5, 1e2, 1024)
    transform = PowerToCorrelation(k, engine='kernel')
    plain = PowerToCorrelation(k, engine='torch')
    pk, tangent = (a.to(cuda_device) for a in smooth_rows(k, 4096, 4096))
    launches = counters['fftlog.launches']
    with tracing.profile() as prof:
        out, jvp = torch.func.jvp(lambda f: transform(f)[1], (pk,), (tangent,))
        vmapped = torch.func.vmap(lambda t: torch.func.jvp(lambda f: transform(f)[1], (pk,), (t,))[1])(
            torch.stack([tangent, pk]))
        torch.cuda.synchronize()
    assert counters['fftlog.launches'] == launches + 4
    out_ref, jvp_ref = torch.func.jvp(lambda f: plain(f)[1], (pk,), (tangent,))
    assert norm_err(out, out_ref) <= BAR and norm_err(jvp, jvp_ref) <= BAR
    assert norm_err(vmapped, torch.stack([jvp_ref, out_ref])) <= BAR
    cuda = torch.autograd.DeviceType.CUDA
    host = [e.name() for e in prof.profiler.kineto_results.events() if e.device_type() != cuda]
    assert host.count('cosmoprimo.fftlog.kernel') == 4


@pytest.mark.cuda
def test_complex_multipoles_on_cuda(cuda_device):
    """complex=True on the card: two launches (the real and imaginary
    parts of the postfactor), complex128 out, against the plain version."""
    k = np.geomspace(1e-5, 1e2, 1024)
    pk, _ = smooth_rows(k, 4 * 500, 5)
    pk = pk.reshape(500, 4, 1024).to(cuda_device)
    launches = counters['fftlog.launches']
    _, got = PowerToCorrelation(k, ell=[0, 1, 2, 3], complex=True)(pk)
    assert counters['fftlog.launches'] == launches + 2 and got.dtype == torch.complex128
    _, ref = PowerToCorrelation(k, ell=[0, 1, 2, 3], complex=True, engine='torch')(pk)
    assert norm_err(torch.view_as_real(got).flatten(-2), torch.view_as_real(ref).flatten(-2)) <= BAR


@pytest.mark.cuda
@pytest.mark.parametrize('direction,rows', [('to_xi', 7 * 4096), ('to_pk', 4096)])
def test_bao_template_shapes_on_cuda(cuda_device, direction, rows):
    """The two transforms of the BAO-template path: to_xi's
    PowerToCorrelation on the 1e-7..1e2 grid at B * nz = 28 672 rows, and
    to_pk's CorrelationToPower on the s grid that to_xi returns, per row
    against plain, forward and backward."""
    k = np.geomspace(1e-7, 1e2, 1024)
    p2c = PowerToCorrelation(k)
    transform = p2c if direction == 'to_xi' else CorrelationToPower(np.geomspace(p2c.y[0, 0], p2c.y[0, -1], 1024))
    arrays = transform._arrays(cuda_device)
    args = (arrays['padded_u'], arrays['padded_prefactor'], arrays['padded_postfactor'],
            transform.padded_size_in_left, transform.padded_size_out_left)
    x, _ = smooth_rows(transform.x[0] if direction == 'to_xi' else 1.0 / transform.x[0], rows, rows)
    x = x.to(cuda_device)
    launches = counters['fftlog.launches']
    got = fftlog_kernel.fftlog_core(x, *args)
    assert counters['fftlog.launches'] == launches + 1
    assert norm_err(got, fftlog_kernel.fftlog_core_torch(x, *args)) <= BAR
    grad_out = torch.from_numpy(np.random.default_rng(rows).normal(size=(rows, 1024))).to(cuda_device)
    xk, xp = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    gk, = torch.autograd.grad(fftlog_kernel.fftlog_core(xk, *args), xk, grad_out)
    gp, = torch.autograd.grad(fftlog_kernel.fftlog_core_torch(xp, *args), xp, grad_out)
    assert norm_err(gk, gp) <= BAR


@pytest.mark.cuda
@pytest.mark.parametrize('transform', [functools.partial(HankelTransform, nu=0, q=0.5), GaussianVariance,
                                       functools.partial(HankelTransform, nu=[0, 1, 2], q=0.5)])
def test_hankel_gaussian_on_cuda(cuda_device, transform):
    """HankelTransform and GaussianVariance through the kernel at 4096 rows
    (1024 -> 2048) against the plain version, per row: forward, backward
    and forward mode."""
    k = np.geomspace(1e-5, 1e2, 1024)
    tr, plain = transform(k, engine='kernel'), transform(k, engine='torch')
    pk, tangent = (a.to(cuda_device) for a in smooth_rows(k, 4096, 13))
    if tr.nparallel > 1:
        pk, tangent = pk[:4095].reshape(1365, 3, 1024), tangent[:4095].reshape(1365, 3, 1024)
    launches = counters['fftlog.launches']
    got = tr(pk)[1]
    assert counters['fftlog.launches'] == launches + 1
    assert norm_err(got, plain(pk)[1]) <= BAR
    grad_out = torch.from_numpy(np.random.default_rng(15).normal(size=tuple(got.shape))).to(cuda_device)
    xk, xp = pk.clone().requires_grad_(True), pk.clone().requires_grad_(True)
    gk, = torch.autograd.grad(tr(xk)[1], xk, grad_out)
    gp, = torch.autograd.grad(plain(xp)[1], xp, grad_out)
    assert norm_err(gk, gp) <= BAR
    _, jvp = torch.func.jvp(lambda f: tr(f)[1], (pk,), (tangent,))
    _, jvp_ref = torch.func.jvp(lambda f: plain(f)[1], (pk,), (tangent,))
    assert norm_err(jvp, jvp_ref) <= BAR


@pytest.mark.cuda
def test_batched_solve_on_cuda(cuda_device):
    """Cosmology.solve('h', 'theta_MC_100', target) for 64 rows on the card
    against the same solve on CPU tensors: h rtol 1e-10."""
    from cosmoprimo_tpu_torch import Cosmology
    rng = np.random.default_rng(14)
    params = [rng.uniform(0.11, 0.13, 64), rng.uniform(0.021, 0.023, 64)]
    target = rng.uniform(1.035, 1.045, 64)

    def solve(device):
        oc, ob, t = (torch.from_numpy(v).to(device) for v in params + [target])
        return Cosmology(omega_cdm=oc, omega_b=ob, engine='eisenstein_hu').solve('h', 'theta_MC_100', target=t)['h']

    got, ref = solve(cuda_device).cpu(), solve('cpu')
    assert bool(torch.isfinite(got).all())
    assert ((got / ref - 1).abs().max().item()) <= 1e-10


def native_inputs(device):
    """Two cosmologies' background, solver parameters and the k grid."""
    from cosmoprimo_tpu_torch import Cosmology
    p = [torch.tensor(v, dtype=torch.float64, device=device) for v in
         ([0.12, 0.115], [0.0224, 0.0219], [0.68, 0.66], [0.965, 0.95], [3.04, 3.0])]
    cosmo = Cosmology(omega_cdm=p[0], omega_b=p[1], h=p[2], n_s=p[3], logA=p[4], engine='native')
    return cosmo, torch.from_numpy(np.geomspace(1e-3, 0.05, 16)).to(device)


@pytest.mark.cuda
def test_native_loops_graph_replay_against_eager(cuda_device):
    """The recombination scan and both RK4 phases replayed from CUDA graphs
    against the same loops run eagerly on the card (ops/step_loop.py): the
    same kernels in the same order, so within 1e-13 (rounding only)."""
    from cosmoprimo_tpu_torch.boltzmann import compute_thermodynamics
    from cosmoprimo_tpu_torch.boltzmann.perturbations import linear_pk
    cosmo, k = native_inputs(cuda_device)
    ba, pp = cosmo.get_background(), cosmo.engine._perturbation_params()
    out = {}
    for graphs in (True, False):
        th = compute_thermodynamics(cosmo['omega_b'], cosmo['h'], cosmo['T_cmb'], ba.efunc, tau_reio=cosmo['tau_reio'],
                                    N_eff=cosmo['N_eff'], graphs=graphs)
        out[graphs] = (th, linear_pk(pp, th, k, [0.0, 1.0], n_steps=(512, 256, 1024), graphs=graphs))
    for name in ('x_e', 'T_m', 'tau', 'tau_drag'):
        got, ref = getattr(out[True][0], name), getattr(out[False][0], name)
        assert ((got - ref).abs() / ref.abs().amax(dim=-1, keepdim=True)).max().item() <= 1e-13, name
    for name in ('pk_m', 'pk_cb'):
        got, ref = out[True][1][name], out[False][1][name]
        assert bool(torch.isfinite(ref).all()) and ((got - ref).abs() / ref.abs()).max().item() <= 1e-13, name


@pytest.mark.cuda
def test_native_loops_under_autograd(cuda_device):
    """Forward mode runs the loops eagerly on the card (a replayed graph
    carries no tangent) and agrees with a central difference to 1e-2
    (z_drag is a crossing read off a piecewise-linear table: the difference
    quotient over 2e-6 in omega_b lands within ~1e-3; the CPU tests hold the
    tangent to jax.jacfwd at 1e-8); a tensor that requires grad is refused
    there."""
    from cosmoprimo_tpu_torch import Cosmology
    from cosmoprimo_tpu_torch.boltzmann import compute_thermodynamics
    ba = Cosmology(engine='native', device=cuda_device).get_background()

    def z_drag(omega_b):
        return compute_thermodynamics(omega_b, 0.6736, 2.7255, ba.efunc, tau_reio=0.0544).z_drag

    ob = torch.tensor(0.02237, dtype=torch.float64, device=cuda_device)
    _, tangent = torch.func.jvp(z_drag, (ob,), (torch.ones_like(ob),))
    step = 1e-6
    diff = (z_drag(ob + step) - z_drag(ob - step)) / (2 * step)
    assert abs(tangent.item() / diff.item() - 1) < 1e-2
    with pytest.raises(NotImplementedError, match='forward mode'):
        z_drag(ob.clone().requires_grad_(True))


@pytest.mark.cuda
def test_emitting_loops_graph_replay_against_eager(cuda_device, monkeypatch):
    """The loops that emit per step (the line-of-sight taps with psi', the
    perturbation series, the tensor loop) replayed from CUDA graphs against
    the same loops run eagerly on the card: within 1e-13 of each row's max."""
    from cosmoprimo_tpu_torch.boltzmann import harmonic, perturbations as P, tensor
    cosmo, _ = native_inputs(cuda_device)
    pp, th = cosmo.engine._perturbation_params(), cosmo.get_thermodynamics().table
    k = torch.from_numpy(harmonic.coarse_k_grid(0.05)).to(cuda_device).expand(2, -1).contiguous()
    monkeypatch.setattr(tensor, 'N_STEPS_T', 2048)
    out = {}
    for graphs in (True, False):
        out[graphs] = (P.compute_los_sources(pp, th, k, n_steps=(512, 256, 1024), graphs=graphs)['src'],
                       P.compute_perturbation_series(pp, th, k, n_steps=(512, 256, 1024), graphs=graphs)['series'],
                       tensor.compute_tensor_sources(pp, th, k, graphs=graphs)['src'])
    for got, ref in zip(out[True], out[False]):
        assert bool(torch.isfinite(ref).all())
        assert ((got - ref).abs().amax(dim=-1) / ref.abs().amax(dim=-1).clamp(min=1e-300)).max().item() <= 1e-13


@pytest.mark.cuda
def test_cls_batch_on_cuda_against_cpu(cuda_device, monkeypatch):
    """The native CMB spectra of two cosmologies (r = 0.05) through
    Cosmology.get_harmonic() on the card against the CPU, at ellmax_cl = 100,
    lensing_margin = 40 and a cut step budget: each spectrum within 1e-8 of
    its max."""
    from cosmoprimo_tpu_torch import Cosmology
    from cosmoprimo_tpu_torch.boltzmann import perturbations as P, tensor
    for name, value in (('N_STEPS_A', 2048), ('N_STEPS_B', 768), ('M_TAB', 2048)):
        monkeypatch.setattr(P, name, value)
    monkeypatch.setattr(tensor, 'N_STEPS_T', 2048)

    def spectra(device):
        cosmo, _ = native_inputs(device)
        hs = cosmo.clone(r=0.05, ellmax_cl=100, extra_params={'lensing_margin': 40}).get_harmonic()
        return {'unlensed': hs.unlensed_cl(), 'lensed': hs.lensed_cl(), 'potential': hs.lens_potential_cl()}

    got, ref = spectra(cuda_device), spectra('cpu')
    for kind, table in ref.items():
        for name, value in table.items():
            if name == 'ell':
                continue
            d = (got[kind][name].cpu() - value).abs()
            assert bool(torch.isfinite(got[kind][name]).all())
            assert (d.amax(dim=-1) / value.abs().amax(dim=-1)).max().item() <= 1e-8, (kind, name)


@pytest.mark.cuda
def test_emulated_serving_on_cuda_against_cpu(cuda_device, tmp_path):
    """chip_smoke's phase-21 emulator (the 'native-base' layout) at a cut
    width served on the card against the CPU on 4 cosmologies: distances,
    P(k), sigma8_m and xi through the FFTLog kernel (its launch count
    grows), the Cls; each within 1e-10 of its row's max."""
    import chip_smoke
    from cosmoprimo_tpu_torch import Cosmology
    from cosmoprimo_tpu_torch.emulators import EmulatedEngine, Emulator
    fn = tmp_path / 'native_base.npy'
    Emulator.from_state(chip_smoke.native_base_emulator_state(width=4, ellmax_cl=500)).write(fn)
    params = {name: torch.tensor(values, dtype=torch.float64) for name, values in
              {'logA': [2.95, 3.0, 3.05, 3.1], 'n_s': [0.95, 0.96, 0.97, 0.98], 'h': [0.64, 0.67, 0.7, 0.73],
               'omega_b': [0.021, 0.022, 0.023, 0.024], 'omega_cdm': [0.11, 0.12, 0.13, 0.14],
               'm_ncdm': [0.06, 0.1, 0.2, 0.3], 'w0_fld': [-1.1, -1.0, -0.9, -0.8],
               'wa_fld': [-0.3, -0.2, -0.1, 0.0], 'tau_reio': [0.05, 0.055, 0.06, 0.065]}.items()}

    def serve(device):
        cosmo = Cosmology(engine=EmulatedEngine.read(fn), ellmax_cl=500,
                          **{name: value.to(device) for name, value in params.items()})
        pk = cosmo.get_fourier().pk_interpolator()
        z = torch.tensor([0.5, 1.0], dtype=torch.float64)
        return {'chi': cosmo.get_background().comoving_radial_distance(z), 'pk': pk(torch.tensor([0.01, 0.1]), z),
                'sigma8': cosmo.get_fourier().sigma8_m[:, None], 'xi': pk.to_xi().xi[..., 0],
                'tt': cosmo.get_harmonic().lensed_cl()['tt']}

    launches = counters['fftlog.launches']
    got = serve(cuda_device)
    assert counters['fftlog.launches'] > launches
    for name, value in serve('cpu').items():
        assert bool(torch.isfinite(got[name]).all()), name
        assert norm_err(got[name].cpu(), value) <= 1e-10, name


@pytest.mark.cuda
def test_training_on_cuda_against_cpu(cuda_device):
    """Emulator training on the card (no hand kernel: the MLP's products are
    torch.matmul): 20 Adam steps of the 'native-base' fourier width (64 x 5
    silu, 8 -> 422) from one numpy-seeded initialization, the card against
    the CPU within 1e-9 of each tensor's max (chip_smoke phase 23 (d));
    then a sample and staged fit on the card by default (a batch-first
    calculator on CUDA tensors): the validation loss falls, and the served
    prediction is finite on the card."""
    import chip_smoke
    from cosmoprimo_tpu_torch.emulators import Emulator, MLPEmulatorEngine
    assert chip_smoke.adam_card_vs_cpu(cuda_device) <= 1e-9

    def calculator(a, b):
        assert a.is_cuda
        x = torch.linspace(0.0, 1.0, 20, dtype=torch.float64, device=a.device)
        return {'y': a[:, None] * torch.sin(3 * x) + b[:, None] * x ** 2}

    emulator = Emulator(calculator=calculator, params={'a': (0.8, 1.2), 'b': (-0.2, 0.2)},
                        engine=MLPEmulatorEngine(nhidden=(16, 16)))
    emulator.set_samples(niterations=128)
    emulator.fit(epochs=30, batch_frac=(0.25, 1.0), learning_rate=(1e-2, 1e-3))
    losses = [loss for stage in emulator.engines['y'].history for loss in stage['losses']]
    assert np.isfinite(losses).all() and min(losses) < losses[0]
    pred = emulator.predict({'a': torch.tensor([1.0, 1.1], device=cuda_device),
                             'b': torch.tensor([0.0, 0.1], device=cuda_device)})['y']
    assert pred.is_cuda and pred.shape == (2, 20) and bool(torch.isfinite(pred).all())


# The spline solve kernel (csrc/spline_solve.cu): the card against the plain
# version on the CPU, per system (a spline's row or column along its knots).
# Both are float64 eliminations of the same diagonally dominant system in
# another order of operations (Thomas against LU or log-depth scans).

SPLINE_SAMPLE = 512      # systems of a large case compared against the CPU


def spline_err(got, ref, dim=-1):
    """max|got - ref| / max|ref| along the knot axis ``dim``, the worst system."""
    return ((got - ref).abs().amax(dim=dim) / ref.abs().amax(dim=dim)).max().item()


def log_knots(n):
    return torch.log10(torch.from_numpy(np.geomspace(1e-5, 1e2, n)))


def nonuniform_knots(rng, shape, n):
    """Knots whose neighbouring cells differ by up to 100x in width."""
    return torch.from_numpy(np.cumsum(10 ** rng.uniform(-2.0, 0.0, shape + (n,)), axis=-1))


def spline_values(knots, shape, seed):
    """A smooth curve in the knots plus a random wiggle, per system."""
    g = torch.Generator(device=knots.device).manual_seed(seed)
    amp = torch.rand(shape + (1,), generator=g, device=knots.device, dtype=torch.float64)
    wiggle = torch.rand(shape + (knots.shape[-1],), generator=g, device=knots.device, dtype=torch.float64)
    return (1.0 + amp) * torch.sin(3.0 * knots) + 0.1 * wiggle


def sample(count, seed):
    idx = np.random.default_rng(seed).choice(count, size=min(SPLINE_SAMPLE, count), replace=False)
    return torch.from_numpy(np.sort(np.concatenate([[0, count - 1], idx])))


def spline_launch(layout):
    """The launches of ``layout`` since the counters were read: a callable."""
    before = dict(counters['spline.shapes'])
    return lambda: sum(n - before.get(shape, 0) for shape, n in counters['spline.shapes'].items()
                       if shape[2] == layout)


@pytest.mark.cuda
@pytest.mark.parametrize('case,layout', [('columns', 'strided.shared'), ('rows', 'tiled.shared'),
                                         ('z_view', 'strided.shared')])
def test_spline_shared_knots_desi_shapes(cuda_device, case, layout):
    """Shared knots at the DESI template's shapes: a (1024, 57 344) table of
    columns (Interpolator2D's Mx and Mxy), the filter's ``y.T`` of (57 344,
    1024) rows, and the 7-knot z-spline of a (1024, 7, 8192) table through
    ``movedim`` (Interpolator2D's My), each taken as it lies."""
    launches = spline_launch(layout)
    if case == 'z_view':
        z = torch.tensor([0.295, 0.51, 0.706, 0.93, 1.317, 1.491, 2.33], dtype=torch.float64)
        fun = spline_values(z.to(cuda_device), (1024, 8192), 1).movedim(-1, 1).contiguous()   # (1024, 7, 8192)
        got = spline.natural_cubic_coeffs(z.to(cuda_device), fun.movedim(1, 0)).movedim(0, 1)
        assert got.is_contiguous()
        idx = sample(8192, 1)
        ref = spline.natural_cubic_coeffs(z, fun[:, :, idx].cpu().movedim(1, 0)).movedim(0, 1)
        err = spline_err(got[:, :, idx].cpu(), ref, dim=1)
    else:
        x = log_knots(1024)
        rows = spline_values(x.to(cuda_device), (57344,), 2)
        if case == 'columns':
            table = rows.T.contiguous()
            got = spline.natural_cubic_coeffs(x.to(cuda_device), table)
        else:
            table = rows
            got = spline.natural_cubic_coeffs(x.to(cuda_device), rows.T).T
            assert got.is_contiguous()
        idx = sample(57344, 2)
        if case == 'columns':
            ref = spline.natural_cubic_coeffs(x, table[:, idx].cpu())
            err = spline_err(got[:, idx].cpu(), ref, dim=0)
        else:
            ref = spline.natural_cubic_coeffs(x, table[idx].cpu().T).T
            err = spline_err(got[idx].cpu(), ref)
    assert launches() == 1
    assert bool(torch.isfinite(got).all())
    assert err <= BAR


@pytest.mark.cuda
@pytest.mark.parametrize('case,layout', [('expanded', 'tiled.rows'), ('contiguous', 'tiled.rows'),
                                         ('strided', 'strided.rows')])
def test_spline_rows_desi_shapes(cuda_device, case, layout):
    """Knots per system at the filter's shapes, 57 344 systems of 700 knots:
    the knots expanded over 7 redshifts (8192, 7, 700), contiguous rows, and
    knots-first tables (700, 57 344) through ``.T``."""
    rng = np.random.default_rng(3)
    nb, nz, n = 8192, 7, 700
    x = nonuniform_knots(rng, (nb, 1), n).to(cuda_device)
    launches = spline_launch(layout)
    if case == 'expanded':
        x = x.expand(nb, nz, n)
    else:
        x = x.expand(nb, nz, n).reshape(nb * nz, n)
    f = spline_values(x, x.shape[:-1], 3)
    if case == 'strided':
        x, f = x.T.contiguous().T, f.T.contiguous().T
    got = spline.natural_cubic_coeffs_rows(x, f)
    assert launches() == 1
    assert got.shape == f.shape and bool(torch.isfinite(got).all())
    x, f, got = x.reshape(-1, n), f.reshape(-1, n), got.reshape(-1, n)
    idx = sample(nb * nz, 3)
    ref = spline.natural_cubic_coeffs_rows(x[idx].cpu(), f[idx].cpu())
    assert spline_err(got[idx].cpu(), ref) <= BAR


@pytest.mark.cuda
@pytest.mark.parametrize('n', [4, 5, 1024])
@pytest.mark.parametrize('tiled', [True, False])
@pytest.mark.parametrize('shared', [True, False])
def test_spline_nonuniform_knots(cuda_device, n, tiled, shared):
    """Every system of 300 (the last block ragged) against the CPU, on knots
    whose cells differ by up to 100x, in both layouts, shared and per system."""
    rng = np.random.default_rng(n)
    x = nonuniform_knots(rng, () if shared else (300,), n)
    f = spline_values(x, (300,), n)
    xd, fd = x.to(cuda_device), f.to(cuda_device)
    if not tiled:
        xd, fd = (xd if shared else xd.T.contiguous().T), fd.T.contiguous().T
    launches = spline_launch(('tiled.' if tiled else 'strided.') + ('shared' if shared else 'rows'))
    got = spline.natural_cubic_coeffs_rows(xd, fd)
    assert launches() == 1
    assert spline_err(got.cpu(), spline.natural_cubic_coeffs_rows(x, f)) <= BAR


@pytest.mark.cuda
@pytest.mark.parametrize('tiled', [True, False])
@pytest.mark.parametrize('shared', [True, False])
def test_spline_nan_stays_in_its_system(cuda_device, tiled, shared):
    rng = np.random.default_rng(4)
    x = nonuniform_knots(rng, () if shared else (200,), 64)
    f = spline_values(x, (200,), 4)
    f[77, 30] = float('nan')
    xd, fd = x.to(cuda_device), f.to(cuda_device)
    if not tiled:
        xd, fd = (xd if shared else xd.T.contiguous().T), fd.T.contiguous().T
    got = spline.natural_cubic_coeffs_rows(xd, fd).cpu()
    ref = spline.natural_cubic_coeffs_rows(x, f)
    assert bool(torch.isnan(got[77, 1:-1]).all()) and bool(torch.isnan(ref[77, 1:-1]).all())
    keep = torch.arange(200) != 77
    assert spline_err(got[keep], ref[keep]) <= BAR


def knots_and_values(s, x0, f0, f1):
    """Knots rescaled by s[0] (as the filter's by the sound-horizon ratio)
    and values that depend on both parameters."""
    return x0 * s[0], f0 * s[1] + f1 * s[0] ** 2


@pytest.mark.cuda
@pytest.mark.parametrize('shared', [True, False])
def test_spline_derivatives_on_cuda(cuda_device, shared):
    """backward, jvp and torch.func.jacfwd through the kernel (each a solve
    with a right-hand side given: tangent and adjoint) against the plain
    version's autograd on the CPU, with knots that depend on a parameter."""
    rng = np.random.default_rng(5)
    n, rows = 96, 130
    x0 = nonuniform_knots(rng, () if shared else (rows,), n)
    f0, f1 = spline_values(x0, (rows,), 5), spline_values(x0, (rows,), 6)
    s = torch.tensor([1.03, 0.9], dtype=torch.float64)
    w = torch.from_numpy(rng.normal(size=(rows, n)))
    bar = 1e-10   # a derivative sums the solve's round-off over more terms than the forward

    def on(device):
        return [t.to(device) for t in (x0, f0, f1, w)]

    def solve(s, x0, f0, f1):
        return spline.natural_cubic_coeffs_rows(*knots_and_values(s, x0, f0, f1))

    results = {}
    for device in (cuda_device, torch.device('cpu')):
        x0d, f0d, f1d, wd = on(device)
        sd = s.to(device).requires_grad_(True)
        grad, = torch.autograd.grad((solve(sd, x0d, f0d, f1d) * wd).sum(), sd)
        x, f = knots_and_values(s.to(device), x0d, f0d, f1d)
        tangents = (x * 0.3, f * -0.2 + 0.1)
        _, jvp = torch.func.jvp(spline.natural_cubic_coeffs_rows, (x, f), tangents)
        jac = torch.func.jacfwd(lambda t: solve(t, x0d, f0d, f1d))(s.to(device))
        results[device.type] = (grad.cpu(), jvp.cpu(), jac.cpu())
    got, ref = results['cuda'], results['cpu']
    assert torch.allclose(got[0], ref[0], rtol=bar, atol=0.0)
    assert spline_err(got[1], ref[1]) <= bar
    assert spline_err(got[2].movedim(-1, 0), ref[2].movedim(-1, 0)) <= bar


@pytest.mark.cuda
def test_spline_kernel_rejects_and_counts(cuda_device):
    """A float32 CUDA input and a mismatched device raise; the launches
    count on CUDA tensors and not on CPU tensors."""
    x = torch.linspace(0.0, 1.0, 16, dtype=torch.float64)
    f = torch.sin(x)[None].repeat(3, 1)
    with pytest.raises(TypeError):
        spline.natural_cubic_coeffs_rows(x.to(cuda_device), f.to(cuda_device, torch.float32))
    with pytest.raises(ValueError):
        spline.natural_cubic_coeffs_rows(x, f.to(cuda_device))
    launches = counters['spline.launches']
    spline.natural_cubic_coeffs_rows(x, f)
    spline.natural_cubic_coeffs(x, f.T)
    assert counters['spline.launches'] == launches
    spline.natural_cubic_coeffs_rows(x.to(cuda_device), f.to(cuda_device))
    spline.natural_cubic_coeffs(x.to(cuda_device), f.T.to(cuda_device))
    torch.cuda.synchronize()
    assert counters['spline.launches'] == launches + 2


@pytest.mark.cuda
def test_native_loops_replays_captures_and_spans(cuda_device):
    """On the card each step loop of a call is one capture and n / c - 1
    replays of its graph (tracing.counters, by loop name, lanes and chunk),
    and the loops' spans (cosmoprimo.thermodynamics and
    cosmoprimo.perturbations.phase_a, .phase_b) wait for the stream before
    they close: every kernel that starts inside one ends inside it, the
    graph's replayed kernels among them (within 0.1 ms, the alignment of the
    profiler's device clock to its host clock; a replayed loop runs for
    seconds past a span that does not wait)."""
    import copy
    from cosmoprimo_tpu_torch.boltzmann import compute_thermodynamics, thermodynamics
    from cosmoprimo_tpu_torch.boltzmann.perturbations import linear_pk
    cosmo, k = native_inputs(cuda_device)
    ba, pp = cosmo.get_background(), cosmo.engine._perturbation_params()
    n_steps = (512, 256, 1024)
    before = copy.deepcopy(counters)
    with tracing.profile() as prof:
        th = compute_thermodynamics(cosmo['omega_b'], cosmo['h'], cosmo['T_cmb'], ba.efunc, tau_reio=cosmo['tau_reio'],
                                    N_eff=cosmo['N_eff'])
        linear_pk(pp, th, k, [0.0, 1.0], n_steps=n_steps)
        torch.cuda.synchronize()
    loops = {('recombination', 2, 32): thermodynamics.N_GRID - 1 - thermodynamics.saha_steps(),
             ('phase_a', 32, 32): n_steps[0],
             ('phase_b', 32, 32): n_steps[1]}
    for key, n in loops.items():
        assert counters['step_loop.steps'][key] - before['step_loop.steps'].get(key, 0) == n, key
        assert counters['step_loop.replays'][key] - before['step_loop.replays'].get(key, 0) == n // 32 - 1, key
        assert counters['step_loop.captures'][key] - before['step_loop.captures'].get(key, 0) == 1, key
    assert counters['step_loop.capture_s'] > before['step_loop.capture_s']
    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.profiler.kineto_results.events())
    kernels = [(e.start_ns(), e.end_ns()) for e in events if e.device_type() == cuda]
    for name in ('cosmoprimo.thermodynamics', 'cosmoprimo.perturbations.phase_a', 'cosmoprimo.perturbations.phase_b'):
        (start, end), = [(e.start_ns(), e.end_ns()) for e in events if e.name() == name and e.device_type() != cuda]
        inside = [(s, e) for s, e in kernels if start <= s <= end]
        assert len(inside) > 1000, name
        assert max(e for _, e in inside) <= end + 100_000, name
