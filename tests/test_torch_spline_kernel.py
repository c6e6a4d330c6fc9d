"""The spline solve kernel's wrapper on the CPU (cosmoprimo_tpu_torch/ops/
spline_kernel.py and the autograd function in ops/spline.py): how the
callers' views are laid out for the kernel, that CPU tensors take the plain
path, that the argument checks raise, and the derivative rules that the
kernel's tangent and adjoint solves run, here over the plain solve. The
kernel itself runs in tests/test_torch_kernels.py, on the card.

The layouts are checked by replaying the kernel's indexing: each plan's
strides read its systems out of the arrays it hands the kernel
(``as_strided``), the plain solve runs on them, and the result, written
back through the output's strides, must be the plain version's on the
caller's own tensors.
"""

import numpy as np
import pytest
import torch

from cosmoprimo_tpu_torch import tracing
from cosmoprimo_tpu_torch.ops import spline, spline_kernel

BAR = 1e-13


def knots(rng, shape, n):
    return torch.from_numpy(np.cumsum(10 ** rng.uniform(-2.0, 0.0, shape + (n,)), axis=-1))


def replay(x, v, given=False):
    """The kernel's reading and writing of the plan for (x, v), with the
    plain solve in place of its arithmetic: returns (plan, result)."""
    p = spline_kernel.plan(x, v, given)
    (na, xa, va, oa), (nb, xb, vb, ob) = p['axes']
    xk, vk, ok = p['knot_strides']
    n, nv = p['out'].shape[-1], p['v'].shape[-1]
    xs = p['x'].as_strided((na, nb, n), (xa, xb, xk))
    vs = p['v'].as_strided((na, nb, nv), (va, vb, vk))
    p['out'].as_strided((na, nb, n), (oa, ob, ok)).copy_(spline._solve(xs, vs, given))
    return p, p['out']


def rows_view(f):
    """The shared-knot entry's view of ``f`` (n, ...): the knots last."""
    return f.movedim(0, -1)


def cases(rng):
    """The callers' views: (name, x, v as the rows entry takes it, the
    layout the kernel takes them in)."""
    n = 40
    x = knots(rng, (), n)
    table = torch.from_numpy(rng.normal(size=(n, 6, 5)))            # Interpolator1D/2D: (n, columns...)
    y = torch.from_numpy(rng.normal(size=(30, n)))                   # the filter's rows
    xi = torch.from_numpy(rng.normal(size=(4, 3, n)))                # to_xi: xi (..., ns).movedim(-1, 0)
    fun = torch.from_numpy(rng.normal(size=(12, 7, 5)))              # Interpolator2D's (nx, ny, batch)
    z = knots(rng, (), 7)
    xr = knots(rng, (8, 1), n)                                       # knots per cosmology, shared over z
    fr = torch.from_numpy(rng.normal(size=(8, 7, n)))
    return [
        ('columns', x, rows_view(table), 'strided.shared'),
        ('y.T', x, rows_view(y.T), 'tiled.shared'),
        ('to_xi movedim', x, rows_view(xi.movedim(-1, 0)), 'tiled.shared'),
        ('My movedim', z, rows_view(fun.movedim(1, 0)), 'strided.shared'),
        ('expanded knots', xr.expand(8, 7, n), fr, 'tiled.rows'),
        ('knots-first rows', knots(rng, (9,), n).T.contiguous().T,
         torch.from_numpy(rng.normal(size=(n, 9))).T, 'strided.rows'),
        ('three axes', x, torch.from_numpy(rng.normal(size=(5, n, 4, 3))).movedim(1, -1)[:, ::2], 'tiled.shared'),
    ]


@pytest.mark.parametrize('index', range(7))
def test_plan_reads_the_callers_views(index):
    name, x, v, layout = cases(np.random.default_rng(0))[index]
    p, got = replay(x, v)
    assert spline_kernel.layout(p) == layout, name
    assert len(p['axes']) == 2
    if name != 'three axes':   # the views are taken as they are, with no copy
        assert p['v'].data_ptr() == v.data_ptr() and p['x'].data_ptr() == x.data_ptr(), name
    ref = spline._coeffs_rows_plain(x, v)
    assert got.shape == ref.shape
    assert ((got - ref).abs().max() / ref.abs().max()).item() <= BAR, name


def test_plan_lays_the_output_out_as_the_input():
    """The shared-knot entry's results moved back to the caller's axes are
    contiguous where the input was: Interpolator1D's columns, the filter's
    y.T (then .T), Interpolator2D's My (movedim and back)."""
    x = torch.linspace(0.0, 1.0, 20, dtype=torch.float64)
    table = torch.ones(20, 11, dtype=torch.float64)
    assert spline_kernel.plan(x, rows_view(table))['out'].movedim(-1, 0).is_contiguous()
    y = torch.ones(11, 20, dtype=torch.float64)
    assert spline_kernel.plan(x, rows_view(y.T))['out'].movedim(-1, 0).T.is_contiguous()
    fun = torch.ones(12, 20, 5, dtype=torch.float64)
    assert spline_kernel.plan(x, rows_view(fun.movedim(1, 0)))['out'].movedim(-1, 0).movedim(0, 1).is_contiguous()


def test_plan_of_a_given_right_hand_side():
    """The tangent and adjoint solves: n - 2 values a system, knots shared
    or expanded against a vmapped batch."""
    rng = np.random.default_rng(1)
    n = 25
    x = knots(rng, (3, 1, 1), n).expand(3, 4, 6, n)
    b = torch.from_numpy(rng.normal(size=(4, 6, n)))[..., 1:-1]
    p, got = replay(x, b, given=True)
    assert spline_kernel.layout(p) == 'tiled.rows'
    ref = spline._solve(x, b, True)
    assert ((got - ref).abs().max() / ref.abs().max()).item() <= BAR


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    """CPU tensors never reach the kernel's launch, and count no launch:
    the shared-knot entry's LU and the rows entry's scans, as before."""
    def refuse(*args, **kwargs):
        raise AssertionError('the kernel was launched for CPU tensors')

    monkeypatch.setattr(spline_kernel, 'launch', refuse)
    rng = np.random.default_rng(2)
    x = knots(rng, (), 30)
    f = torch.from_numpy(rng.normal(size=(30, 4)))
    launches, shapes = tracing.counters['spline.launches'], dict(tracing.counters['spline.shapes'])
    M = spline.natural_cubic_coeffs(x, f)
    h = torch.diff(x)
    T = torch.diag((h[:-1] + h[1:]) / 3.0) + torch.diag(h[1:-1] / 6.0, 1) + torch.diag(h[1:-1] / 6.0, -1)
    df = torch.diff(f, dim=0) / h[:, None]
    assert torch.equal(M[1:-1], torch.linalg.solve_ex(T, df[1:] - df[:-1])[0])
    xr = knots(rng, (4,), 30)
    Mr = spline.natural_cubic_coeffs_rows(xr, f.T)
    assert torch.equal(Mr, spline._coeffs_rows_plain(xr, f.T))
    assert tracing.counters['spline.launches'] == launches and tracing.counters['spline.shapes'] == shapes


def test_checks_raise():
    x = torch.linspace(0.0, 1.0, 10, dtype=torch.float64)
    f = torch.ones(3, 10, dtype=torch.float64)
    with pytest.raises(TypeError):
        spline_kernel.check(x, f.float())
    with pytest.raises(TypeError):
        spline_kernel.check(x, f.numpy())
    with pytest.raises(ValueError):
        spline_kernel.check(x.to('meta'), f)
    with pytest.raises(ValueError):
        spline_kernel.check(x, f[:, :8])
    with pytest.raises(ValueError):
        spline_kernel.check(x, f, given=True)
    spline_kernel.check(x, f[:, 1:-1], given=True)
    with pytest.raises(RuntimeError):
        spline_kernel.check(x.expand(4, 10), f)   # batches (4,) and (3,) do not broadcast
    with pytest.raises(ValueError):   # the kernel runs on CUDA tensors only
        spline_kernel.launch(x, f)


@pytest.mark.parametrize('shared', [True, False])
@pytest.mark.parametrize('given', [False, True])
def test_derivative_rules(shared, given):
    """The autograd function's backward and jvp (solves with a right-hand
    side given, dM = T^-1 (dr - dT M)) against finite differences
    (gradcheck, forward and reverse), with the plain solve in the kernel's
    place."""
    rng = np.random.default_rng(3)
    n = 9
    x = knots(rng, () if shared else (3,), n).requires_grad_(True)
    v = torch.from_numpy(rng.normal(size=(3, n - 2 if given else n))).requires_grad_(True)
    assert torch.autograd.gradcheck(lambda a, b: spline._NaturalSpline.apply(a, b, given), (x, v),
                                    check_forward_ad=True)


def test_jacfwd_vmap_and_grad_against_the_plain_autograd():
    """torch.func.jacfwd (vmap of jvp), vmap over the knots or the values,
    and reverse mode, through the autograd function, against torch's own
    derivatives of the plain version, knots depending on the parameter."""
    rng = np.random.default_rng(4)
    n = 12
    x0 = knots(rng, (5,), n)
    f0 = torch.from_numpy(rng.normal(size=(5, n)))

    def through(fn):
        return lambda s: fn(x0 * s[0], f0 * s[1] + s[0] ** 2)

    s = torch.tensor([1.1, 0.7], dtype=torch.float64)
    kernel_path = through(lambda a, b: spline._NaturalSpline.apply(a, b, False))
    plain = through(spline._coeffs_rows_plain)
    ref = torch.func.jacfwd(plain)(s)
    for got in (torch.func.jacfwd(kernel_path)(s), torch.func.jacrev(kernel_path)(s)):
        assert ((got - ref).abs().max() / ref.abs().max()).item() <= 1e-12
    xs = torch.stack([x0, 1.3 * x0])
    got = torch.func.vmap(lambda a: spline._NaturalSpline.apply(a, f0, False))(xs)
    assert torch.allclose(got, torch.stack([spline._coeffs_rows_plain(a, f0) for a in xs]), rtol=1e-13, atol=0)
    fs = torch.stack([f0, 2 * f0], dim=1)
    got = torch.func.vmap(lambda b: spline._NaturalSpline.apply(x0[0], b, False), in_dims=1)(fs)
    ref = torch.stack([spline._coeffs_rows_plain(x0[0], fs[:, i]) for i in range(2)])
    assert torch.allclose(got, ref, rtol=1e-13, atol=0)
