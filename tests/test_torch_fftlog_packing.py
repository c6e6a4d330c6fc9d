"""The algebra of the FFTLog CUDA kernel (csrc/fftlog_core.cu), on the CPU.

The kernel transforms two rows at once: rows a and a + nparallel share u, so
z = f_a + i f_b goes through fft, a multiply by the Hermitian-extended u and a
second fft, and the real and imaginary parts of the result are the two rows'
outputs. Two rules make that exact:
- bins 0 and n/2 are multiplied by Re(u) only, since irfft ignores Im there
  and a complex u there would mix row b into row a;
- each row is scaled by a power of two (from frexp of its max |f|) before
  packing and back after, so that round-off of a large row does not leak
  into a small one.

``packed_reference`` below is that algebra in torch.fft on the CPU. It is held
to the kernel's plain version ``fftlog_core_torch`` and to the JAX package's
``fftlog_pair_reference`` (with the padding, prefactor and crop applied around
it), per row at max|d| / max|row| <= 1e-12. One case drops the Re(u) rule and
shows that it then fails.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')
import jax.numpy as jnp  # noqa: E402

from cosmoprimo_tpu.ops.pallas_fft import fftlog_pair_reference  # noqa: E402
from cosmoprimo_tpu_torch import PowerToCorrelation  # noqa: E402
from cosmoprimo_tpu_torch.ops import fftlog_kernel  # noqa: E402

BAR = 1e-12


def padded_rows(x, prefactor, in_left):
    nparallel, n = prefactor.shape
    rows, size = x.shape
    f = x.new_zeros((rows, n))
    f[:, in_left:in_left + size] = x
    return f * prefactor[torch.arange(rows) % nparallel]


def hermitian_u(u, re_rule):
    """(nparallel, n) u_ext with u_ext[n - k] = conj(u[k]); Re(u) at 0 and
    n/2 when ``re_rule``."""
    u = u.clone()
    if re_rule:
        u[:, 0] = u[:, 0].real.clone()
        u[:, -1] = u[:, -1].real.clone()
    return torch.cat([u, torch.conj(u[:, 1:-1].flip(-1))], dim=-1)


def packed_reference(x, u, prefactor, postfactor, in_left, out_left, re_rule=True):
    """The kernel's algebra: row pairs (a, a + nparallel), power-of-two
    scaling, fft, u_ext, fft, split; a non-finite row gives a NaN row."""
    nparallel, n = prefactor.shape
    rows, size = x.shape
    f = padded_rows(x, prefactor, in_left)
    groups = rows // nparallel
    q, p = torch.meshgrid(torch.arange((groups + 1) // 2), torch.arange(nparallel), indexing='ij')
    a = (2 * q * nparallel + p).reshape(-1)
    b = a + nparallel
    has_b = b < rows
    f = torch.cat([f, f.new_zeros((1, n))])          # row `rows` stands for the missing partner
    fa, fb = f[a], f[torch.where(has_b, b, rows)]

    def scale(g):
        m = g.abs().amax(dim=-1)
        ok = torch.isfinite(m)
        e = torch.frexp(torch.where(ok, m, 0.0))[1].to(torch.float64)
        return torch.where(ok[:, None], g * 2.0 ** -e[:, None], 0.0), torch.where(ok, 2.0 ** e / n, torch.nan)

    za, sa = scale(fa)
    zb, sb = scale(fb)
    w = torch.fft.fft(torch.fft.fft(torch.complex(za, zb)) * hermitian_u(u, re_rule)[a % nparallel])
    post = postfactor[a % nparallel]
    ta = (w.real * sa[:, None] * post)[:, out_left:out_left + size]
    tb = (w.imag * sb[:, None] * post)[:, out_left:out_left + size]
    out = x.new_empty((rows, size))
    out[a] = ta
    out[b[has_b]] = tb[has_b]
    return out


def jax_reference(x, u, prefactor, postfactor, in_left, out_left):
    """fftlog_pair_reference row group by row group (it takes one u)."""
    nparallel, n = prefactor.shape
    rows, size = x.shape
    f = padded_rows(x, prefactor, in_left).numpy()
    out = np.empty((rows, size))
    for p in range(nparallel):
        uh = u[p].numpy()
        t = fftlog_pair_reference(jnp.asarray(f[p::nparallel]), jnp.asarray(uh.real), jnp.asarray(uh.imag),
                                  jnp.asarray(postfactor[p].numpy()))
        out[p::nparallel] = np.asarray(t)[:, out_left:out_left + size]
    return torch.from_numpy(out)


def row_err(got, ref):
    """Per row max|d| / max|row|; rows of ref that are NaN must be NaN in got."""
    got, ref = torch.as_tensor(got), torch.as_tensor(ref)
    nan = torch.isnan(ref).all(dim=-1)
    assert torch.equal(torch.isnan(got).all(dim=-1), nan)
    return ((got - ref)[~nan].abs().amax(dim=-1) / ref[~nan].abs().amax(dim=-1)).max().item()


def random_case(seed, rows, size, n, nparallel, in_left, out_left, ratio=1.0, nan_row=None):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(nparallel, n // 2 + 1)) + 1j * rng.normal(size=(nparallel, n // 2 + 1))
    x = rng.normal(size=(rows, size))
    x[1::2] *= ratio
    if nan_row is not None:
        x[nan_row, size // 2] = np.nan
    pre, post = rng.uniform(0.5, 2.0, (nparallel, n)), rng.normal(size=(nparallel, n))
    args = [torch.from_numpy(a) for a in (x, u, pre, post)]
    return args + [in_left, out_left]


def p2c_lowring_off_case(rows):
    k = np.geomspace(1e-4, 1e1, 100)
    tr = PowerToCorrelation(k, lowring=False)
    amplitude = np.random.default_rng(7).uniform(0.5, 2.0, (rows, 1))
    x = torch.from_numpy(amplitude * 1e4 * (k / 0.1) ** 0.96 / (1 + (k / 0.1) ** 3))
    arrays = tr._arrays(torch.device('cpu'))
    return [x, arrays['padded_u'], arrays['padded_prefactor'], arrays['padded_postfactor'],
            tr.padded_size_in_left, tr.padded_size_out_left]


CASES = {
    'complex u': lambda: random_case(0, 6, 40, 64, 1, 12, 10),
    'nparallel 3, odd rows per p': lambda: random_case(1, 15, 100, 128, 3, 20, 8),
    'odd row count': lambda: random_case(2, 7, 200, 256, 1, 0, 56),
    'PowerToCorrelation lowring=False': lambda: p2c_lowring_off_case(5),
    'scale ratio 1e8': lambda: random_case(3, 2, 100, 128, 1, 14, 14, ratio=1e-8),
    'NaN row beside a finite one': lambda: random_case(4, 4, 50, 64, 1, 7, 7, nan_row=1),
}


@pytest.mark.parametrize('name', list(CASES))
def test_packed_algebra_against_plain_and_jax(name):
    args = CASES[name]()
    got = packed_reference(*args)
    assert row_err(got, fftlog_kernel.fftlog_core_torch(*args)) <= BAR
    assert row_err(got, jax_reference(*args)) <= BAR


def test_lowring_off_has_complex_nyquist():
    """The lowring=False case above reaches the Re(u) rule at n/2."""
    u = p2c_lowring_off_case(1)[1]
    assert abs(u[0, -1].imag) > 1e-3 * abs(u[0, -1])


@pytest.mark.parametrize('name', ['complex u', 'PowerToCorrelation lowring=False'])
def test_packing_without_re_rule_fails(name):
    """With the full complex u at bins 0 and n/2, row b leaks into row a."""
    args = CASES[name]()
    assert row_err(packed_reference(*args, re_rule=False), fftlog_kernel.fftlog_core_torch(*args)) > 1e-6
