"""The port's P(k) table interpolators at the ends of their k range
(cosmoprimo_tpu_torch/interpolator.py::_pad_log) against the JAX package's,
unpatched, on the CPU.

The log-log spline is padded with two knots per side on the edge power law.
Where a table ends at the extrapolation bound (k[-1] = extrap_kmax =
1e2 h/Mpc, every table on the default grid), the JAX package puts them
4e-10 dex from the edge knot, and the spline divides ulp-level differences
of log10 P by that gap; the port puts the outer one 1e-3 dex beyond
(_PAD_STEP). The natural spline is global, so the change decays by ~0.27 a
knot into the table.

Bars, and the deviations measured on the CPU (default grid logspace(-6, 2,
500), a smooth P(k) with a wiggle; 1D and 2D with five redshifts):
- below the last eight cells (k < k[-9]): rtol 1e-12 (measured 1.0e-13 1D);
- in the last eight cells and the padding up to 1e2: rtol 1e-7 (measured
  3.9e-9 in the last cell, 1.0e-9 in the one before, 5.4e-12 five cells in,
  1D; 2.3e-8 2D);
- to_xi on its default grid: 1e-9 of each row's max (measured 6.1e-11 1D,
  3.7e-10 2D);
- the repair itself: one ulp of noise on every padded knot (the card's
  log10 and pow round otherwise than the CPU's) moves P(k) in the last cell
  by at most 1e-12 at both ends of a 1e-7 ... 1e2 table (measured 9.9e-14;
  2.4e-7 with the JAX package's padding).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')

from cosmoprimo_tpu import interpolator as JI  # noqa: E402
from cosmoprimo_tpu_torch import interpolator as I  # noqa: E402

K = np.logspace(-6.0, 2.0, 500)
Z = np.linspace(0.0, 3.0, 5)
KQ = np.geomspace(1e-7, 1e2, 5000)
EDGE = 9           # the last eight cells
RTOL, EDGE_RTOL, XI_BAR, NOISE_BAR = 1e-12, 1e-7, 1e-9, 1e-12


def pk_of(k):
    return 1e4 * (k / 0.02) / (1.0 + (k / 0.02) ** 2.6) * (1.0 + 0.05 * np.sin(k * 80.0) * np.exp(-k / 0.3))


def xi_err(got, ref):
    return np.max(np.abs(got - ref) / np.max(np.abs(ref), axis=0, keepdims=True))


@pytest.mark.parametrize('dim', [1, 2])
def test_against_unpatched_jax(dim):
    if dim == 1:
        pk = pk_of(K)
        ref, got = JI.PowerSpectrumInterpolator1D(K, pk), I.PowerSpectrumInterpolator1D(K, torch.from_numpy(pk))
        a, b = np.asarray(ref(KQ)), got(torch.from_numpy(KQ)).numpy()
    else:
        pk = pk_of(K)[:, None] / (1.0 + Z) ** 2
        ref, got = JI.PowerSpectrumInterpolator2D(K, Z, pk), I.PowerSpectrumInterpolator2D(K, Z, torch.from_numpy(pk))
        a, b = np.asarray(ref(KQ, Z)), got(torch.from_numpy(KQ), torch.from_numpy(Z)).numpy()
    dev = np.abs(b / a - 1.0).reshape(KQ.size, -1)
    inside = KQ < K[-EDGE]
    assert dev[inside].max() <= RTOL
    assert dev[~inside].max() <= EDGE_RTOL
    s = np.geomspace(1e-2, 1e3, 800)
    if dim == 1:
        assert xi_err(got.to_xi()(torch.from_numpy(s)).numpy(), np.asarray(ref.to_xi()(s))) <= XI_BAR
    else:
        assert xi_err(got.to_xi()(torch.from_numpy(s), torch.from_numpy(Z)).numpy(),
                      np.asarray(ref.to_xi()(s, Z))) <= XI_BAR


def test_padding_resolves_rounding(monkeypatch):
    k = np.geomspace(1e-7, 1e2, 384)
    pk = torch.from_numpy(np.stack([pk_of(k), 2.0 * pk_of(k)]))
    kq = torch.from_numpy(np.concatenate([np.geomspace(k[0] * (1 + 1e-12), k[1], 50),
                                          np.geomspace(k[-2], k[-1] * (1 - 1e-12), 50)]))
    clean = I.PowerSpectrumInterpolator1D(k, pk)(kq).numpy()
    pad, rng = I._pad_log, np.random.default_rng(5)

    def noisy(*args, **kwargs):
        kk, pp = pad(*args, **kwargs)
        return (kk * (1.0 + 2.2e-16 * torch.from_numpy(rng.choice([-1.0, 0.0, 1.0], size=kk.shape))),
                pp * (1.0 + 2.2e-16 * torch.from_numpy(rng.choice([-1.0, 0.0, 1.0], size=pp.shape))))

    monkeypatch.setattr(I, '_pad_log', noisy)
    for _ in range(5):
        moved = I.PowerSpectrumInterpolator1D(k, pk)(kq).numpy()
        assert np.max(np.abs(moved / clean - 1.0)) <= NOISE_BAR
