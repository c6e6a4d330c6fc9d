"""The line-of-sight source taps of the port's perturbation loops
(cosmoprimo_tpu_torch/boltzmann/perturbations.py: compute_los_sources,
compute_perturbation_series and their emitters) against the JAX package's,
on the same parameters and the same (JAX) recombination history, on the CPU.

Bars, and the deviations measured on the CPU:
- the emitters of both phases (the five source rows, psi' among them) on
  seeded random states and random eta, on the JAX package's own tables:
  1e-12 of each row's max (measured <= 1.1e-15; psi' against the JAX
  package's forward mode through the metric constraint); the fetch's
  d/deta against jax.jvp of the JAX fetch at 1e-12 of the larger of the
  rate's max and its products' (value / (eta dlneta)), the scale of the
  reference's own rounding (measured <= 4.1e-12 of the rate's max alone, on
  w_nc);
- compute_los_sources and compute_perturbation_series at n_steps = (2048,
  768, 2048) on 8 k <= 0.05 /Mpc for two cosmologies in one batch (the DESI
  one with a 0.06 eV species; w0 = -0.9, wa = 0.1, Omega_k = 0.02): every
  row 1e-9 of its max (measured <= 1.1e-11 on the sources, 5.7e-12 on the
  series), the tau grid, g, e^-kappa and tau_star 1e-12 (measured
  <= 3.9e-14);

The reference's phase-A end point is put on the streaming switch as in
tests/test_torch_perturbations.py (tests/native_reference.py).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip('jax')

import jax.numpy as jnp  # noqa: E402

from cosmoprimo_tpu.boltzmann import perturbations as JP  # noqa: E402
from cosmoprimo_tpu.boltzmann.thermodynamics import ThermodynamicsResult as JaxResult  # noqa: E402
from cosmoprimo_tpu_torch.boltzmann import perturbations as P  # noqa: E402
from native_reference import exact_switch  # noqa: E402
from test_torch_perturbations import jax_cosmology, jax_tables, row_err, torch_inputs, torch_tables  # noqa: E402

BAR = 1e-12
SRC_BAR = 1e-9
N_STEPS = (2048, 768, 2048)
K = np.geomspace(1e-3, 0.05, 8)     # 1/Mpc
NAMES = ('desi', 'w0wa_curved')


def test_emitters_and_rates():
    """On the JAX package's own tables, so that only the emitters' arithmetic
    differs."""
    jt = jax_tables('desi', 512)
    tabs = torch_tables(jt)
    rng = np.random.default_rng(2)
    k = np.geomspace(1e-3, 0.5, 16)
    eta = np.exp(rng.uniform(np.log(1.0), np.log(14000.0), k.size))
    etaB = np.exp(rng.uniform(np.log(250.0), np.log(14000.0), k.size))
    y = rng.normal(size=(P.N_STATE, k.size))
    yB = rng.normal(size=(10, k.size))
    J = jnp.asarray
    tk, te, teB = (torch.from_numpy(v)[None] for v in (k, eta, etaB))
    lanes = P.Lanes(tabs, tk)

    def t(a):
        return torch.from_numpy(np.array(a))[:, None].clone()

    ca = P._coefs_a(P._fetch(tabs, te, lanes, rates=True), lanes, te)
    ref_rates = jax.jvp(lambda e: JP._fetch(jt, e), (J(eta),), (jnp.ones_like(J(eta)),))[1]
    # the rate is the difference of two products value * dw, dw = 1 /
    # (eta dlneta): its rounding scale is that of the products
    dw = 1.0 / (eta * float(jt['dlneta']))
    for name in P._STACK_NAMES:
        got, want = ca['rate'][name][0].numpy(), np.asarray(ref_rates[name])
        scale = max(np.max(np.abs(want)), np.max(np.abs(ca[name][0].numpy()) * dw))
        assert np.max(np.abs(got - want)) <= BAR * scale, name
    ca['rate'] = P._psi_rates_a(ca, lanes)
    cb = P._coefs_b(P._fetch(tabs, teB, lanes, rates=True), lanes, teB)
    cb['rate'] = P._psi_rates_b(cb, lanes)
    emit_a, emit_b = JP._los_emitters(jt, J(k), jt['am'])
    cases = {
        'los A': (P._emit_los_a(t(y), P.deriv_full(t(y), lanes, ca), lanes, ca),
                  emit_a(J(y), J(eta), JP._fetch(jt, J(eta)))),
        'los B': (P._emit_los_b(t(yB), P.deriv_rsa(t(yB), lanes, cb), lanes, cb),
                  emit_b(J(yB), J(etaB), JP._fetch(jt, J(etaB)))),
    }
    for name, (got, want) in cases.items():
        for row in range(want.shape[0]):
            assert row_err(got[row, 0].numpy(), want[row]) <= BAR, (name, row)


def jax_run(fn, name, k):
    params, table = jax_cosmology(name)
    out = jax.jit(lambda p, t: {key: value for key, value in fn(p, JaxResult(**t), jnp.asarray(k), n_steps=N_STEPS)
                                .items() if key != 'names'})(params, table)
    return {key: np.asarray(value) for key, value in out.items()}


@pytest.mark.parametrize('kind', ['sources', 'series'])
def test_sources_against_jax(kind, monkeypatch):
    exact_switch(monkeypatch)
    params, thermo = torch_inputs(list(NAMES))
    k = torch.from_numpy(K).expand(len(NAMES), -1).contiguous()
    if kind == 'sources':
        got = P.compute_los_sources(params, thermo, k, n_steps=N_STEPS)
        fn, key, scalars = JP.compute_los_sources, 'src', ('tau', 'g', 'emk', 'tau_star')
    else:
        got = P.compute_perturbation_series(params, thermo, k, n_steps=N_STEPS)
        fn, key, scalars = JP.compute_perturbation_series, 'series', ('tau', 'a')
    for i, name in enumerate(NAMES):
        ref = jax_run(fn, name, K)
        for s in scalars:
            assert row_err(got[s][i].numpy().reshape(np.shape(ref[s])), ref[s]) <= BAR, (name, s)
        for row in range(ref[key].shape[1]):
            assert row_err(got[key][i, :, row].numpy(), ref[key][:, row]) <= SRC_BAR, (name, row)
