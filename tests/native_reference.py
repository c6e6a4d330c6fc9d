"""The JAX package's native solver as a reference for the port's tests.

Phase A of the perturbation integration ends at eta_Aend = 45/k, on the
streaming switch k eta > 45 itself, and phase B's dark-energy switch
(cs2 = 1) starts on it. The JAX package evaluates both switches at that
point with the value its grid interpolation returns, so its last bit
decides the branch: about a third of the lanes in 0.003 < k < 0.16 /Mpc land
past the switch, which moves P(k) there by up to ~5e-5 (and everything by
~4e-6 through the sigma8 rescaling). The port decides as exact arithmetic
does: not past the switch. :func:`exact_switch` puts the reference's end
point of phase A and start point of phase B on the switch, as the port
does, so that both decide alike and the tests can hold the port to the
reference at 1e-9. :func:`switch_lanes` names the lanes on which the
unpatched reference may depart, so that the tests also bound the port's
distance to the reference as it is.
"""

import jax
import jax.numpy as jnp
import numpy as np

from cosmoprimo_tpu.boltzmann import perturbations as JP
from cosmoprimo_tpu.boltzmann.thermodynamics import ThermodynamicsResult


def _on_switch(eta, k):
    return jnp.abs(k * eta / JP.RSA_KETA - 1.0) <= 1e-12


def _onto_switch(eta, k):
    """``eta`` where it is off the switch; where it is on it (k eta = 45
    within 1e-12), 45/k, moved down by ulps until k eta <= 45."""
    on = _on_switch(eta, k)
    switch = JP.RSA_KETA / k
    for _ in range(4):
        switch = jnp.where(k * switch > JP.RSA_KETA, jnp.nextafter(switch, 0.0), switch)
    return jnp.where(on, switch, eta)


def exact_switch(monkeypatch):
    """Patch the JAX package's build_time_grids with the switch decided as
    in exact arithmetic (see the module docstring)."""
    build = JP.build_time_grids

    def patched(tabs, k, n_steps_a=None, n_steps_b=None):
        eta_A, eta_B, eta_ini = build(tabs, k, n_steps_a=n_steps_a, n_steps_b=n_steps_b)
        eta_A = eta_A.at[:, -1].set(_onto_switch(eta_A[:, -1], k))
        eta_B = eta_B.at[:, 0].set(_onto_switch(eta_B[:, 0], k))
        return eta_A, eta_B, eta_ini

    monkeypatch.setattr(JP, 'build_time_grids', patched)


def switch_lanes(params, table, k_hMpc, n_steps):
    """The lanes of ``k_hMpc`` [h/Mpc] whose phase A ends on the streaming
    switch (0.003 < k < 0.16 /Mpc) in the JAX package's grid, for its
    solver parameters ``params`` and recombination ``table`` (a dict of
    ThermodynamicsResult's fields) at the budget ``n_steps``: the lanes on
    which the unpatched reference may decide the switch otherwise than the
    port. A numpy bool array."""
    na, nb, m_tab = n_steps

    def lanes(p, t):
        tabs = JP.build_tables(p, ThermodynamicsResult(**t), m_tab=m_tab)
        k = jnp.asarray(k_hMpc) * p['h']
        return _on_switch(JP.build_time_grids(tabs, k, n_steps_a=na, n_steps_b=nb)[0][:, -1], k)

    return np.asarray(jax.jit(lanes)(params, table))
