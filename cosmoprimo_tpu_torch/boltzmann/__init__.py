"""The native Boltzmann solver (cosmoprimo_tpu/boltzmann/): recombination
thermodynamics and linear perturbations, batched over cosmologies."""

from .thermodynamics import ThermodynamicsResult, compute_thermodynamics

__all__ = ['ThermodynamicsResult', 'compute_thermodynamics']
