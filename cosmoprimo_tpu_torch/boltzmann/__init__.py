"""The native Boltzmann solver (cosmoprimo_tpu/boltzmann/): recombination
thermodynamics, linear perturbations and the CMB spectra (the line-of-sight
projection, the lensing and the tensor modes), batched over cosmologies."""

from .thermodynamics import ThermodynamicsResult, compute_thermodynamics

__all__ = ['ThermodynamicsResult', 'compute_thermodynamics']
