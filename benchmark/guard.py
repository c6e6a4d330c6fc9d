"""The check that the run has loaded no JAX: top-level module names, the
part before the first dot, compared whole (``cosmoprimo_tpu_torch`` is the
program; ``cosmoprimo_tpu`` is the JAX package it was ported from)."""

import sys

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'cosmoprimo_tpu')


def loaded(modules=None):
    """The forbidden top-level names found in ``modules`` (sys.modules)."""
    modules = sys.modules if modules is None else modules
    return sorted({name.split('.', 1)[0] for name in modules} & set(FORBIDDEN))


def check(when):
    found = loaded()
    if found:
        raise SystemExit(f'benchmark: {", ".join(found)} loaded {when}; the run takes no JAX')
