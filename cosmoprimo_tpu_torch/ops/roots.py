"""Batched fixed-cap loops (cosmoprimo_tpu/ops/roots.py::for_cond_loop), for
the Newton iterations of the neutrino sector."""

import torch


_CHECK_EVERY = 8


def for_cond_loop(lower, upper, cond_fun, body_fun, init_val):
    """``for i in range(lower, upper)``: each row of the batch takes
    ``body_fun(i, val)`` while ``cond_fun(i, val)`` holds for it, and keeps
    its value from then on, as the JAX loop does for one cosmology.

    ``val`` is a tuple of tensors of the batch shape, and ``cond_fun``
    returns a boolean tensor of that shape. The body runs on every row and
    its result is masked where the row has stopped, so a stopped row never
    drifts. The loop ends at ``upper``, or earlier once no row is running:
    that is checked on the host every 8 steps only, since each check waits
    for the device."""
    val = tuple(init_val)
    for i in range(lower, upper):
        active = cond_fun(i, val)
        if (i - lower) % _CHECK_EVERY == 0 and not bool(active.any()):
            break
        new = body_fun(i, val)
        val = tuple(torch.where(active, n, v) for n, v in zip(new, val))
    return val
