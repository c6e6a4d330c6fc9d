"""Batched fixed-cap loops and root finding (cosmoprimo_tpu/ops/roots.py::
for_cond_loop, bracket and bisect), for the Newton iterations of the
neutrino sector, the reionization redshift and ``Cosmology.solve``."""

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


def bracket(f, init, maxiter=15, maxtries=None):
    """A sign change of ``f`` per row, stepping from ``init`` = (x1, dx) or
    (x1, dx, f1): x1 moves by -1.5 dx while f keeps its sign. ``f`` maps a
    tensor of the batch shape to one of the same shape; x1 and dx are floats
    or such tensors. Returns (lo, hi), the last two points of each row, lo
    <= hi. ``maxtries`` (the reference's retry count on an exception) is
    accepted and ignored, as in the JAX package: a batch is not retried.

    Every row takes ``maxiter`` steps, a row that has found its sign change
    (or started on a root) frozen by ``torch.where``, as the vmapped JAX
    loop is: nothing is read on the host."""
    if len(init) == 2:
        x1, dx = init
        f1 = f(x1)
    else:
        x1, dx, f1 = init
    x1 = torch.as_tensor(x1, dtype=f1.dtype, device=f1.device).expand(f1.shape)
    dx = 1.5 * dx
    running = f1 ** 2 > 0
    x0, x2 = x1, x1 - dx
    for _ in range(maxiter):
        new = x1 - dx
        f2 = f(new)
        step = running
        running = step & (f1 * f2 > 0)
        x0, x2 = torch.where(step, x1, x0), torch.where(step, new, x2)
        x1, f1 = torch.where(running, new, x1), torch.where(running, f2, f1)
    return torch.minimum(x0, x2), torch.maximum(x0, x2)


def bisect(f, limits, flimits=None, xtol=1e-6, maxiter=100, method='ridders'):
    """Root of ``f`` in ``limits`` = (a, b), per row: Ridders' method by
    default, else plain bisection. ``f`` maps a tensor of the batch shape to
    one of the same shape; ``a`` and ``b`` are floats or such tensors.

    Each row iterates until its bracket is narrower than ``xtol`` (the JAX
    rule: Ridders tests the width before its last update) or ``maxiter``. An
    end point with f = 0 is the root. A row whose f(a), f(b) have the same
    sign is NaN, where the JAX package raises outside a trace."""
    a, b = limits
    fa, fb = flimits if flimits is not None else (f(a), f(b))
    a, b = (torch.as_tensor(v, dtype=fa.dtype, device=fa.device).expand(fa.shape) for v in (a, b))
    sign = torch.where((fa < 0) & (fb > 0), 1.0, torch.where((fa > 0) & (fb < 0), -1.0, 0.0))
    # an end point exactly on the root is a degenerate but valid bracket
    has_endpoint_root = (fa == 0) | (fb == 0)
    endpoint_root = torch.where(fa == 0, a, torch.where(fb == 0, b, torch.nan))
    width0 = torch.full_like(fa, 1.0 + xtol)

    if method == 'ridders':

        def body(i, state):
            xlow, flow, xhigh, fhigh, _, _ = state
            mid = 0.5 * (xlow + xhigh)
            fmid = f(mid)
            s = torch.sqrt(fmid * fmid - flow * fhigh)
            sgn = torch.where(flow >= 0.0, 1.0, -1.0)
            # s == 0: an iterate hit the root exactly; keep mid, not 0/0
            step = torch.where(s > 0, (mid - xlow) * sgn * fmid / torch.where(s > 0, s, 1.0), 0.0)
            new = mid + step
            fnew = f(new)
            keep_mid = fmid * fnew <= 0
            keep_low = flow * fnew < 0
            xlow_n = torch.where(keep_mid, mid, torch.where(keep_low, xlow, new))
            flow_n = torch.where(keep_mid, fmid, torch.where(keep_low, flow, fnew))
            xhigh_n = torch.where(keep_mid | keep_low, new, xhigh)
            fhigh_n = torch.where(keep_mid | keep_low, fnew, fhigh)
            return xlow_n, flow_n, xhigh_n, fhigh_n, xhigh - xlow, new

        init = (a, fa, b, fb, width0, 0.5 * (a + b))
    else:

        def body(i, state):
            low, high, x, _ = state
            too_large = sign * f(x) > 0
            high = torch.where(too_large, x, high)
            low = torch.where(too_large, low, x)
            return low, high, 0.5 * (low + high), high - low

        init = (a, b, 0.5 * (a + b), width0)
    width = 4 if method == 'ridders' else 3

    def cond(i, state):
        return torch.abs(state[width]) > xtol

    state = for_cond_loop(0, maxiter, cond, body, init)
    new = state[5] if method == 'ridders' else state[2]
    new = torch.where(has_endpoint_root, endpoint_root, new)
    return torch.where((sign == 0) & ~has_endpoint_root, torch.nan, new)
