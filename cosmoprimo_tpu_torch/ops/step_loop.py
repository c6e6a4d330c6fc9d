"""Fixed-length sequential loops (the JAX package's ``lax.scan`` over a
static grid) on a batch, replayed from captured CUDA graphs on the card.

The native Boltzmann solver runs three such loops: the recombination scan
(boltzmann/thermodynamics.py) and the two RK4 phases of the perturbations
(boltzmann/perturbations.py). Each step is a few hundred small elementwise
launches on (batch, k) lanes, so run eagerly the loops are bound by the
host's launch rate. :func:`step_loop` cuts the grid into chunks of steps:
what a chunk's steps read that does not depend on the carry (the
coefficients at its grid points) is made once per chunk by ``prepare``, in
a few vectorized launches, and on the card each chunk is one replay of a
captured ``torch.cuda.CUDAGraph``: the chunk's grid columns sit in static
buffers refilled before each replay, and the carry stays in the graph's own
buffers.
"""

import math

import torch
import torch.autograd.forward_ad as forward_ad

CHUNK = 32


def is_dual(tensor):
    """True for a tensor under forward-mode AD: a dual tensor of
    ``torch.autograd.forward_ad``, or one wrapped by a ``torch.func``
    transform (``jvp``, ``jacfwd``, which wrap their tangents)."""
    return (torch._C._functorch.is_functorch_wrapped_tensor(tensor)
            or forward_ad.unpack_dual(tensor).tangent is not None)


def step_loop(step, carry, columns, prepare=None, graphs=True):
    """Run the n steps of the grid ``columns`` (tensors with n + 1 rows on
    their leading axis) in chunks of c = gcd(n, CHUNK) steps: for each
    chunk, ``data = prepare(cols)`` with ``cols`` the chunk's c + 1 rows of
    each column (``prepare`` None gives ``cols``), then ``carry, emitted =
    step(carry, data, j)`` for j = 0 .. c - 1, ``emitted`` a tuple of tensors
    (possibly empty). Returns the final carry and the emitted tensors
    stacked on a leading step axis (n, ...).

    On a CUDA tensor, with ``graphs``, each chunk after the first is a
    replay of one captured CUDA graph; a capture that fails raises. Under
    forward-mode AD (see :func:`is_dual`) the loop runs eagerly instead, an
    explicit branch: a replayed graph carries no tangent. Tensors that
    require grad are refused on the card for the same reason. On the CPU,
    or with ``graphs=False``, it runs eagerly."""
    carry = tuple(carry)
    n = columns[0].shape[0] - 1
    c = math.gcd(n, CHUNK)
    prepare = prepare or (lambda cols: cols)

    def body(carry, cols):
        data = prepare(cols)
        emitted = []
        for j in range(c):
            carry, em = step(carry, data, j)
            emitted.append(em)
        return carry, emitted

    tensors = carry + tuple(columns)
    if graphs and carry[0].is_cuda and not any(is_dual(t) for t in tensors):
        if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
            raise NotImplementedError('a replayed CUDA graph records no gradient: differentiate the native '
                                      'solver in forward mode (torch.func.jvp / jacfwd)')
        return _graph_loop(body, carry, columns, n, c)
    emitted = []
    for base in range(0, n, c):
        carry, em = body(carry, tuple(col[base:base + c + 1] for col in columns))
        emitted.extend(em)
    return carry, tuple(torch.stack(e) for e in zip(*emitted))


def _graph_loop(body, carry, columns, n, c):
    """:func:`step_loop` from one CUDA graph of a chunk, replayed n / c - 1
    times. The first chunk runs eagerly on a side stream (the warm-up that
    capture needs) into the same static buffers, then the graph is captured
    and replayed for the others."""
    static_cols = tuple(col[:c + 1].clone() for col in columns)
    static_carry = tuple(t.clone() for t in carry)
    static_emit = []

    def run():
        new, emitted = body(static_carry, static_cols)
        if not static_emit:
            static_emit.extend(e.new_empty((c,) + e.shape) for e in (emitted[0] if emitted else ()))
        for j, em in enumerate(emitted):
            for buf, e in zip(static_emit, em):
                buf[j].copy_(e)
        for s, v in zip(static_carry, new):
            s.copy_(v)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    outs = [e.new_empty((n,) + e.shape[1:]) for e in static_emit]
    for out, e in zip(outs, static_emit):
        out[:c].copy_(e)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    for base in range(c, n, c):
        for s, col in zip(static_cols, columns):
            s.copy_(col[base:base + c + 1])
        graph.replay()
        for out, e in zip(outs, static_emit):
            out[base:base + c].copy_(e)
    return tuple(t.clone() for t in static_carry), tuple(outs)
