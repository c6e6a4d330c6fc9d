"""Shape policy, host callbacks and NaN-poisoning validation
(cosmoprimo_tpu/ops/misc.py)."""

import functools

import numpy as np
import torch


def _torch_dtype(dtype):
    """A torch dtype for a torch dtype, or a numpy dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=dtype)).dtype


def bcast_dtype(*args):
    """The dtype of a result computed from ``args`` (the JAX package's
    rule): float64 if any argument is float64 or has no dtype (a Python
    float, a list), or if none is floating; else the first floating
    argument's dtype, e.g. float32 for float32 inputs. ``None`` and integer
    arrays do not count."""
    dtypes = []
    for arg in args:
        if arg is None:
            continue
        dtype = getattr(arg, 'dtype', None)
        if dtype is None:
            dtypes.append(torch.float64)
        elif isinstance(dtype, torch.dtype):
            if dtype.is_floating_point:
                dtypes.append(dtype)
        elif np.issubdtype(dtype, np.floating):
            dtypes.append(_torch_dtype(dtype))
    if not dtypes or torch.float64 in dtypes:
        return torch.float64
    return dtypes[0]


def flatarray(iargs=(0,), dtype=None):
    """Decorator for methods taking array arguments at positions ``iargs``
    (after ``self``): each is made a float64 tensor on ``self.device`` and
    raveled to 1D for the computation, and the last axis of the output is
    reshaped back to the shape of the first, so scalar in gives the batch
    shape out. Leading output axes (the batch) are kept. The output is cast
    to ``dtype`` (a torch or numpy dtype) if given, else to
    :func:`bcast_dtype` of the arguments, float32 in giving float32 out; a
    float64 output is returned as it is."""
    def decorator(func):

        @functools.wraps(func)
        def wrapper(self, *args, **kwargs):
            args = list(args)
            shapes = []
            out_dtype = _torch_dtype(dtype) if dtype is not None else bcast_dtype(*[args[i] for i in iargs])
            for i in iargs:
                array = torch.as_tensor(args[i], dtype=torch.float64, device=self.device)
                shapes.append(array.shape)
                args[i] = array.reshape(-1)
            toret = func(self, *args, **kwargs)
            if dtype is not None or out_dtype != torch.float64:
                toret = toret.to(out_dtype)
            return toret.reshape(toret.shape[:-1] + shapes[0])

        return wrapper

    return decorator


def exception(func, *args):
    """Call ``func(*args)`` on the host, for its side effects (a warning, or
    raising), with tensor arguments copied there as numpy arrays; this
    waits for the device. Returns None."""
    func(*(arg.detach().cpu().numpy() if isinstance(arg, torch.Tensor) else arg for arg in args))


def exception_or_nan(value, cond, error):
    """Where ``cond`` holds, poison ``value`` with NaN. A tensor is never
    checked on the host (that would synchronise with the device): its
    offending rows become NaN. With neither argument a tensor, a true
    ``cond`` raises through ``error(value)``."""
    if isinstance(cond, torch.Tensor) or isinstance(value, torch.Tensor):
        return torch.where(torch.as_tensor(cond), torch.nan, value)
    if np.any(np.asarray(cond)):
        error(value)
    return value


def batch_scalar(value, n=1):
    """A per-cosmology scalar (a float, or a tensor of the batch shape) with
    ``n`` trailing axes, to broadcast against per-z or per-(z, k) tables."""
    return value[(...,) + (None,) * n] if isinstance(value, torch.Tensor) else value


def linspace_rows(start, stop, num):
    """``jnp.linspace(start, stop, num)`` for per-row ``start`` / ``stop``
    (broadcast tensors or floats), in the JAX package's arithmetic:
    start (1 - t) + stop t, t = i / (num - 1), the last point ``stop``.
    Returns (..., num)."""
    t = torch.arange(num, dtype=torch.float64) / max(num - 1, 1)
    start, stop = torch.as_tensor(start, dtype=torch.float64), torch.as_tensor(stop, dtype=torch.float64)
    t = t.to(start.device)
    out = start[..., None] * (1 - t) + stop[..., None] * t
    return torch.cat([out[..., :-1], stop[..., None].expand(out.shape[:-1] + (1,))], dim=-1) if num > 1 else out
