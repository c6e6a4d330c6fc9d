"""Shape policy and NaN-poisoning validation (cosmoprimo_tpu/ops/misc.py)."""

import functools

import numpy as np
import torch


def flatarray(iargs=(0,)):
    """Decorator for methods taking array arguments at positions ``iargs``
    (after ``self``): each is made a float64 tensor on ``self.device`` and
    raveled to 1D for the computation, and the last axis of the output is
    reshaped back to the shape of the first, so scalar in gives the batch
    shape out. Leading output axes (the batch) are kept."""
    def decorator(func):

        @functools.wraps(func)
        def wrapper(self, *args, **kwargs):
            args = list(args)
            shapes = []
            for i in iargs:
                array = torch.as_tensor(args[i], dtype=torch.float64, device=self.device)
                shapes.append(array.shape)
                args[i] = array.reshape(-1)
            toret = func(self, *args, **kwargs)
            return toret.reshape(toret.shape[:-1] + shapes[0])

        return wrapper

    return decorator


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
