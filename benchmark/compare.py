"""The comparison that decides ``correct``: each output of the sampled
answers against the plain reference, one number per output, each with its
limit from the configuration file.

An output with an ``axis`` is a table of spectra: its number is, over the
rows (every index but ``axis``), the largest max|got - ref| / max|ref| along
``axis``. An output without one is a scalar per row or a few values: its
number is the largest |got / ref - 1|. A non-finite answer reads inf.
"""

import numpy as np


def error(got, ref, axis=None):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if got.shape != ref.shape:
        return float('inf')
    if axis is None:
        err = np.abs(got / ref - 1.0)
    else:
        err = np.abs(got - ref).max(axis=axis) / np.abs(ref).max(axis=axis)
    return float(np.max(np.where(np.isfinite(err), err, np.inf)))


def compare(got, ref, outputs):
    """{name: (number, limit)} over the configuration's ``outputs``."""
    return {name: (error(got[name], ref[name], spec.get('axis')), float(spec['limit']))
            for name, spec in outputs.items()}


def correct(checks):
    return all(np.isfinite(value) and value <= limit for value, limit in checks.values())
