"""The yardstick of the kernels' rooflines: the card's published peaks and
the least time a transform needs, counted from its shapes.

Peaks (NVIDIA H100 SXM data sheet, dense, at the 700 W limit): 3.35 TB/s of
HBM3, and 67 TFLOP/s in float64 on the tensor cores (34 TFLOP/s without
them; the larger rate is taken, so that no implementation can read above
100%).
"""

import math

PEAKS = {
    'NVIDIA H100 80GB HBM3': {'bytes_per_s': 3.35e12, 'fp64_flop_per_s': 67e12},
}


def fftlog_bound_ms(rows, size, padded, nparallel, peaks):
    """The least time of one FFTLog transform of ``rows`` rows of ``size``
    float64 values, zero-padded to ``padded``, whatever implements it:
    each row read once and written once, with the Mellin coefficients
    (complex) and the pre- and postfactors, over the memory rate; against a
    real FFT pair per row (5 n log2 n), the spectrum product and the pre- and
    postfactors over the float64 rate. Returns (ms, 'bytes' or 'operations')."""
    nbytes = 8 * (2 * rows * size + 2 * nparallel * padded) + 16 * nparallel * (padded // 2 + 1)
    ops = rows * (5 * padded * math.log2(padded) + 6 * (padded // 2 + 1) + 2 * padded)
    bytes_ms = nbytes / peaks['bytes_per_s'] * 1e3
    ops_ms = ops / peaks['fp64_flop_per_s'] * 1e3
    return (bytes_ms, 'bytes') if bytes_ms >= ops_ms else (ops_ms, 'operations')
