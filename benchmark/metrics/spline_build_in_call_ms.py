"""spline_build_in_call_ms: the splines' build time (natural_cubic_coeffs and
natural_cubic_coeffs_rows, wherever they run), inside the call the user
makes: the device ms of the operations launched under the program's span
cosmoprimo.spline_build plus the device's idle ms while the host was inside
it, per profiled call, inclusive of the spans inside it
(benchmark/layers.py)."""

from .. import layers


def read(record):
    return layers.in_call_ms(record, "cosmoprimo.spline_build")
