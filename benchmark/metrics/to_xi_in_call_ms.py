"""to_xi_in_call_ms: the interpolators' to_xi time (its P(k) evaluation, the
FFTLog and the spline of xi), inside the call the user makes: the device ms
of the operations launched under the program's span cosmoprimo.to_xi plus
the device's idle ms while the host was inside it, per profiled call,
inclusive of the spans inside it (benchmark/layers.py)."""

from .. import layers


def read(record):
    return layers.in_call_ms(record, "cosmoprimo.to_xi")
