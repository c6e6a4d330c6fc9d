"""bao_filter_in_call_ms: the BAO filters layer's time (the filter's
construction: its P(k) evaluation, host prepare and compute), inside the
call the user makes: the device ms of the operations launched under the
program's span cosmoprimo.bao_filter plus the device's idle ms while the
host was inside it, per profiled call, inclusive of the spans inside it
(benchmark/layers.py)."""

from .. import layers


def read(record):
    return layers.in_call_ms(record, "cosmoprimo.bao_filter")
