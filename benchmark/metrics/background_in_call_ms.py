"""background_in_call_ms: the Background layer's time (its tables' builds:
ncdm, chi, growth; chi and the growth factor at the call's z), inside the
call the user makes: the device ms of the operations launched under the
program's span cosmoprimo.background plus the device's idle ms while the
host was inside it, per profiled call, inclusive of the spans inside it
(benchmark/layers.py)."""

from .. import layers


def read(record):
    return layers.in_call_ms(record, "cosmoprimo.background")
