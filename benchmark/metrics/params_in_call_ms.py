"""params_in_call_ms: the Parameters layer's time (Cosmology(...):
compile_params and the engine's set-up), inside the call the user makes: the
device ms of the operations launched under the program's span
cosmoprimo.params plus the device's idle ms while the host was inside it,
per profiled call, inclusive of the spans inside it (benchmark/layers.py)."""

from .. import layers


def read(record):
    return layers.in_call_ms(record, "cosmoprimo.params")
