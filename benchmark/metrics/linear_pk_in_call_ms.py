"""linear_pk_in_call_ms: the Linear P(k) layer's time (the EH98 P(k)
evaluations), inside the call the user makes: the device ms of the
operations launched under the program's span cosmoprimo.linear_pk plus the
device's idle ms while the host was inside it, per profiled call, inclusive
of the spans inside it (benchmark/layers.py)."""

from .. import layers


def read(record):
    return layers.in_call_ms(record, "cosmoprimo.linear_pk")
