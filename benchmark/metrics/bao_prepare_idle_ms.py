"""bao_prepare_idle_ms: the device's idle ms per profiled call while the host
is inside the program's span cosmoprimo.bao_filter.prepare (the filter's
host prepare: the fiducial copied to the host, its fit and its peaks),
inclusive of the spans inside it (benchmark/layers.py)."""

from .. import layers


def read(record):
    table = layers.table(record)
    row = table and table["rows"].get("cosmoprimo.bao_filter.prepare")
    return row["idle_ms"] if row else None
