"""to_xi_ms: the mean CUDA-event time (ms) of the layer's call 'to_xi' at the
cell's shapes, as the cell's entry makes it (entries/<config>.py, spans())."""


def read(record):
    return record["spans"].get("to_xi")
