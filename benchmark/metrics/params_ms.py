"""params_ms: the mean CUDA-event time (ms) of the layer's call 'params' at the
cell's shapes, as the cell's entry makes it (entries/<config>.py, spans())."""


def read(record):
    return record["spans"].get("params")
