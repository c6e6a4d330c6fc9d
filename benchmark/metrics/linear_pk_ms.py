"""linear_pk_ms: the mean CUDA-event time (ms) of the layer's call 'linear_pk' at the
cell's shapes, as the cell's entry makes it (entries/<config>.py, spans())."""


def read(record):
    return record["spans"].get("linear_pk")
