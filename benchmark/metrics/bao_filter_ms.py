"""bao_filter_ms: the mean CUDA-event time (ms) of the layer's call 'bao_filter' at the
cell's shapes, as the cell's entry makes it (entries/<config>.py, spans())."""


def read(record):
    return record["spans"].get("bao_filter")
