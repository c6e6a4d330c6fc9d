"""fftlog_roofline: the least time of the cell's FFTLog transform over its
measured time, in %. The least time is counted from the transform's shapes
(roofline.fftlog_bound_ms), whatever implements it, at the card's published
peaks; the measured time is the mean CUDA-event time of the transform call
(PowerToCorrelation at the cell's rows), host-side wrapper included."""

from .. import roofline


def read(record):
    shape, ms = record["counters"].get("fftlog"), record["spans"].get("fftlog")
    peaks = roofline.PEAKS.get(record["device"]["kind"])
    if not shape or not ms or not peaks:
        return None
    bound_ms, _ = roofline.fftlog_bound_ms(shape["rows"], shape["size"], shape["padded"], shape["nparallel"], peaks)
    return 100.0 * bound_ms / ms
