"""fftlog_kernel_roofline: the FFTLog kernel's least time over its time in
the call, in %. The least time is counted from the shapes of the kernel's
launches in the profiled calls (the program's counter fftlog.shapes,
roofline.fftlog_bound_ms at the card's published peaks); the time is the
device ms of the operations launched under the program's span
cosmoprimo.fftlog.kernel (benchmark/layers.py)."""

from .. import layers, roofline


def read(record):
    table = layers.table(record)
    peaks = roofline.PEAKS.get(record["device"]["kind"])
    row = table and table["rows"].get("cosmoprimo.fftlog.kernel")
    if not row or not row["device_ms"] or not peaks:
        return None
    shapes = table["counters"]["fftlog.shapes"]
    bound_ms = sum(n * roofline.fftlog_bound_ms(*shape, peaks)[0] for shape, n in shapes.items())
    return 100.0 * bound_ms / table["calls"] / row["device_ms"]
