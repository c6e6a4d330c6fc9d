"""kernel_build_s: the host seconds the program spent building the FFTLog
kernel (nvcc, or the check of its cached build) and loading it, read from
the program's counter fftlog_kernel.build_s. The build runs once, in
set-up, so the counter read in the traced run holds the set-up's value."""

from .. import layers


def read(record):
    counters = layers.program_counters()
    return None if counters is None else counters["fftlog_kernel.build_s"]
