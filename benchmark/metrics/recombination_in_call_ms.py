"""recombination_in_call_ms: the Thermodynamics layer's time (the native
recombination history: its Saha start, the scan replayed from a CUDA graph,
the reionization and the crossing redshifts), inside the call the user
makes: the device ms of the operations under the program's span
cosmoprimo.thermodynamics plus the device's idle ms while the host was
inside it, per profiled call (benchmark/layers.py). The span closes after
the device has finished the scan, so the graph's kernels, which the trace
links to no launch and places by their start, fall inside it."""

from .. import layers


def read(record):
    return layers.in_call_ms(record, "cosmoprimo.thermodynamics")
