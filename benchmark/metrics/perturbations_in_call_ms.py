"""perturbations_in_call_ms: the Perturbations layer's time (the native
MB95 integration: the tables, the lanes' grids and initial state, the two
RK4 phases replayed from CUDA graphs, the transfers' assembly), inside the
call the user makes: the device ms of the operations under the program's
span cosmoprimo.perturbations plus the device's idle ms while the host was
inside it, per profiled call, inclusive of .setup, .phase_a and .phase_b
(benchmark/layers.py)."""

from .. import layers


def read(record):
    return layers.in_call_ms(record, "cosmoprimo.perturbations")
