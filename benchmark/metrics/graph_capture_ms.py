"""graph_capture_ms: the host ms per profiled call that the native solver's
step loops spend in their eager first chunks and CUDA-graph captures (each
call captures its three loops anew): the change of the program's counter
step_loop.capture_s over the profiled calls, per call."""

from .. import layers


def read(record):
    table = layers.table(record)
    change = table and table['counters'].get('step_loop.capture_s')
    if not change:
        return None
    return 1e3 * change / table['calls']
