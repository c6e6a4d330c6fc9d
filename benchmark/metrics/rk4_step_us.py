"""rk4_step_us: the device microseconds of one RK4 step of the native
perturbations, over every lane of the call: the device ms of the operations
under the program's spans cosmoprimo.perturbations.phase_a and .phase_b
(the two step loops, their eager first chunks and graph replays), over the
steps those loops ran in the profiled calls (the program's counter
step_loop.steps, keys 'phase_a' and 'phase_b')."""

from .. import layers

LOOPS = ('phase_a', 'phase_b')


def read(record):
    table = layers.table(record)
    rows = table and [table['rows'].get(f'cosmoprimo.perturbations.{loop}') for loop in LOOPS]
    steps = table and table['counters'].get('step_loop.steps')
    if not rows or not all(rows) or not steps:
        return None
    n = sum(count for key, count in steps.items() if key[0] in LOOPS)
    if not n:
        return None
    return 1e3 * sum(row['device_ms'] for row in rows) * table['calls'] / n
