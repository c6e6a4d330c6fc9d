"""The one traffic generator: a closed loop of batched calls.

A traffic file (``traffic/<name>.json``) gives the batch (cosmologies per
call), the number of distinct batches in the pool that the loop cycles
through, and the sample of calls and rows whose answers are checked. The
configuration gives the parameter box. Everything is drawn from the seed:
the same seed gives the same pool and the same sample plan.
"""

import numpy as np


def draw_pool(box, batch, pool, seed):
    """``pool`` batches of ``batch`` cosmologies, each parameter uniform in
    its ``box`` [low, high] (in the box's order): a list of dicts of (batch,)
    float64 arrays."""
    rng = np.random.default_rng([int(seed), 0])
    return [{name: rng.uniform(low, high, batch) for name, (low, high) in box.items()} for _ in range(pool)]


class SamplePlan:
    """Which calls of the window keep some of their answers for the check,
    and which rows: a reservoir of ``calls`` calls over the whole window
    (each call of the window equally likely to be kept), ``rows`` distinct
    rows of each, drawn from the seed."""

    def __init__(self, seed, calls, rows, batch):
        self.rng = np.random.default_rng([int(seed), 1])
        self.calls, self.rows, self.batch = int(calls), min(int(rows), batch), batch
        self.kept = {}        # slot -> (call index, pool index, rows, answers)

    def slot(self, call):
        """The reservoir slot that call ``call`` (0, 1, ...) fills, or None."""
        if call < self.calls:
            return call
        j = int(self.rng.integers(0, call + 1))
        return j if j < self.calls else None

    def draw_rows(self):
        return np.sort(self.rng.choice(self.batch, self.rows, replace=False))

    def keep(self, slot, call, pool_index, rows, answers):
        self.kept[slot] = (call, pool_index, rows, answers)

    def samples(self):
        return [self.kept[slot] for slot in sorted(self.kept)]
