"""launches_per_call: the kernels the device ran per call in the profiled
calls (copies and fills not counted)."""


def read(record):
    trace = record["trace"]
    if not trace or not trace["launches"]:
        return None
    return trace["launches"] / trace["calls"]
