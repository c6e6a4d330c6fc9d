"""device_idle_pct: the share of the profiled calls' wall during which no
operation runs on the device (torch.profiler over whole calls)."""


def read(record):
    trace = record["trace"]
    if not trace or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
