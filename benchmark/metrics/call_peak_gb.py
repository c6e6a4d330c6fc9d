"""call_peak_gb: the card memory one call needs, in GB (1e9 bytes):
torch.cuda.max_memory_allocated() over one call of the loop, reset before
it, made after the window and entered with Python's garbage collected.
Beside peak_mem_gb it is the steady part of the window's peak; the
difference is what the program's reference cycles hold until the collector
runs."""


def read(record):
    return record["call_peak_bytes"] / 1e9
