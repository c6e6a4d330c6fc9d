"""cosmo_per_s: every cosmology completed in the window over the window's
whole time (host clock; each call ends in a synchronize)."""


def read(record):
    return record["calls"] * record["batch"] / record["window_s"]
