"""setup_s: seconds from the process's start to the first timed call: the
program's import, the kernel build (or its cache), the entry's set-up, the
pool on the card and the two warm-up calls."""


def read(record):
    return record["setup_s"]
