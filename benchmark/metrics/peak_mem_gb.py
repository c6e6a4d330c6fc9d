"""peak_mem_gb: the card's peak allocated memory over the whole window, in
GB (1e9 bytes): torch.cuda.max_memory_allocated(), reset at the window's
start. It holds the program's state, the pool, each call's tensors and what
reference cycles keep on the card until Python's collector frees them: the
memory a user's loop needs at the cell's batch."""


def read(record):
    return record["window_peak_bytes"] / 1e9
