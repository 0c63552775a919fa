"""peak_mem_gib: ``torch.cuda.max_memory_allocated()`` over the window, after a reset
at its start."""


def read(record):
    if not record["window_peak_bytes"]:
        return None
    return record["window_peak_bytes"] / 2 ** 30
