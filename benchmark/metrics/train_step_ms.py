"""train_step_ms: The window's time over the train steps it completed,
ending in a synchronise."""


def read(record):
    if record["kind"] != "train":
        return None
    return record["window_s"] / record["steps"] * 1e3
