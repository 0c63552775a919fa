"""device_idle: The share of the profiled slice (train steps, or rank
batches) in which no kernel, copy or set ran on the device."""


def read(record):
    tr = record.get("trace")
    if not tr:
        return None
    return (1.0 - tr["busy_s"] / tr["window_s"]) * 100
