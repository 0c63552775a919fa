"""kernel_roofline: The least time the required work of a unit (a train
step, or a rank batch) takes (``benchmark/work``: every op's inputs read
once and outputs written once, at the HBM rate or its operations' peak)
over the device's busy time a unit in the profiled slice."""


def read(record):
    tr = record.get("trace")
    if not tr:
        return None
    busy = tr["busy_s"] / tr["units"]
    return record["work"]["bound_s_per_unit"] / busy * 100
