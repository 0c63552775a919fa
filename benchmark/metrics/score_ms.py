"""score_ms: The device time of the kernels and copies launched in a
ranking batch's scoring (the port's span ``eval.score``:
``score_all_items``), a batch of the span slice (``benchmark/spans.py``)."""

from benchmark.spans import per_unit


def read(record):
    return per_unit(record, "eval.score", "device_s")
