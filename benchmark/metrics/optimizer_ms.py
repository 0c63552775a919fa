"""optimizer_ms: The host's time in a train step's ``zero_grad`` and Adam
step (the port's span ``train.optimizer``), a step of the span slice
(``benchmark/spans.py``)."""

from benchmark.spans import per_unit


def read(record):
    return per_unit(record, "train.optimizer", "host_s")
