"""forward_ms: The host's time in a train step's forward and BCE (the
port's span ``train.forward``), a step of the span slice
(``benchmark/spans.py``)."""

from benchmark.spans import per_unit


def read(record):
    return per_unit(record, "train.forward", "host_s")
