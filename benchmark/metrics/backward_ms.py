"""backward_ms: The host's time in a train step's ``loss.backward()``
(the port's span ``train.backward``; autograd's device thread launches
the kernels meanwhile), a step of the span slice (``benchmark/spans.py``)."""

from benchmark.spans import per_unit


def read(record):
    return per_unit(record, "train.backward", "host_s")
