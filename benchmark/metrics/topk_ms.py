"""topk_ms: The device time of the kernels launched in a ranking
batch's ``torch.topk`` (the port's span ``eval.topk``), a batch of the
span slice (``benchmark/spans.py``)."""

from benchmark.spans import per_unit


def read(record):
    return per_unit(record, "eval.topk", "device_s")
