"""put_ms: The host's time copying a train step's batch in (the port's
span ``train.put``: pinned copies) or a ranking batch's (``eval.put``:
pageable copies, the second of which waits for the scores), a step or
batch of the span slice (``benchmark/spans.py``)."""

from benchmark.spans import per_unit


def read(record):
    return per_unit(record, "train.put" if record["kind"] == "train"
                    else "eval.put", "host_s")
