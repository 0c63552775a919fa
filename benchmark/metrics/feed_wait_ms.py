"""feed_wait_ms: The host's time waiting on the feed's queue for the
next batch (the port's span ``feed.wait`` in ``prefetch``), a step of
the span slice (``benchmark/spans.py``)."""

from benchmark.spans import per_unit


def read(record):
    return per_unit(record, "feed.wait", "host_s")
