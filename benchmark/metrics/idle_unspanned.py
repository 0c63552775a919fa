"""idle_unspanned: The share of the span slice's device idle time whose
gaps lie in no span of the port on the thread that runs the step
(``benchmark/spans.py``)."""


def read(record):
    sp = record.get("spans")
    if not sp or not sp["busy_s"]:
        return None
    if not sp["idle_s"]:
        return 0.0
    return sp["unspanned_idle_s"] / sp["idle_s"] * 100
