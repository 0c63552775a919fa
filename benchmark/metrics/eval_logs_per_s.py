"""eval_logs_per_s: Logs ranked in the window over the window's time, refreshes included."""


def read(record):
    if record["kind"] != "rank":
        return None
    return record["logs_ranked"] / record["window_s"]
