"""features_ms: The mean of the window's ``features_fn()`` refreshes, each
timed to a synchronise."""

import numpy as np


def read(record):
    if record["kind"] != "rank" or not record["refresh_s"]:
        return None
    return float(np.mean(record["refresh_s"])) * 1e3
