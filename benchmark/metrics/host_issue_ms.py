"""host_issue_ms: The host's time from the call of the train step to its
return, before any synchronise; the mean over the window's steps."""

import numpy as np


def read(record):
    if record["kind"] != "train":
        return None
    return float(np.mean(record["host_issue_s"])) * 1e3
