"""eval_batch_p95_ms: The 95th percentile of the window's batches, each from its
``metrics_fn`` call to its rows on the host."""

import numpy as np


def read(record):
    if record["kind"] != "rank":
        return None
    return float(np.percentile(np.asarray(record["batch_s"]), 95)) * 1e3
