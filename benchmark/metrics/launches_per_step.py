"""launches_per_step: The kernel launches that
``ihgnn_torch/ops/launches.py`` counts over the window's train steps, a
step."""


def read(record):
    if record["kind"] != "train":
        return None
    return sum(record["launches"].values()) / record["steps"]
