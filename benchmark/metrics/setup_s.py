"""setup_s: Set-up: from the process start to the first timed step (loading,
building, the graph, the weights, the first steps)."""


def read(record):
    return record["setup_s"]
