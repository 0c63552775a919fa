"""step_ms: ``train_step_ms`` read per layer, in a cell whose step the
host holds back (its issue as long as the card's work), so that its
window's time over its steps swings with the host's load."""

from benchmark.metrics.train_step_ms import read  # noqa: F401
