"""Training and evaluation: the train step with Adam, full-catalog
scoring and ranking metrics, the epoch schedule and checkpoints."""
