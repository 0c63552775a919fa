"""One timed loop a kind of traffic (``kind`` in a traffic file): ``run(run)``
returns the record that the metric readers and the verdict read."""
