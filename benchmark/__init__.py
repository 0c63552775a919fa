"""The benchmark of ``ihgnn_torch`` on one H100: ``python3 -m
benchmark.run`` runs one cell of ``BENCHMARK.json``."""
