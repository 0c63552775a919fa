"""Search logs, training batches and evaluation batches (NumPy only)."""
