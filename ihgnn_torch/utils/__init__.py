"""Run logging and debug statistics."""
