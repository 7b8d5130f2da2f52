"""Utilities: profiling."""
