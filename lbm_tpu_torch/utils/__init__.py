"""Profiling and performance accounting."""
