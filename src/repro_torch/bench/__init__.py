"""Benchmarks of the port: the single-device Graph500 harness."""
