"""Synthetic corpus for the port's smoke and benchmarks."""
