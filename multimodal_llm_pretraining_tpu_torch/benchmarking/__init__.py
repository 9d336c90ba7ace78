"""Synthetic data, FLOPs, the benchmark harness, its step timers and the max-micro-batch search."""
