"""Synthetic data for the training step (the harness itself is not ported yet)."""
