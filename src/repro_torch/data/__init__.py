"""Synthetic, checkpointable training data: the port of ``repro.data``."""
