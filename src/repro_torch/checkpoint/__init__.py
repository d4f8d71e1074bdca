"""Checkpoints: the port of ``repro.checkpoint`` (the JAX package's
``manager`` module, on the same files)."""
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
