"""The model stack: every architecture as plain functions over param trees
(the port of the JAX package's ``models``)."""
from repro_torch.models.registry import Model, build_model  # noqa: F401
