"""The port's pipelines (the JAX package's ``models``)."""

from .config import (PipelineConfig, from_jax_config, similarity_to_numpy,
                     stars_to_numpy)
from .pipeline import calibrate_register_stack_lean

__all__ = [
    "PipelineConfig",
    "calibrate_register_stack_lean",
    "from_jax_config",
    "similarity_to_numpy",
    "stars_to_numpy",
]
